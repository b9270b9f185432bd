"""Model configuration — one dataclass expressive enough for all assigned
architectures (dense GQA/MLA transformers, MoE, SSM, hybrid, enc-dec, VLM
backbone) plus the paper's OPT family.

Every field maps to a documented mechanism in :mod:`repro_torch.models.layers`.
Architecture files in :mod:`repro_torch.configs` instantiate this dataclass with
the exact published numbers and register themselves in the global registry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm

    # --- trunk dimensions ---
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 512

    # --- attention ---
    attn_kind: str = "gqa"          # gqa | mla | none
    pos_emb: str = "rope"           # rope | learned | none
    rope_theta: float = 10_000.0
    max_seq: int = 131_072
    window: Optional[int] = None    # sliding-window size for local layers
    layer_pattern: Optional[str] = None  # e.g. "LG": local/global alternating
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qk_norm: bool = False

    # --- MLP ---
    mlp_kind: str = "gated_silu"    # gated_silu | relu2 | gelu | relu

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    shared_expert: bool = False
    moe_layer_period: int = 1       # every k-th layer is MoE (1 = all)
    capacity_factor: float = 1.25
    moe_group_size: int = 512       # GShard-style dispatch group

    # --- MLA (DeepSeek/MiniCPM3-style latent attention) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # --- hybrid (zamba2: shared attention block over a mamba trunk) ---
    shared_attn_period: int = 0     # apply the shared block every k layers
    shared_lora_rank: int = 0       # per-invocation LoRA on the shared block

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0            # stub frontend frames (whisper: 1500)

    # --- VLM backbone ---
    embeds_input: bool = False      # input_specs provides patch embeddings

    # --- norms / embeddings ---
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    post_norm: bool = False         # gemma2 sandwich norms
    emb_scale: bool = False         # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    attn_bias: bool = False         # OPT/whisper use biases

    # --- distribution ---
    fsdp: bool = False              # 2D weight sharding: big matrices also
                                    # shard their input dim over "data"
                                    # (required >=100B: 16-way TP alone
                                    # leaves tens of GB per chip)
    # --- numerics ---
    dtype: str = "bfloat16"         # parameter/activation dtype
    kv_dtype: Optional[str] = None  # "int8": quantized KV cache (per
                                    # token-head symmetric scales) — halves
                                    # decode's dominant HBM term; beyond-
                                    # paper opt per HeteGen §7 (quantization)
    # --- training-side defaults (launcher may override) ---
    optimizer: str = "adamw"        # adamw | adafactor
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid trunks)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string, e.g. ('local','global',...) for gemma2
        or ('moe','dense',...) for maverick."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm" or self.family == "hybrid":
                kinds.append("mamba")
            elif self.n_experts > 0:
                kinds.append("moe" if (i % self.moe_layer_period
                                       == self.moe_layer_period - 1) else "dense")
            elif self.layer_pattern:
                p = self.layer_pattern[i % len(self.layer_pattern)]
                kinds.append({"L": "local", "G": "global"}[p])
            else:
                kinds.append("dense")
        return tuple(kinds)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (exact for our parameterization)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        total = V * d                                   # embedding
        if not self.tie_embeddings:
            total += V * d
        if self.pos_emb == "learned":
            total += self.max_seq * d
        total += d                                       # final norm scale
        if self.norm_kind == "layernorm":
            total += d

        def attn_params() -> int:
            if self.attn_kind == "mla":
                p = d * self.q_lora_rank + self.q_lora_rank                 # q down + norm
                p += self.q_lora_rank * Hq * (self.qk_nope_dim + self.qk_rope_dim)
                p += d * (self.kv_lora_rank + self.qk_rope_dim) + self.kv_lora_rank
                p += self.kv_lora_rank * Hq * (self.qk_nope_dim + self.v_head_dim)
                p += Hq * self.v_head_dim * d
                return p
            p = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
            if self.attn_bias:
                p += Hq * hd + 2 * Hkv * hd + d
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params(ff: int) -> int:
            if self.mlp_kind.startswith("gated"):
                return 3 * d * ff
            return 2 * d * ff + (ff + d if self.attn_bias else 0)

        def mamba_params() -> int:
            din = self.d_inner
            H = self.ssm_heads
            G, N = self.ssm_groups, self.ssm_state
            proj_in = d * (2 * din + 2 * G * N + H)
            conv = (din + 2 * G * N) * self.ssm_conv + (din + 2 * G * N)
            extra = 3 * H + din                          # A_log, D, dt_bias, gated-norm
            proj_out = din * d
            return proj_in + conv + extra + proj_out

        norms_per_block = (4 if self.post_norm else 2) * d
        if self.norm_kind == "layernorm":
            norms_per_block *= 2

        for kind in self.layer_kinds():
            if kind == "mamba":
                total += mamba_params() + d              # pre-norm
            elif kind == "moe":
                total += attn_params() + norms_per_block
                total += d * self.n_experts              # router
                total += self.n_experts * mlp_params(f) // 1
                if self.shared_expert:
                    total += mlp_params(f)
            else:
                total += attn_params() + norms_per_block + mlp_params(f)

        if self.shared_attn_period:
            # one shared transformer block on concat([h, emb]) (2d wide)
            d2 = 2 * d
            total += d2 * Hq * hd + 2 * d2 * Hkv * hd + Hq * hd * d2
            total += (3 if self.mlp_kind.startswith("gated") else 2) \
                * d2 * self.d_ff
            total += 2 * d2 + d2 * d                     # norms + out proj
            n_calls = len(self.shared_attn_sites())
            r = self.shared_lora_rank
            if r:
                total += n_calls * (d2 * r + r * Hq * hd)  # per-site LoRA on q
        if self.encoder_layers:
            # encoder blocks + per-decoder-layer cross attention
            enc = self.encoder_layers * (attn_params() + mlp_params(f)
                                         + norms_per_block)
            cross = self.n_layers * (attn_params() + d)
            total += enc + cross + self.encoder_seq * d  # enc learned pos
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts + shared)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_kind.startswith("gated") else 2) * d * f
        n_moe = sum(1 for k in self.layer_kinds() if k == "moe")
        inactive = n_moe * (self.n_experts - self.top_k) * per_expert
        return self.param_count() - inactive

    def shared_attn_sites(self) -> Tuple[int, ...]:
        if not self.shared_attn_period:
            return ()
        return tuple(range(0, self.n_layers, self.shared_attn_period))

    def dtype_bytes(self) -> int:
        return {"float32": 4, "bfloat16": 2, "float16": 2}[self.dtype]


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """KV-cache footprint for decode at (batch, seq)."""
    by = cfg.dtype_bytes()
    if cfg.family == "ssm":
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        conv = (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * cfg.ssm_conv
        return cfg.n_layers * batch * (state + conv) * by
    if cfg.attn_kind == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        return cfg.n_layers * batch * seq * per_tok * by
    if cfg.kv_dtype == "int8":
        by = 1
    per_tok = 2 * cfg.n_kv_heads * cfg.hd
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        conv = (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * cfg.ssm_conv
        mamba = cfg.n_layers * batch * (state + conv) * by
        shared = len(cfg.shared_attn_sites()) * batch * seq * per_tok * by
        return mamba + shared
    win = cfg.window
    if cfg.layer_pattern and win:
        kinds = cfg.layer_kinds()
        n_local = sum(1 for k in kinds if k == "local")
        n_global = len(kinds) - n_local
        return batch * per_tok * by * (n_local * min(win, seq) + n_global * seq)
    return n_attn * batch * seq * per_tok * by
