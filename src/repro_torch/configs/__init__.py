"""Architecture registry of the port.

Every configuration the JAX package registers, field for field: the
paper's OPT family, the ten assigned architectures (``ASSIGNED_ARCHS``) —
Llama-4 Maverick and Scout (top-1 MoE with a shared expert),
Nemotron-4-340B (GQA at head dim 192, squared ReLU, LayerNorm), Gemma-2-2B
(local/global layers, softcaps, sandwich norms), Mistral-NeMo-12B (the
Llama-style GQA decoder), MiniCPM3-4B (MLA), LLaVA-NeXT-Mistral-7B (a
Mistral backbone fed patch embeddings), Whisper-small (encoder-decoder
over frame embeddings), Zamba2-1.2B (a Mamba2 trunk with one shared
attention block) and Mamba2-2.7B (the attention-free SSD family) — and
the ``tiny`` / ``tiny-moe`` test models.  ``get_config(name)`` returns the
full-size config; ``reduced(cfg)`` returns a smoke-test-scale config of
the same family/pattern (small widths, tiny vocab) used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "llama4-maverick-400b-a17b",
    "llama4-scout-17b-16e",
    "nemotron-4-340b",
    "gemma2-2b",
    "mistral-nemo-12b",
    "minicpm3-4b",
    "llava-next-mistral-7b",
    "whisper-small",
    "zamba2-1.2b",
    "mamba2-2.7b",
)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        gemma2_2b, llama4_maverick_400b_a17b, llama4_scout_17b_16e,
        llava_next_mistral_7b, mamba2_2_7b, minicpm3_4b, mistral_nemo_12b,
        nemotron_4_340b, opt, tiny, whisper_small, zamba2_1_2b)


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """Smoke-test-scale variant preserving family / pattern / mechanisms."""
    period = 1
    if cfg.layer_pattern:
        period = len(cfg.layer_pattern)
    elif cfg.n_experts and cfg.moe_layer_period > 1:
        period = cfg.moe_layer_period
    if cfg.shared_attn_period:
        shared_period = 2
        n_layers = layers or 5                             # 2 groups + tail
    else:
        shared_period = 0
        n_layers = layers or max(2, 2 * period)

    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    if kv and heads % kv:
        kv = heads
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        max_seq=512,
        dtype="float32",
        remat=False,
        moe_group_size=64,
    )
    if cfg.n_experts:
        changes["n_experts"] = min(cfg.n_experts, 4)
        # no-drop capacity so prefill and decode agree exactly; a test of
        # capacity drops sets its own factor and group size
        changes["capacity_factor"] = float(changes["n_experts"])
    if cfg.attn_kind == "mla":
        changes.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16, head_dim=None)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.shared_attn_period:
        changes.update(shared_attn_period=shared_period,
                       shared_lora_rank=8)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq=24)
    if cfg.window:
        changes["window"] = 32
    return dataclasses.replace(cfg, **changes)
