"""Model assembly for the decoder families, Mamba2 and the Zamba2 hybrid.

The PyTorch counterpart of the JAX package's ``models/model.py`` for the
decoder-only transformer families (dense GQA, Gemma-2's local/global
pattern, MLA, top-1 MoE), the attention-free SSM family (Mamba2) and the
hybrid (a Mamba2 trunk with one shared attention block): parameter init,
the embedding / head, and two executions of the layer math —

* the resident whole model (:func:`prefill` / :func:`decode_step` over the
  stacked caches of :func:`init_cache`: (n_super, B, Hkv, T, hd) K/V, fp
  or int8, or MLA's (n_super, B, T, R) latents and rope keys), which the
  one-shot :class:`repro_torch.serving.engine.Generator` and
  :class:`repro_torch.serving.backends.ScanResidentBackend` run;
* the backend path (:func:`backend_prefill` / :func:`backend_decode` over
  the per-layer KV cache, dense or paged), with every weight matmul
  routed through an injected ``linear(x, name)`` callable — the seam that
  lets :mod:`repro_torch.serving.backends` run it resident or
  HeteGen-offloaded.  It takes dense GQA decoders only, as in the JAX
  package (:func:`extract_backend_params`).

The SSM and hybrid families run only the resident whole model: the Mamba2
blocks of :mod:`repro_torch.models.ssm` in a loop over the
(n_groups, period, B, ...) state cache (:func:`_mamba_trunk`), the hybrid's
shared block at the start of each group and before the tail layers.
Encoder-decoder and VLM families are not ported.

:func:`forward_train` is the training forward over a (B, S) batch with no
cache: the same trunks on the JAX package's plain forms (``plain=True``
in :mod:`repro_torch.models.layers` and :mod:`repro_torch.models.ssm`),
so autograd sees every operation — the kernels have no backward — and
``cfg.remat`` recomputes each super-block (or Mamba group) in the
backward through ``torch.utils.checkpoint``.

Dense-cache attention picks its route once per forward
(:func:`attention_route`): decode runs the flash-decode kernel, a prefill
from position 0 the flash-attention kernel, and anything else the plain
:func:`repro_torch.models.layers.attention` (counted on the card as
``plain_dense_attention``).  Paged caches always run the paged kernels.
MLA attends in plain PyTorch on every route
(:func:`repro_torch.models.layers.mla_attend`).

Parameters are plain nested dicts with the JAX package's layout
(per-super-block leaves stacked on a leading axis), so
:func:`params_from_numpy` converts a JAX param tree leaf by leaf.

Caches are updated **in place**: the dense buffers, the stacked caches and
the page pools are device tensors that the layer writes into
(``index_copy_`` / ``index_put_``), where the JAX package rebuilds them
functionally.  The returned cache dict holds the same tensors.  No cache
write or route decision of a decode step reads a device value on the
host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm") or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            "the port supports dense GQA decoders "
            f"(got family={cfg.family}, attn={cfg.attn_kind})")


def _check_whole_model(cfg: ModelConfig) -> None:
    """The families the resident whole model runs: decoder-only
    transformers (GQA or MLA attention, dense or MoE), SSM and hybrid."""
    if cfg.family in ("ssm", "hybrid"):
        return
    if cfg.family not in ("dense", "moe") \
            or cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            "the port's whole model runs decoder-only transformers, SSM "
            f"and hybrid models (got family={cfg.family}, "
            f"attn={cfg.attn_kind})")


def _ssm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, period) of the SSM trunk's stacked layers; the SSM family
    has one group of every layer, the hybrid one group per shared-block
    site (the layers past the last whole group are the "tail")."""
    period = cfg.shared_attn_period or cfg.n_layers
    return cfg.n_layers // period, period


def _ssm_tail(cfg: ModelConfig) -> int:
    n_groups, period = _ssm_groups(cfg)
    return cfg.n_layers - n_groups * period


def _pattern_period(cfg: ModelConfig) -> int:
    if cfg.layer_pattern:
        return len(cfg.layer_pattern)
    if cfg.n_experts and cfg.moe_layer_period > 1:
        return cfg.moe_layer_period
    return 1


def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int] = 0, *,
                device=None) -> Dict:
    """Random params for any family the whole model runs, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``, or an int seed).
    Same tree layout as the JAX package's ``init_params``; the numbers
    differ (the two frameworks' generators do)."""
    _check_whole_model(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    dt = torch_dtype(cfg)

    def dense(shape, scale=None, dtype=dt):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w.mul_(std)).to(dtype)

    def norm(d):
        p = {"scale": torch.ones((d,), dtype=dt, device=dev)}
        if cfg.norm_kind == "layernorm":
            p["bias"] = torch.zeros((d,), dtype=dt, device=dev)
        if cfg.post_norm:
            p["scale"] = torch.zeros((d,), dtype=dt, device=dev)
        return p

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    d, f = cfg.d_model, cfg.d_ff
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def gqa(d_in=d, d_out=d):
        attn = {"wq": dense((d_in, hq * hd)), "wk": dense((d_in, hkv * hd)),
                "wv": dense((d_in, hkv * hd)), "wo": dense((hq * hd, d_out))}
        if cfg.attn_bias:
            attn.update(bq=zeros(hq * hd), bk=zeros(hkv * hd),
                        bv=zeros(hkv * hd), bo=zeros(d_out))
        if cfg.qk_norm:
            attn.update(q_norm=ones(hd), k_norm=ones(hd))
        return attn

    def mla():
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {"wq_a": dense((d, r_q)), "q_a_norm": ones(r_q),
                "wq_b": dense((r_q, hq * (dn + dr))),
                "wkv_a": dense((d, r_kv + dr)), "kv_a_norm": ones(r_kv),
                "wk_b": dense((r_kv, hq * dn)), "wv_b": dense((r_kv, hq * dv)),
                "wo": dense((hq * dv, d))}

    def mlp(d_in=d, d_out=d):
        if cfg.mlp_kind.startswith("gated"):
            return {"w_gate": dense((d_in, f)), "w_up": dense((d_in, f)),
                    "w_down": dense((f, d_out))}
        p = {"w_in": dense((d_in, f)), "w_down": dense((f, d_out))}
        if cfg.attn_bias:
            p.update(b_in=zeros(f), b_down=zeros(d_out))
        return p

    def moe():
        e = cfg.n_experts
        p = {"router": dense((d, e), dtype=torch.float32)}
        if cfg.mlp_kind.startswith("gated"):
            p.update(we_gate=dense((e, d, f)), we_up=dense((e, d, f)),
                     we_down=dense((e, f, d)))
        else:
            p.update(we_in=dense((e, d, f)), we_down=dense((e, f, d)))
        if cfg.shared_expert:
            p.update(ws_gate=dense((d, f)), ws_up=dense((d, f)),
                     ws_down=dense((f, d)))
        return p

    def block(kind):
        p = {"ln1": norm(d), "ln2": norm(d),
             "attn": mla() if cfg.attn_kind == "mla" else gqa()}
        if kind == "moe":
            p["moe"] = moe()
        else:
            p["mlp"] = mlp()
        if cfg.post_norm:
            p["ln1_post"] = norm(d)
            p["ln2_post"] = norm(d)
        return p

    def mamba():
        din, h = cfg.d_inner, cfg.ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        f32 = dict(dtype=torch.float32, device=dev)
        return {"w_z": dense((d, din)), "w_x": dense((d, din)),
                "w_bc": dense((d, 2 * gn)), "w_dt": dense((d, h)),
                "conv_x_w": dense((cfg.ssm_conv, din), scale=0.2),
                "conv_x_b": zeros(din),
                "conv_bc_w": dense((cfg.ssm_conv, 2 * gn), scale=0.2),
                "conv_bc_b": zeros(2 * gn),
                "A_log": torch.zeros((h,), **f32),          # A = -1
                "D": torch.ones((h,), **f32),
                "dt_bias": torch.full((h,), -1.0, **f32),
                "gnorm": ones(din), "out_proj": dense((din, d)),
                "ln": norm(d)}

    params: Dict = {"embed": dense((cfg.vocab_size, d), scale=1.0),
                    "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    if cfg.pos_emb == "learned":
        params["pos"] = dense((cfg.max_seq, d), scale=0.02)
    if cfg.family in ("ssm", "hybrid"):
        n_groups, period = _ssm_groups(cfg)
        params["blocks"] = _stack([_stack([mamba() for _ in range(period)])
                                   for _ in range(n_groups)])
        if _ssm_tail(cfg):
            params["tail"] = _stack([mamba() for _ in range(_ssm_tail(cfg))])
        if cfg.family == "hybrid":
            # one shared transformer block over concat([x, emb0]) (2 d
            # wide), projected back to d, with a per-site LoRA on q
            d2 = 2 * d
            params["shared"] = {"ln1": norm(d2), "ln2": norm(d2),
                                "attn": gqa(d2, d2), "mlp": mlp(d2, d2),
                                "proj": dense((d2, d))}
            n_sites, r = len(cfg.shared_attn_sites()), cfg.shared_lora_rank
            if r:
                params["shared_lora"] = {
                    "a": dense((n_sites, d2, r), scale=0.02),
                    "b": zeros(n_sites, r, hq * hd)}
        return params
    period = _pattern_period(cfg)
    kinds = cfg.layer_kinds()
    supers = [{f"pos{j}": block(kinds[g * period + j])
               for j in range(period)}
              for g in range(cfg.n_layers // period)]
    params["blocks"] = _stack(supers)
    return params


def _pick(tree, idx):
    """Index every leaf of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _pick(v, idx) for k, v in tree.items()}
    return tree[idx]


def _stack(trees):
    """Stack a list of like trees leaf by leaf, dropping each per-layer
    leaf as soon as its stack exists, so the peak holds one leaf's copies
    beyond the model, not a second model."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    out = torch.stack(trees, dim=0)
    trees.clear()
    return out


def params_from_numpy(tree, device=None):
    """A param tree of numpy arrays (e.g. the JAX package's params through
    ``np.asarray``, bfloat16 leaves included) -> the same tree of tensors
    on ``device``.  Every family's tree crosses leaf by leaf: MLA's
    low-rank projections, MoE's fp32 router and (E, d, f) expert stacks,
    the hybrid's ``tail`` layers, ``shared`` block and ``shared_lora``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 extension type has no torch counterpart; the
        # round trip through float32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(arr).to(dev)


def train_state_from_numpy(state, device=None):
    """A train state of numpy arrays — ``{"params", "opt", "step"}`` from
    the JAX package through ``np.asarray``, the optimizer's moments and
    count and the step included — as the port's tensors on ``device``,
    leaf by leaf (:func:`params_from_numpy`): bf16 stays bf16, int32 int32."""
    return params_from_numpy(state, device)


def tree_to(tree, device):
    """Move every tensor of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.emb_scale:
        # sqrt(d) in the model dtype, as the JAX package rounds it
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T             # OPT ties the head to embed
    logits = x @ head
    return L.softcap(logits.float(), cfg.logit_softcap)


def _add_learned_pos(cfg, params, x, positions):
    if cfg.pos_emb == "learned":
        x = x + params["pos"][positions.long()]
    return x


# ---------------------------------------------------------------------------
# Cache writes
# ---------------------------------------------------------------------------

def _scatter_pos(cur_len: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B, s) write positions for a per-slot length vector."""
    return cur_len.long()[:, None] \
        + torch.arange(s, device=cur_len.device)[None]


def _start_positions(cur_len: torch.Tensor, s: int, t: int) -> torch.Tensor:
    """(s,) device positions of a write starting at scalar ``cur_len``,
    the start clamped into [0, t - s] like ``lax.dynamic_update_slice``
    (no host sync)."""
    start = cur_len.long().clamp(0, max(t - s, 0))
    return start + torch.arange(s, device=cur_len.device)


def _update_kv(buf: torch.Tensor, new: torch.Tensor,
               cur_len: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Write ``new`` (B, s, H, ...) into ``buf`` at ``cur_len`` along its
    position axis ``dim`` (1: (B, T, H, ...); 2: (B, H, T, ...)), in
    place.  ``cur_len`` is a scalar (clamped like
    ``lax.dynamic_update_slice``) or a (B,) per-slot vector (positions past
    the buffer are dropped)."""
    b, s = new.shape[:2]
    t = buf.shape[dim]
    new = new.to(buf.dtype)
    if cur_len.dim() == 0:
        src = new if dim == 1 else new.transpose(1, 2)
        buf.index_copy_(dim, _start_positions(cur_len, s, t), src)
        return buf
    pos = _scatter_pos(cur_len, b, s)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)

    def put(r, p, val):
        if dim == 1:
            buf[r, p] = val
        else:
            buf[r, :, p] = val

    if s == 1:
        # one position per row: a dropped write rewrites the row's last
        # value instead of going through a boolean mask (a host sync)
        keep = (pos < t).reshape((b, 1) + (1,) * (new.dim() - 2))
        pc = pos.clamp(max=t - 1)
        old = buf[rows, pc] if dim == 1 else buf[rows, :, pc]
        put(rows, pc, torch.where(keep, new, old))
        return buf
    keep = pos < t
    put(rows[keep], pos[keep], new[keep])
    return buf


def _quantize_kv(new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,s,H,D) -> (int8 values, per-(token, head) scales (B,s,H))."""
    nf = new.float()
    m = nf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(nf / m[..., None]), -127, 127
                    ).to(torch.int8)
    return q, m


def _paged_positions(block_tables: torch.Tensor, new: torch.Tensor,
                     cur_len: torch.Tensor, page_size: int):
    """(page, offset) scatter coordinates, each (B, s), for writing ``new``
    (B, s, ...) through ``block_tables`` (B, nb) at ``cur_len`` (scalar or
    (B,)).  Per-slot positions past the table's last block go to the
    trash page instead of clamping into a real one."""
    b, s = new.shape[:2]
    nb = block_tables.shape[1]
    bt = block_tables.long()
    if cur_len.dim() == 0:
        pos = cur_len.long() + torch.arange(s, device=bt.device)      # (s,)
        page = bt[:, (pos // page_size).clamp(max=nb - 1)]            # (B, s)
        off = (pos % page_size)[None].expand(b, s)
    else:
        pos = _scatter_pos(cur_len, b, s)                             # (B, s)
        blk = pos // page_size
        page = torch.gather(bt, 1, blk.clamp(max=nb - 1))
        page = torch.where(blk < nb, page, 0)                         # trash
        off = pos % page_size
    return page, off


def _paged_write(pages, new, block_tables, cur_len):
    """Scatter ``new`` (B, s, H, D) into a (P, H, page_size, D) pool in
    place (an ``index_put_``)."""
    page, off = _paged_positions(block_tables, new, cur_len, pages.shape[2])
    pages[page, :, off] = new.to(pages.dtype)
    return pages


def _paged_write_q8(pages, scale_pages, new, block_tables, cur_len):
    """Quantize ``new`` (B, s, H, D) and scatter into int8 pages plus
    per-(page, head, token) scale pages (P, H, page_size), in place."""
    q, m = _quantize_kv(new)
    page, off = _paged_positions(block_tables, new, cur_len, pages.shape[2])
    pages[page, :, off] = q
    scale_pages[page, :, off] = m.to(scale_pages.dtype)
    return pages, scale_pages


def _paged_attend(cfg, q, k_pages, v_pages, block_tables, q_positions,
                  kv_len, window, k_scale=None, v_scale=None):
    """Attention over a paged cache.  Decode (s == 1, no window) runs the
    paged flash-decode kernel; everything else — prefill chunks starting
    at any offset, and windowed layers — runs the paged flash-prefill
    kernel.  Both read K/V through the block table; the cache is never
    gathered into a dense buffer on the card."""
    b, s = q.shape[:2]
    lens = torch.as_tensor(kv_len, device=q.device).to(torch.int32) \
        .expand(b).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    if s == 1 and window is None:
        out = K.paged_decode_attention(q[:, 0].contiguous(), k_pages,
                                       v_pages, bt, lens,
                                       k_scale=k_scale, v_scale=v_scale,
                                       softcap=cfg.attn_softcap)
        return out[:, None]
    offs = q_positions[:, 0].to(torch.int32).contiguous()
    out = K.paged_prefill_attention(q.transpose(1, 2).contiguous(), k_pages,
                                    v_pages, bt, offs,
                                    k_scale=k_scale, v_scale=v_scale,
                                    softcap=cfg.attn_softcap, window=window)
    return out.transpose(1, 2)


def _positions_from(cur_len: torch.Tensor, b: int, s: int) -> torch.Tensor:
    base = torch.arange(s, device=cur_len.device, dtype=torch.int32)[None, :]
    cl = cur_len.to(torch.int32)
    if cl.dim() == 1:
        return cl[:, None] + base
    return (cl + base).expand(b, s)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _apply_attn_layer(cfg, p, x, positions, *, kind: str, kv_cache,
                      cur_len, linear=None, norm_fn=None, attend_fn=None,
                      block_tables=None, paged_attend_fn=None,
                      route: str):
    """Pre-norm attention + residual over a per-layer cache.  Returns
    (x, new_kv_cache).

    ``kv_cache`` is (k, v) dense buffers (B, T, Hkv, hd) written at
    ``cur_len`` and attended along ``route`` (:func:`attention_route`);
    with ``block_tables`` (B, nb) it holds page pools instead —
    (k_pages, v_pages) in (P, Hkv, ps, hd) layout, or
    (k, v, k_scale, v_scale) for int8 pages."""
    window = cfg.window if kind == "local" else None
    norm = norm_fn or (lambda pp, h: L.apply_norm(cfg, pp, h))
    h = norm(p["ln1"], x)
    q, k, v = L.gqa_qkv(cfg, p["attn"], h, positions, linear=linear)
    if block_tables is not None:
        if len(kv_cache) == 4:          # q8 pools: int8 pages + scales
            k_pg, v_pg, ks_pg, vs_pg = kv_cache
            _paged_write_q8(k_pg, ks_pg, k, block_tables, cur_len)
            _paged_write_q8(v_pg, vs_pg, v, block_tables, cur_len)
            scales = (ks_pg, vs_pg)
        else:
            k_pg, v_pg = kv_cache
            _paged_write(k_pg, k, block_tables, cur_len)
            _paged_write(v_pg, v, block_tables, cur_len)
            scales = (None, None)
        new_cache = kv_cache
        pa = paged_attend_fn or (lambda *a: _paged_attend(cfg, *a))
        out = pa(q, k_pg, v_pg, block_tables, positions,
                 cur_len + k.shape[1], window, *scales)
    else:
        k_buf, v_buf = kv_cache
        _update_kv(k_buf, k, cur_len)
        _update_kv(v_buf, v, cur_len)
        attend = attend_fn or (lambda *a: _dense_attend(cfg, *a))
        out = attend(q, k_buf, v_buf, positions, cur_len + k.shape[1],
                     window, route)
        new_cache = (k_buf, v_buf)
    out = L.attn_out(cfg, p["attn"], out, linear=linear)
    if cfg.post_norm:
        out = norm(p["ln1_post"], out)
    return x + out, new_cache


def attention_route(cur_len: torch.Tensor, s: int) -> str:
    """How a forward of ``s`` new tokens at ``cur_len`` attends over a
    dense cache, decided once per forward (not per layer):

    * ``"decode"`` (s == 1): the flash-decode kernel; no host sync;
    * ``"prefill"`` (s > 1 into an empty cache, ``cur_len`` all 0): the
      flash-attention kernel over the first s positions — equal to the
      masked attention over the whole buffer, since the positions past s
      add nothing;
    * ``"plain"`` (a chunk at an offset above 0): the plain attention.

    Decode in a windowed layer also stays plain (:func:`_dense_attend`).
    The rule reads shapes and lengths only: a kernel that fails to build
    or launch raises rather than falling back."""
    if s == 1:
        return "decode"
    return "prefill" if bool((cur_len == 0).all()) else "plain"


def _dense_attend(cfg, q, k_buf, v_buf, q_positions, kv_len, window, route,
                  *, layout: str = "bthd", k_scale=None, v_scale=None):
    """Attention of q (B, s, Hq, D) over a dense cache along ``route``.

    ``layout`` "bthd": k/v (B, T, Hkv, D) (the backend's per-layer
    buffers); "bhtd": (B, Hkv, T, D) (a stacked cache's layer slice).
    ``k_scale``/``v_scale`` (B, Hkv, T) mark an int8 cache, which every
    route dequantizes in the model dtype, as the JAX package's stacked
    path does.  The kernels read either layout through strides; nothing is
    copied into the other one."""
    b, s = q.shape[:2]
    kh = k_buf.transpose(1, 2) if layout == "bthd" else k_buf
    vh = v_buf.transpose(1, 2) if layout == "bthd" else v_buf
    dt = q.dtype
    if route == "decode" and window is None:
        lens = torch.as_tensor(kv_len, device=q.device).to(torch.int32) \
            .expand(b).contiguous()
        out = K.decode_attention(q[:, 0], kh, vh, lens, k_scale=k_scale,
                                 v_scale=v_scale, softcap=cfg.attn_softcap)
        return out[:, None]
    if route == "prefill":
        kh, vh = kh[:, :, :s], vh[:, :, :s]
        if k_scale is not None:
            # no int8 form of the kernel: dequantize the s positions
            kh = R.dequantize(kh, k_scale[:, :, :s], dt)
            vh = R.dequantize(vh, v_scale[:, :, :s], dt)
        out = K.flash_attention(q.transpose(1, 2), kh, vh, causal=True,
                                window=window, softcap=cfg.attn_softcap)
        return out.transpose(1, 2)
    if k_scale is not None:
        kh, vh = R.dequantize(kh, k_scale, dt), R.dequantize(vh, v_scale, dt)
    kvpos = torch.arange(kh.shape[2], device=q.device)
    K.count_plain("plain_dense_attention", q)
    return L.attention(q, kh, vh, q_positions=q_positions,
                       kv_positions=kvpos[None], kv_len=kv_len, causal=True,
                       window=window, attn_softcap=cfg.attn_softcap,
                       kv_format="bhtd")


def _apply_ffn(cfg, p, x, kind: str, linear=None, norm_fn=None, *,
               plain: bool = False, aux: Optional[torch.Tensor] = None):
    """Pre-norm FFN + residual.  ``plain`` runs the plain forms (the
    training path); with ``aux`` (a scalar) returns ``(x, aux)``, a MoE
    layer adding its :func:`repro_torch.models.layers.moe_aux_loss`."""
    norm = norm_fn or (lambda pp, h: L.apply_norm(cfg, pp, h, plain=plain))
    h = norm(p["ln2"], x)
    if kind == "moe":
        y = L.moe(cfg, p["moe"], h, plain=plain)
        if aux is not None:
            aux = aux + L.moe_aux_loss(cfg, p["moe"], h)
    else:
        y = L.mlp(cfg, p["mlp"], h, linear=linear, plain=plain)
    if cfg.post_norm:
        y = norm(p["ln2_post"], y)
    return (x + y) if aux is None else (x + y, aux)


def decoder_layer(cfg, p, x, positions, *, kv_cache, cur_len, linear,
                  kind: str = "dense", ops: Optional[Dict] = None,
                  block_tables=None, route: str):
    """One full decoder layer (attention + FFN), backend-parameterized.
    Returns (x, new_kv_cache); see :func:`_apply_attn_layer`."""
    ops = ops or {}
    x, new_kv = _apply_attn_layer(cfg, p, x, positions, kind=kind,
                                  kv_cache=kv_cache, cur_len=cur_len,
                                  linear=linear, norm_fn=ops.get("norm"),
                                  attend_fn=ops.get("attend"),
                                  block_tables=block_tables,
                                  paged_attend_fn=ops.get("paged_attend"),
                                  route=route)
    x = _apply_ffn(cfg, p, x, kind, linear=linear, norm_fn=ops.get("norm"))
    return x, new_kv


def make_backend_ops(cfg: ModelConfig) -> Dict:
    """The device pieces between the engine's linears: norms, the dense
    attention route, the paged attention kernels, and the lm head.  PyTorch
    runs them eagerly, so these are the plain functions bound to ``cfg``
    (the JAX package jits the same pieces)."""
    def _paged(q, k_pages, v_pages, block_tables, q_positions, kv_len,
               window, k_scale=None, v_scale=None):
        return _paged_attend(cfg, q, k_pages, v_pages, block_tables,
                             q_positions, kv_len, window,
                             k_scale=k_scale, v_scale=v_scale)

    return {"norm": lambda pp, h: L.apply_norm(cfg, pp, h),
            "attend": lambda *a: _dense_attend(cfg, *a),
            "paged_attend": _paged,
            "logits": lambda shared, x: lm_logits(cfg, shared, x)}


def extract_backend_params(cfg: ModelConfig, params: Dict):
    """Split a stacked param tree into (shared, weights, biases).

    ``weights``/``biases`` map flat linear names ("blk{l}.wq", ...) to
    per-layer tensors (views of the stacked leaves); ``shared`` keeps
    what the layer math reads directly (embeddings, norms, qk-norm
    scales, lm head) plus per-layer small-param dicts under "layers"."""
    _check_dense(cfg)
    period = _pattern_period(cfg)
    weights: Dict = {}
    biases: Dict = {}
    shared: Dict = {"embed": params["embed"],
                    "final_norm": params["final_norm"]}
    for kname in ("lm_head", "pos"):
        if kname in params:
            shared[kname] = params[kname]

    layers = []
    for l in range(cfg.n_layers):
        g, j = divmod(l, period)
        blk = _pick(params["blocks"][f"pos{j}"], g)
        a, m = blk["attn"], blk.get("mlp", {})
        for nm in ("wq", "wk", "wv", "wo"):
            weights[f"blk{l}.{nm}"] = a[nm]
        if cfg.attn_bias:
            for nm, bk in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"),
                           ("wo", "bo")):
                biases[f"blk{l}.{nm}"] = a[bk]
        for nm in ("w_gate", "w_up", "w_down", "w_in"):
            if nm in m:
                weights[f"blk{l}.{nm}"] = m[nm]
        if cfg.attn_bias and "b_in" in m:
            biases[f"blk{l}.w_in"] = m["b_in"]
            biases[f"blk{l}.w_down"] = m["b_down"]
        small = {"ln1": blk["ln1"], "ln2": blk["ln2"], "attn": {}, "mlp": {}}
        if cfg.post_norm:
            small["ln1_post"] = blk["ln1_post"]
            small["ln2_post"] = blk["ln2_post"]
        if cfg.qk_norm:
            small["attn"] = {"q_norm": a["q_norm"], "k_norm": a["k_norm"]}
        layers.append(small)
    shared["layers"] = layers
    return shared, weights, biases


def init_backend_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None) -> Dict:
    """Per-layer dense KV cache: "k{l}"/"v{l}" buffers (B, T, Hkv, hd) plus
    a scalar "len" (continuous batching replaces it with a (B,) vector).
    The paged alternative is minted by
    :meth:`repro_torch.serving.kv_cache.PagedKVCache.init_cache`."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    cache: Dict = {"len": torch.zeros((), dtype=torch.int32, device=dev)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    for l in range(cfg.n_layers):
        cache[f"k{l}"] = torch.zeros(shape, dtype=dt, device=dev)
        cache[f"v{l}"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def backend_prefill(cfg: ModelConfig, shared: Dict, batch: Dict, cache: Dict,
                    *, linear, ops: Optional[Dict] = None,
                    all_logits: bool = False) -> Tuple[Dict, torch.Tensor]:
    """Prompt/step processing with all linears routed through
    ``linear(x, "blk{l}.{name}")``.  Returns (cache, logits): (B, V) for
    the last position, or (B, S, V) with ``all_logits``.

    A cache holding "pages_k{l}"/"pages_v{l}" pools plus "block_tables"
    switches every layer to the paged plumbing; "pages_ks{l}" /
    "pages_vs{l}" scale pools additionally select int8 pages."""
    ops = ops or {}
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, shared, tokens)
    cur_len = cache["len"]
    positions = _positions_from(cur_len, b, s)
    x = _add_learned_pos(cfg, shared, x, positions)
    kinds = cfg.layer_kinds()
    new_cache = dict(cache)
    paged = "pages_k0" in cache
    bt = cache.get("block_tables")
    q8 = "pages_ks0" in cache
    route = "paged" if paged else attention_route(cur_len, s)
    for l in range(cfg.n_layers):
        lin = (lambda h, nm, _l=l: linear(h, f"blk{_l}.{nm}"))
        if paged:
            kvc = (cache[f"pages_k{l}"], cache[f"pages_v{l}"])
            if q8:
                kvc += (cache[f"pages_ks{l}"], cache[f"pages_vs{l}"])
        else:
            kvc = (cache[f"k{l}"], cache[f"v{l}"])
        x, _ = decoder_layer(cfg, shared["layers"][l], x, positions,
                             kv_cache=kvc, cur_len=cur_len, linear=lin,
                             kind=kinds[l], ops=ops,
                             block_tables=bt if paged else None,
                             route=route)
    new_cache["len"] = cur_len + s
    norm = ops.get("norm") or (lambda pp, h: L.apply_norm(cfg, pp, h))
    x = norm(shared["final_norm"], x if all_logits else x[:, -1:])
    if "logits" in ops:
        logits = ops["logits"](shared, x)
    else:
        logits = lm_logits(cfg, shared, x)
    return new_cache, (logits if all_logits else logits[:, 0])


def backend_decode(cfg: ModelConfig, shared: Dict, token: torch.Tensor,
                   cache: Dict, *, linear, ops: Optional[Dict] = None
                   ) -> Tuple[Dict, torch.Tensor]:
    """One decode step through the backend seam: token (B,) -> logits."""
    return backend_prefill(cfg, shared, {"tokens": token[:, None]}, cache,
                           linear=linear, ops=ops)


# ---------------------------------------------------------------------------
# Resident whole model over the stacked cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    """The whole model's KV cache: per pattern position j, "k{j}"/"v{j}"
    stacked over super-blocks as (n_super, B, Hkv, T, hd) — each layer's
    slice is the flash-decode kernel's (B, Hkv, T, D) operand as it is —
    plus a scalar "len".  With ``cfg.kv_dtype == "int8"`` the stacks are
    int8 with fp32 per-(token, head) scales "ks{j}"/"vs{j}"
    (n_super, B, Hkv, T).

    An MLA model caches its compressed entries instead: "lat{j}"
    (n_super, B, T, kv_lora_rank) and "kr{j}" (n_super, B, T, qk_rope_dim).

    The SSM family's cache is its recurrent state, whatever ``max_len``:
    "ssm" (n_groups, period, B, H, P, N) fp32 and the causal convolutions'
    last inputs "conv_x" (..., B, conv - 1, d_inner) and "conv_bc"
    (..., B, conv - 1, 2 G N) in the model dtype, the tail layers' under
    "ssm_tail" / "conv_x_tail" / "conv_bc_tail" (tail, B, ...).  The
    hybrid adds its shared block's K/V, one per site: "shared_k" /
    "shared_v" (n_sites, B, Hkv, T, hd)."""
    _check_whole_model(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    cache: Dict = {"len": torch.zeros((), dtype=torch.int32, device=dev)}

    def mk(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in ("ssm", "hybrid"):
        k1 = cfg.ssm_conv - 1
        state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
        tail = _ssm_tail(cfg)
        for lead, sfx in ((_ssm_groups(cfg), ""), ((tail,), "_tail")):
            if lead[0] == 0:
                continue
            lead = lead + (batch,)
            cache["ssm" + sfx] = mk(lead + state, torch.float32)
            cache["conv_x" + sfx] = mk(lead + (k1, cfg.d_inner))
            cache["conv_bc" + sfx] = mk(lead + (k1, gn2))
        if cfg.family == "hybrid":
            shape = (len(cfg.shared_attn_sites()), batch, cfg.n_kv_heads,
                     max_len, cfg.hd)
            cache["shared_k"] = mk(shape)
            cache["shared_v"] = mk(shape)
        return cache
    period = _pattern_period(cfg)
    n_super = cfg.n_layers // period
    shape = (n_super, batch, cfg.n_kv_heads, max_len, cfg.hd)
    for j in range(period):
        if cfg.attn_kind == "mla":
            cache[f"lat{j}"] = mk((n_super, batch, max_len,
                                   cfg.kv_lora_rank))
            cache[f"kr{j}"] = mk((n_super, batch, max_len, cfg.qk_rope_dim))
        elif cfg.kv_dtype == "int8":
            for nm in (f"k{j}", f"v{j}"):
                cache[nm] = torch.zeros(shape, dtype=torch.int8, device=dev)
            for nm in (f"ks{j}", f"vs{j}"):
                cache[nm] = torch.zeros(shape[:4], dtype=torch.float32,
                                        device=dev)
        else:
            for nm in (f"k{j}", f"v{j}"):
                cache[nm] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _stack_write(stack, new, li, cur_len, dim: int = 2):
    """Write ``new`` (B, s, ...) into layer ``li`` of a stack at ``cur_len``
    (scalar or (B,)), in place: a (L, B, H, T, D) K/V stack (``dim`` 2), or
    a (L, B, T, ...) MLA stack (``dim`` 1)."""
    return _update_kv(stack[li], new, cur_len, dim=dim)


def _stack_write_q8(stack, scale_stack, new, li, cur_len):
    """Quantize ``new`` (B, s, H, D) and write the int8 values and their
    per-(token, head) scales into layer ``li``, in place."""
    q, m = _quantize_kv(new)
    _stack_write(stack, q, li, cur_len)
    _update_kv(scale_stack[li], m, cur_len, dim=2)


def _apply_attn_layer_stacked(cfg, p, x, positions, *, kind: str, stacks,
                              li: int, cur_len, route: str):
    """Pre-norm attention + residual against layer ``li`` of the stacked
    cache: the new rows are written in place and the layer's slice is
    attended along ``route`` (:func:`attention_route`).  ``stacks`` is
    (k, v) or, for an int8 cache, (k, v, k_scale, v_scale); for MLA
    (latent, k_rope), attended in plain PyTorch
    (:func:`repro_torch.models.layers.mla_attend`)."""
    window = cfg.window if kind == "local" else None
    h = L.apply_norm(cfg, p["ln1"], x)
    if cfg.attn_kind == "mla":
        q_nope, q_rope = L.mla_project_q(cfg, p["attn"], h, positions)
        latent, k_rope = L.mla_latent_kv(cfg, p["attn"], h, positions)
        lat_st, kr_st = stacks
        _stack_write(lat_st, latent, li, cur_len, dim=1)
        _stack_write(kr_st, k_rope, li, cur_len, dim=1)
        kvpos = torch.arange(lat_st.shape[2], device=x.device)
        out = L.mla_attend(cfg, p["attn"], q_nope, q_rope, lat_st[li],
                           kr_st[li], q_positions=positions,
                           kv_positions=kvpos[None],
                           kv_len=cur_len + latent.shape[1])
        if cfg.post_norm:
            out = L.apply_norm(cfg, p["ln1_post"], out)
        return x + out
    q, k, v = L.gqa_qkv(cfg, p["attn"], h, positions)
    if len(stacks) == 4:
        k_st, v_st, ks_st, vs_st = stacks
        _stack_write_q8(k_st, ks_st, k, li, cur_len)
        _stack_write_q8(v_st, vs_st, v, li, cur_len)
        scales = dict(k_scale=ks_st[li], v_scale=vs_st[li])
    else:
        k_st, v_st = stacks
        _stack_write(k_st, k, li, cur_len)
        _stack_write(v_st, v, li, cur_len)
        scales = {}
    out = _dense_attend(cfg, q, k_st[li], v_st[li], positions,
                        cur_len + k.shape[1], window, route, layout="bhtd",
                        **scales)
    out = L.attn_out(cfg, p["attn"], out)
    if cfg.post_norm:
        out = L.apply_norm(cfg, p["ln1_post"], out)
    return x + out


def _transformer_trunk(cfg, params, x, positions, *, cache, cur_len,
                       route: str):
    """The decoder stack as a loop over super-blocks and their pattern
    positions (the JAX package scans it), updating the stacked cache in
    place: the pattern position j of super-block g is layer g * period +
    j, of kind ``layer_kinds()[j]`` (Gemma-2's local/global pair,
    Maverick's dense/MoE pair)."""
    kinds = cfg.layer_kinds()
    period = _pattern_period(cfg)
    if cfg.attn_kind == "mla":
        keys = ("lat", "kr")
    else:
        keys = ("k", "v", "ks", "vs") if cfg.kv_dtype == "int8" \
            else ("k", "v")
    blocks = params["blocks"]
    for g in range(cfg.n_layers // period):
        p_blk = _pick(blocks, g)
        for j in range(period):
            stacks = tuple(cache[f"{nm}{j}"] for nm in keys)
            x = _apply_attn_layer_stacked(cfg, p_blk[f"pos{j}"], x,
                                          positions, kind=kinds[j],
                                          stacks=stacks, li=g,
                                          cur_len=cur_len, route=route)
            x = _apply_ffn(cfg, p_blk[f"pos{j}"], x, kinds[j])
    return x


def _shared_block(cfg, params, x, emb0, positions, *, site: int, cache,
                  cur_len, route: Optional[str]):
    """The hybrid's shared transformer block at site ``site``: pre-norm
    attention and MLP over concat([x, emb0]) (2 d wide), the site's LoRA
    added to q, its K/V written into the site's slice of the shared cache
    and attended along ``route``; projected back to d and added to x.
    With no ``cache`` (training) it attends within the sequence on the
    plain forms."""
    plain = cache is None
    p = params["shared"]
    h2 = torch.cat([x, emb0], dim=-1)
    h = L.apply_norm(cfg, p["ln1"], h2, plain=plain)
    q, k, v = L.gqa_qkv(cfg, p["attn"], h, positions, plain=plain)
    if "shared_lora" in params:
        b, s, _ = h.shape
        la = params["shared_lora"]["a"][site]
        lb = params["shared_lora"]["b"][site]
        dq = ((h @ la) @ lb).reshape(b, s, cfg.n_heads, cfg.hd)
        if cfg.pos_emb == "rope":
            dq = L.rope(dq, positions, cfg.rope_theta)
        q = q + dq
    if plain:
        out = L.attention(q, k, v, q_positions=positions,
                          kv_positions=positions, causal=True)
    else:
        k_buf, v_buf = cache["shared_k"][site], cache["shared_v"][site]
        _update_kv(k_buf, k, cur_len, dim=2)
        _update_kv(v_buf, v, cur_len, dim=2)
        out = _dense_attend(cfg, q, k_buf, v_buf, positions,
                            cur_len + k.shape[1], None, route,
                            layout="bhtd")
    b, s, hq, hd = out.shape
    h2 = h2 + out.reshape(b, s, hq * hd) @ p["attn"]["wo"]
    h2 = h2 + L.mlp(cfg, p["mlp"],
                    L.apply_norm(cfg, p["ln2"], h2, plain=plain),
                    plain=plain)
    return x + h2 @ p["proj"]


def _checkpointed(fn):
    """``fn`` under activation checkpointing: its activations are
    recomputed in the backward instead of kept, as the JAX package's
    ``jax.checkpoint`` with ``nothing_saveable`` does."""
    def run(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _mamba_trunk(cfg, params, x, *, cache, positions=None, cur_len=None,
                 route: Optional[str] = None, remat: bool = False):
    """The SSM / hybrid trunk as a loop over its groups and their layers
    (the JAX package scans it): pre-norm Mamba2 block + residual, each
    layer's recurrent and convolution states updated in the cache in
    place.  The hybrid runs its shared block (:func:`_shared_block`) at
    the start of every group, site g for group g, and once more before
    the tail layers where the tail starts at a site; it reads the
    embeddings ``x`` enters with.

    With ``cache=None`` (training) every layer starts from zero states,
    on the plain forms, and ``remat`` checkpoints each group."""
    n_groups, period = _ssm_groups(cfg)
    hybrid = cfg.family == "hybrid"
    plain = cache is None
    emb0 = x
    shared = dict(params=params, emb0=emb0, positions=positions,
                  cache=cache, cur_len=cur_len, route=route)

    def mamba_one(x, p, sfx, idx):
        h = L.apply_norm(cfg, p["ln"], x, plain=plain)
        if plain:
            return x + S.mamba_block(cfg, p, h, plain=True)[0]
        ssm, cx, cbc = (cache[k + sfx][idx] for k in ("ssm", "conv_x",
                                                      "conv_bc"))
        y, s2, (cx2, cbc2) = S.mamba_block(cfg, p, h, ssm_state=ssm,
                                           conv_state=(cx, cbc))
        ssm.copy_(s2)
        cx.copy_(cx2)
        cbc.copy_(cbc2)
        return x + y

    blocks = params["blocks"]

    def group(x, g):
        if hybrid:
            x = _shared_block(cfg, x=x, site=g, **shared)
        for j in range(period):
            x = mamba_one(x, _pick(blocks, (g, j)), "", (g, j))
        return x

    if remat:
        group = _checkpointed(group)
    for g in range(n_groups):
        x = group(x, g)
    tail = _ssm_tail(cfg)
    if tail:
        if hybrid and n_groups * period in cfg.shared_attn_sites():
            x = _shared_block(cfg, x=x, site=n_groups, **shared)
        for t in range(tail):
            x = mamba_one(x, _pick(params["tail"], t), "_tail", t)
    return x


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, cache: Dict,
            all_logits: bool = False) -> Tuple[Dict, torch.Tensor]:
    """Process ``batch["tokens"]`` (B, S) at ``cache["len"]``, writing the
    stacked cache (or the SSM / hybrid state) in place.  Returns (cache,
    logits): (B, V) for the last position, or (B, S, V) with
    ``all_logits``."""
    _check_whole_model(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    cur_len = cache["len"]
    positions = _positions_from(cur_len, b, s)
    x = _add_learned_pos(cfg, params, x, positions)
    if cfg.family == "ssm":
        x = _mamba_trunk(cfg, params, x, cache=cache)
    elif cfg.family == "hybrid":
        x = _mamba_trunk(cfg, params, x, cache=cache, positions=positions,
                         cur_len=cur_len, route=attention_route(cur_len, s))
    else:
        x = _transformer_trunk(cfg, params, x, positions, cache=cache,
                               cur_len=cur_len,
                               route=attention_route(cur_len, s))
    new_cache = dict(cache)
    new_cache["len"] = cur_len + s
    x = L.apply_norm(cfg, params["final_norm"],
                     x if all_logits else x[:, -1:])
    logits = lm_logits(cfg, params, x)
    return new_cache, (logits if all_logits else logits[:, 0])


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                cache: Dict) -> Tuple[Dict, torch.Tensor]:
    """One decode step: token (B,) -> (cache, logits (B, V))."""
    return prefill(cfg, params, {"tokens": token[:, None]}, cache)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def _attn_layer_train(cfg, p, x, positions, kind: str):
    """Pre-norm attention + residual within the sequence (no cache), on the
    plain forms: causal GQA with Gemma-2's window on a local layer and its
    softcap, or MLA over the latents of the sequence itself."""
    h = L.apply_norm(cfg, p["ln1"], x, plain=True)
    if cfg.attn_kind == "mla":
        q_nope, q_rope = L.mla_project_q(cfg, p["attn"], h, positions,
                                         plain=True)
        latent, k_rope = L.mla_latent_kv(cfg, p["attn"], h, positions,
                                         plain=True)
        out = L.mla_attend(cfg, p["attn"], q_nope, q_rope, latent, k_rope,
                           q_positions=positions, kv_positions=positions)
    else:
        q, k, v = L.gqa_qkv(cfg, p["attn"], h, positions, plain=True)
        out = L.attention(q, k, v, q_positions=positions,
                          kv_positions=positions, causal=True,
                          window=cfg.window if kind == "local" else None,
                          attn_softcap=cfg.attn_softcap)
        out = L.attn_out(cfg, p["attn"], out)
    if cfg.post_norm:
        out = L.apply_norm(cfg, p["ln1_post"], out, plain=True)
    return x + out


def _transformer_trunk_train(cfg, params, x, positions):
    """The decoder stack for training: super-block g's pattern positions
    in order, each super-block checkpointed where ``cfg.remat`` asks.
    Returns (x, aux), aux the sum of the MoE layers' load-balancing
    losses (0 for a dense model)."""
    kinds = cfg.layer_kinds()
    period = _pattern_period(cfg)

    def block(x, aux, p_blk):
        for j in range(period):
            p = p_blk[f"pos{j}"]
            x = _attn_layer_train(cfg, p, x, positions, kinds[j])
            x, aux = _apply_ffn(cfg, p, x, kinds[j], plain=True, aux=aux)
        return x, aux

    if cfg.remat:
        block = _checkpointed(block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_layers // period):
        x, aux = block(x, aux, _pick(params["blocks"], g))
    return x, aux


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict,
                  return_aux: bool = False):
    """Full causal forward over ``batch["tokens"]`` (B, S) -> logits
    (B, S, V) fp32, and with ``return_aux`` the MoE load-balancing term
    (a scalar, 0 without experts).

    No cache is read or written and no kernel is reached: every operation
    is a plain PyTorch one that autograd differentiates.  Dense and MoE
    transformers (Gemma-2's local/global layers and softcaps, MLA), SSM
    and hybrid trunks; encoder-decoder and VLM families raise."""
    _check_whole_model(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    positions = _positions_from(zero, b, s)
    x = _add_learned_pos(cfg, params, x, positions)
    if cfg.family in ("ssm", "hybrid"):
        x = _mamba_trunk(cfg, params, x, cache=None, positions=positions,
                         remat=cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _transformer_trunk_train(cfg, params, x, positions)
    x = L.apply_norm(cfg, params["final_norm"], x, plain=True)
    logits = lm_logits(cfg, params, x)
    return (logits, aux) if return_aux else logits
