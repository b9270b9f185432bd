"""Model assembly for the backend path of the dense decoder families.

The PyTorch counterpart of the backend half of the JAX package's
``models/model.py``: parameter init, the embedding / head, the per-layer
KV cache (dense or paged), and the decoder layer with every weight matmul
routed through an injected ``linear(x, name)`` callable — the seam that
lets :mod:`repro_torch.serving.backends` run the same math resident or
HeteGen-offloaded.

Parameters are plain nested dicts with the JAX package's layout
(per-super-block leaves stacked on a leading axis), so
:func:`params_from_numpy` converts a JAX param tree leaf by leaf.

Caches are updated **in place**: the dense buffers and the page pools are
device tensors that the layer writes into (``copy_`` / ``index_put_``),
where the JAX package rebuilds them functionally.  The returned cache
dict holds the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
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


def _pattern_period(cfg: ModelConfig) -> int:
    if cfg.layer_pattern:
        return len(cfg.layer_pattern)
    if cfg.n_experts and cfg.moe_layer_period > 1:
        return cfg.moe_layer_period
    return 1


def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int] = 0, *,
                device=None) -> Dict:
    """Random params for a dense GQA decoder, drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or an int seed).  Same tree layout
    as the JAX package's ``init_params``; the numbers differ (the two
    frameworks' generators do)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    dt = torch_dtype(cfg)

    def dense(shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w.mul_(std)).to(dt)

    def norm(d):
        p = {"scale": torch.ones((d,), dtype=dt, device=dev)}
        if cfg.norm_kind == "layernorm":
            p["bias"] = torch.zeros((d,), dtype=dt, device=dev)
        if cfg.post_norm:
            p["scale"] = torch.zeros((d,), dtype=dt, device=dev)
        return p

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=dev)

    d, f = cfg.d_model, cfg.d_ff
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def block():
        attn = {"wq": dense((d, hq * hd)), "wk": dense((d, hkv * hd)),
                "wv": dense((d, hkv * hd)), "wo": dense((hq * hd, d))}
        if cfg.attn_bias:
            attn.update(bq=zeros(hq * hd), bk=zeros(hkv * hd),
                        bv=zeros(hkv * hd), bo=zeros(d))
        if cfg.qk_norm:
            attn.update(q_norm=torch.ones((hd,), dtype=dt, device=dev),
                        k_norm=torch.ones((hd,), dtype=dt, device=dev))
        if cfg.mlp_kind.startswith("gated"):
            mlp = {"w_gate": dense((d, f)), "w_up": dense((d, f)),
                   "w_down": dense((f, d))}
        else:
            mlp = {"w_in": dense((d, f)), "w_down": dense((f, d))}
            if cfg.attn_bias:
                mlp.update(b_in=zeros(f), b_down=zeros(d))
        p = {"ln1": norm(d), "ln2": norm(d), "attn": attn, "mlp": mlp}
        if cfg.post_norm:
            p["ln1_post"] = norm(d)
            p["ln2_post"] = norm(d)
        return p

    params: Dict = {"embed": dense((cfg.vocab_size, d), scale=1.0),
                    "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    if cfg.pos_emb == "learned":
        params["pos"] = dense((cfg.max_seq, d), scale=0.02)
    period = _pattern_period(cfg)
    supers = [{f"pos{j}": block() for j in range(period)}
              for _ in range(cfg.n_layers // period)]
    params["blocks"] = _stack(supers)
    return params


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    out = torch.stack(trees, dim=0)
    trees.clear()            # drop the per-layer copies as we go
    return out


def params_from_numpy(tree, device=None):
    """A param tree of numpy arrays (e.g. the JAX package's params through
    ``np.asarray``) -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree)).to(dev)


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
        x = x * math.sqrt(cfg.d_model)
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


def _update_kv(buf: torch.Tensor, new: torch.Tensor,
               cur_len: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, s, H, D) into a (B, T, H, D) buffer at ``cur_len``
    (scalar, or a (B,) per-slot vector), in place.  A scalar start clamps
    like ``lax.dynamic_update_slice``; per-slot tails past the buffer are
    dropped."""
    b, s = new.shape[:2]
    t = buf.shape[1]
    if cur_len.dim() == 0:
        start = max(0, min(int(cur_len), t - s))
        buf[:, start:start + s] = new.to(buf.dtype)
        return buf
    pos = _scatter_pos(cur_len, b, s)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    keep = pos < t
    buf[rows[keep], pos[keep]] = new[keep].to(buf.dtype)
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
    from repro_torch.kernels import ops as K

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
                      block_tables=None, paged_attend_fn=None):
    """Pre-norm attention + residual over a per-layer cache.  Returns
    (x, new_kv_cache).

    ``kv_cache`` is (k, v) dense buffers (B, T, Hkv, hd) written at
    ``cur_len``; with ``block_tables`` (B, nb) it holds page pools
    instead — (k_pages, v_pages) in (P, Hkv, ps, hd) layout, or
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
        if attend_fn is not None:
            out = attend_fn(q, k_buf, v_buf, positions,
                            cur_len + k.shape[1], window)
        else:
            out = _dense_attend(cfg, q, k_buf, v_buf, positions,
                                cur_len + k.shape[1], window)
        new_cache = (k_buf, v_buf)
    out = L.attn_out(cfg, p["attn"], out, linear=linear)
    if cfg.post_norm:
        out = norm(p["ln1_post"], out)
    return x + out, new_cache


def _dense_attend(cfg, q, k_buf, v_buf, q_positions, kv_len, window):
    kvpos = torch.arange(k_buf.shape[1], device=q.device)
    return L.attention(q, k_buf, v_buf, q_positions=q_positions,
                       kv_positions=kvpos[None], kv_len=kv_len,
                       causal=True, window=window,
                       attn_softcap=cfg.attn_softcap, kv_format="bthd")


def _apply_ffn(cfg, p, x, kind: str, linear=None, norm_fn=None):
    norm = norm_fn or (lambda pp, h: L.apply_norm(cfg, pp, h))
    h = norm(p["ln2"], x)
    y = L.mlp(cfg, p["mlp"], h, linear=linear)
    if cfg.post_norm:
        y = norm(p["ln2_post"], y)
    return x + y


def decoder_layer(cfg, p, x, positions, *, kv_cache, cur_len, linear,
                  kind: str = "dense", ops: Optional[Dict] = None,
                  block_tables=None):
    """One full decoder layer (attention + FFN), backend-parameterized.
    Returns (x, new_kv_cache); see :func:`_apply_attn_layer`."""
    ops = ops or {}
    x, new_kv = _apply_attn_layer(cfg, p, x, positions, kind=kind,
                                  kv_cache=kv_cache, cur_len=cur_len,
                                  linear=linear, norm_fn=ops.get("norm"),
                                  attend_fn=ops.get("attend"),
                                  block_tables=block_tables,
                                  paged_attend_fn=ops.get("paged_attend"))
    x = _apply_ffn(cfg, p, x, kind, linear=linear, norm_fn=ops.get("norm"))
    return x, new_kv


def make_backend_ops(cfg: ModelConfig) -> Dict:
    """The device pieces between the engine's linears: norms, the dense
    attention core, the paged attention kernels, and the lm head.  PyTorch
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

    def pick(tree, g):
        if isinstance(tree, dict):
            return {k: pick(v, g) for k, v in tree.items()}
        return tree[g]

    layers = []
    for l in range(cfg.n_layers):
        g, j = divmod(l, period)
        blk = pick(params["blocks"][f"pos{j}"], g)
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
                             block_tables=bt if paged else None)
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
