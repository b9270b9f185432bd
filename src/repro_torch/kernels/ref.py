"""Plain PyTorch versions of the hand-written kernels.

Each function mirrors one kernel's contract exactly (and the JAX
package's pure-jnp oracle of the same name).  They are what a CPU tensor
runs through :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py``
holds every CUDA kernel against on the card, within the per-element
limits of the ``*_limit`` functions.  All arithmetic is fp32 (a dense
int8 cache is dequantized in q's dtype first, as the JAX package's
stacked path does).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N) int8, scale (N,)) -> (M, N)."""
    y = x.float() @ q.float()
    return (y * scale.float()[None, :]).to(x.dtype)


def _zero_past(x: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """Zero every position of (B, H, T, D) ``x`` at or past ``n_live[b]``:
    those are masked anyway, and the rows behind them (the trash page,
    stale cache rows) may hold anything, NaN included, which must not
    reach the PV sum as 0 * NaN."""
    live = (torch.arange(x.shape[2], device=x.device)[None, :]
            < n_live.long()[:, None])[:, None, :, None]
    return torch.where(live, x, 0.0)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 ``q`` (..., D) times its per-row ``scale`` (...), with both
    factors and their product in ``dtype``.  In fp32 that is the paged
    kernels' rule; in the model dtype it is the JAX package's stacked path
    (``k.astype(dt) * ks.astype(dt)``, ``models/model.py:481-485``), which
    the dense decode kernel follows."""
    return q.to(dtype) * scale.to(dtype)[..., None]


def decode_attention(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                     softcap=None, return_lse=False):
    """q (B,Hq,D); k/v (B,Hkv,S,D); kv_len (B,).  With ``k_scale`` /
    ``v_scale`` (B,Hkv,S) the cache is int8 and is dequantized in q's
    dtype (:func:`dequantize`).  Positions at or past ``kv_len`` never
    reach the result, NaN included.  ``return_lse`` also gives each
    (row, q-head)'s log-sum-exp of its scores (B,Hq) fp32, -inf where
    ``kv_len`` is 0."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    if k_scale is not None:
        k, v = dequantize(k, k_scale, q.dtype), dequantize(v, v_scale, q.dtype)
    kf, vf = k.float(), v.float()
    kf, vf = _zero_past(kf, kv_len), _zero_past(vf, kv_len)
    qf = q.reshape(b, hkv, g, d).float()
    sc = torch.einsum("bkgd,bktd->bkgt", qf, kf)
    sc = sc / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    mask = torch.arange(s, device=q.device)[None, :] \
        < kv_len.to(q.device).long()[:, None]
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, vf)
    o = o.reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(sc, dim=-1).reshape(b, hq)
    lse = torch.where(mask.any(dim=-1)[:, None], lse, float("-inf"))
    return o, lse


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q (B,Hq,Sq,D); k/v (B,Hkv,Skv,D); query i at position i, key j at
    position j."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    s = s / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = torch.where(ok[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def rmsnorm(x, scale, *, eps=1e-6, plus_one=False):
    """x (..., D) -> x * rsqrt(mean(x^2) + eps) * w (``w + 1`` with
    ``plus_one``), statistics in fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    w = scale.float()
    if plus_one:
        w = w + 1.0
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# How far a kernel may lie from its plain version, element by element
# ---------------------------------------------------------------------------

_HALF = (torch.bfloat16, torch.float16)
_SLACK = 1.01          # second-order terms of the rounding bounds below


def _attention_limit(want, abs_out, p_dtype, *, int8):
    """|kernel - plain| limit per element of an attention output ``want``:

    * fp32 arithmetic in a different order: 2e-5 (2e-4 over an int8
      cache, whose dequantized values are larger);
    * both outputs rounded to ``want``'s dtype: up to one step apart,
      ``eps * |want|`` (2^-7 in bf16);
    * the kernels round p to a 16-bit value dtype before the PV product
      (as the Pallas kernels and ``layers.attention`` do; l sums the
      unrounded p, the plain version rounds nothing).  Each p moves by at
      most ``eps / 2`` of itself, so the output by at most ``eps / 2 *
      sum(p |v|) / sum(p)``: ``abs_out`` is that attention over |v| and
      ``p_dtype`` the value dtype, or both None where p is not rounded
      (fp32 caches, and int8 caches dequantized in fp32).
    """
    lim = (2e-4 if int8 else 2e-5) \
        + _SLACK * torch.finfo(want.dtype).eps * want.float().abs()
    if abs_out is not None:
        lim = lim + _SLACK * torch.finfo(p_dtype).eps / 2 * abs_out
    return lim


def decode_attention_limit(q, k, v, kv_len, want, *, k_scale=None,
                           v_scale=None, softcap=None):
    """Per-element limit on |kernel - :func:`decode_attention`| (``want``)
    on these inputs; see :func:`_attention_limit`.  An int8 cache under a
    bf16 q is dequantized in bf16 and rounds p like a bf16 cache."""
    abs_out = p_dtype = None
    q8 = k_scale is not None
    if q8:
        k, v = dequantize(k, k_scale, q.dtype), dequantize(v, v_scale, q.dtype)
    if v.dtype in _HALF:
        abs_out = decode_attention(q.float(), k, v.abs(), kv_len,
                                   softcap=softcap)
        p_dtype = v.dtype
    return _attention_limit(want, abs_out, p_dtype, int8=q8)


def paged_decode_attention_limit(q, k_pages, v_pages, block_tables, kv_len,
                                 want, *, k_scale=None, v_scale=None,
                                 softcap=None):
    """Per-element limit on |kernel - :func:`paged_decode_attention`|
    (``want``); see :func:`_attention_limit`.  int8 pages dequantize in
    fp32, so only 16-bit pages round p."""
    abs_out = p_dtype = None
    if v_pages.dtype in _HALF:
        abs_out = paged_decode_attention(q.float(), k_pages, v_pages.abs(),
                                         block_tables, kv_len,
                                         softcap=softcap)
        p_dtype = v_pages.dtype
    return _attention_limit(want, abs_out, p_dtype, int8=k_scale is not None)


def paged_prefill_attention_limit(q, k_pages, v_pages, block_tables,
                                  kv_offset, want, *, k_scale=None,
                                  v_scale=None, softcap=None, window=None):
    """Per-element limit on |kernel - :func:`paged_prefill_attention`|
    (``want``); see :func:`_attention_limit`."""
    abs_out = p_dtype = None
    if v_pages.dtype in _HALF:
        abs_out = paged_prefill_attention(q.float(), k_pages, v_pages.abs(),
                                          block_tables, kv_offset,
                                          softcap=softcap, window=window)
        p_dtype = v_pages.dtype
    return _attention_limit(want, abs_out, p_dtype, int8=k_scale is not None)


def flash_attention_limit(q, k, v, want, *, causal=True, window=None,
                          softcap=None):
    """Per-element limit on |kernel - :func:`flash_attention`| (``want``)
    on these inputs; see :func:`_attention_limit`."""
    abs_out = p_dtype = None
    if v.dtype in _HALF:
        abs_out = flash_attention(q.float(), k, v.abs(), causal=causal,
                                  window=window, softcap=softcap)
        p_dtype = v.dtype
    return _attention_limit(want, abs_out, p_dtype, int8=False)


def rmsnorm_limit(want):
    """Per-element limit on |kernel - :func:`rmsnorm`| (``want``): 1e-5
    relative for fp32 statistics in a different order (and ``rsqrt``'s
    own error), plus one step of ``want``'s dtype where both round it."""
    w = want.float().abs()
    return 1e-6 + (1e-5 + _SLACK * torch.finfo(want.dtype).eps) * w


# The most of a 16-bit RMSNorm output that may differ in its bits from
# :func:`rmsnorm`.  One bf16 step, which :func:`rmsnorm_limit` must allow,
# also passes a kernel that rounds the squares to bf16 before the mean, or
# x * rsqrt to bf16 before the scale, or takes the mean over D - 1: at 2048
# x 5120 bf16 those differ in 1.07e-2, 0.26 and 1.81e-2 of the elements.
# A kernel that follows the plain version's fp32 operations and rounds once
# differs only where its order of the sum moves rsqrt by an ulp and that
# flips a rounding: 5.8e-6 of the elements for per-lane sums and a tree.
# (In fp32 an ulp of rsqrt moves nearly every element's last bit, and the
# limit's 1e-5 rejects each of those faults, so this holds 16-bit outputs.)
RMSNORM_UNEQUAL_MAX = 1e-3


def unequal_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of elements of ``got`` whose bits differ from ``want``'s
    (both of one 16- or 32-bit dtype and shape)."""
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return float((got.view(ints) != want.view(ints)).float().mean())


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """(P, H, ps, D) pages + (B, nb) tables -> contiguous (B, H, nb*ps, D)."""
    g = pages[block_tables.long()]             # (B, nb, H, ps, D)
    b, nb, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, nb * ps, d)


def gather_page_scales(scales: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """(P, H, ps) scale pages + (B, nb) tables -> (B, H, nb*ps)."""
    g = scales[block_tables.long()]            # (B, nb, H, ps)
    b, nb, h, ps = g.shape
    return g.permute(0, 2, 1, 3).reshape(b, h, nb * ps)


def _gather_kv(k_pages, v_pages, block_tables, k_scale, v_scale, n_live):
    """Gather the pages of each row, dequantize int8 pages, and zero every
    position at or past ``n_live[b]`` (see :func:`_zero_past`)."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scale is not None:             # in fp32, as the paged kernels do
        k = dequantize(k, gather_page_scales(k_scale, block_tables),
                       torch.float32)
        v = dequantize(v, gather_page_scales(v_scale, block_tables),
                       torch.float32)
    return _zero_past(k, n_live), _zero_past(v, n_live)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len, *,
                           k_scale=None, v_scale=None, softcap=None):
    """q (B,Hq,D); k/v_pages (P,Hkv,ps,D); block_tables (B,nb); kv_len (B,).

    Gathers physical pages into a contiguous cache, then defers to the
    dense :func:`decode_attention` — positions >= kv_len are masked, so
    trash-page contents never reach the softmax.
    """
    k, v = _gather_kv(k_pages, v_pages, block_tables, k_scale, v_scale,
                      kv_len)
    return decode_attention(q, k, v, kv_len, softcap=softcap).to(q.dtype)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_offset, *,
                            k_scale=None, v_scale=None, softcap=None,
                            window=None):
    """q (B,Hq,S,D); k/v_pages (P,Hkv,ps,D); block_tables (B,nb);
    kv_offset (B,).

    Query row r of batch b sits at absolute position ``kv_offset[b] + r``
    and attends causally over logical kv positions [0, kv_offset[b] + r]
    (and, with ``window``, only the last ``window`` of them).  Positions
    above the causal diagonal never reach the softmax, so trash-page
    contents are irrelevant.
    """
    b, hq, s, d = q.shape
    k, v = _gather_kv(k_pages, v_pages, block_tables, k_scale, v_scale,
                      kv_offset.long() + s)
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, s, d).float()
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    sc = sc / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = kv_offset.long()[:, None] \
        + torch.arange(s, device=q.device)[None, :]            # (B, s)
    kpos = torch.arange(t, device=q.device)
    ok = kpos[None, None, :] <= qpos[:, :, None]               # (B, s, t)
    if window is not None:
        ok &= kpos[None, None, :] > qpos[:, :, None] - window
    sc = torch.where(ok[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(b, hq, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD, intra-chunk part
# ---------------------------------------------------------------------------

def ssd_chunk(x, dt, a, b, c, *, chunk: int):
    """The intra-chunk part of chunked SSD, per (batch, head, chunk):

    * ``cum``: the inclusive cumsum of ``dt * a`` over the chunk;
    * ``y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j``;
    * ``state_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T``.

    x (B,L,H,P); dt (B,L,H) after softplus; a (H,) negative; b/c (B,L,H,N),
    which may be a stride-0 expand of (B,L,G,N) over the heads.  L % chunk
    == 0.  Returns (y_intra (B,L,H,P), state_c (B,nc,H,P,N), cum (B,L,H)),
    all fp32.  ``y_intra`` stays fp32 where the Pallas kernel writes
    x.dtype: the path it stands for (``ssd_chunked``) adds the inter-chunk
    term and D x before its one cast."""
    bs, ln, h, p = x.shape
    n = b.shape[-1]
    nc = ln // chunk
    xc = x.reshape(bs, nc, chunk, h, p).float()
    dtc = dt.reshape(bs, nc, chunk, h).float()
    bc = b.reshape(bs, nc, chunk, h, n).float()
    cc = c.reshape(bs, nc, chunk, h, n).float()
    cum = torch.cumsum(dtc * a.float(), dim=2)            # (B,nc,K,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # cum_i - cum_j
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    xdt = xc * dtc[..., None]
    cb = torch.einsum("bnkhs,bnlhs->bnklh", cc, bc)
    y = torch.einsum("bnklh,bnlhp->bnkhp", cb * decay, xdt)
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    sc = torch.einsum("bnkh,bnkhs,bnkhp->bnhps", tail, bc, xdt)
    return y.reshape(bs, ln, h, p), sc, cum.reshape(bs, ln, h)


_U32 = 2.0 ** -24      # fp32 unit roundoff


def _gamma(k: int) -> float:
    """The classical bound on a k-term fp32 sum's relative error."""
    return k * _U32 / (1 - k * _U32)


def ssd_chunk_limit(x, dt, a, b, c, other_cum, *, chunk: int):
    """Per-element limits (y, state, cum) on |other - :func:`ssd_chunk`|,
    for another fp32 computation of the same function in a different
    order, whose ``cum`` (B,L,H) is ``other_cum``:

    * ``cum_i``: any order of an i-term sum errs by at most
      ``gamma_K * S_i`` (``S_i`` the prefix sum of |dt a|), so the two
      sides may differ by ``E_i = 2 gamma_K S_i``: cum's limit;
    * the decay ``exp(cum_i - cum_j)`` then differs by a relative
      ``rho_ij = 1.01 (d_i + d_j + 2u |cum_i - cum_j|) + 8u`` (exp's two
      ulps a side, and the subtraction), with ``d_i`` the two sides'
      actual distance at i, which cum's own limit holds within ``E_i``;
    * ``C_i . B_j`` by ``2 gamma_N A_ij`` (``A_ij = sum_n |C_in B_jn|``),
      and a K-term sum of products by ``2 gamma_K`` of its |terms|;
      ``dt_j x_j`` is one rounding of the same operands on both sides;
    * so ``|dy_ip| <= sum_{j<=i} A_ij decay_ij |dt_j x_jp| (2 gamma_N +
      2 gamma_K + rho_ij + 8u)`` and ``|ds_pn| <= sum_j tail_j |B_jn|
      |dt_j x_jp| (2 gamma_K + rho_Kj + 8u)``, each times 1.01 for the
      second-order terms.

    Taking ``d_i`` as read, not its worst case ``E_i``, keeps y's limit
    near 3e-5 of its |terms| in every row: at Mamba2-2.7B's widths (K = N
    = 128, |dt a| near 0.5) ``E_i`` reaches 1e-3 in a chunk's late rows,
    which would pass a y_intra rounded to bf16 (2^-9 of |y|) there."""
    bs, ln, h, p = x.shape
    n = b.shape[-1]
    nc = ln // chunk
    u = _U32
    gk, gn = _gamma(chunk), _gamma(n)
    dtc = dt.reshape(bs, nc, chunk, h).float()
    la = dtc * a.float()
    cum = torch.cumsum(la, dim=2)
    e = 2 * gk * torch.cumsum(la.abs(), dim=2)            # E_i
    d = (other_cum.reshape(bs, nc, chunk, h).float() - cum).abs()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    rho = _SLACK * (d[:, :, :, None, :] + d[:, :, None, :, :]
                    + 2 * u * seg.abs()) + 8 * u
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    xdt = (x.reshape(bs, nc, chunk, h, p).float() * dtc[..., None]).abs()
    bc = b.reshape(bs, nc, chunk, h, n).float().abs()
    cc = c.reshape(bs, nc, chunk, h, n).float().abs()
    acb = torch.einsum("bnkhs,bnlhs->bnklh", cc, bc)
    w = acb * decay * (2 * gn + 2 * gk + rho + 8 * u)
    y_lim = _SLACK * torch.einsum("bnklh,bnlhp->bnkhp", w, xdt)
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    rho_t = rho[:, :, -1]                                  # (B,nc,K,H)
    s_lim = _SLACK * torch.einsum("bnkh,bnkhs,bnkhp->bnhps",
                                  tail * (2 * gk + rho_t + 8 * u), bc, xdt)
    return (y_lim.reshape(bs, ln, h, p), s_lim,
            (e + 8 * u * cum.abs()).reshape(bs, ln, h))


# ---------------------------------------------------------------------------
# Dense matmul with a fused epilogue
# ---------------------------------------------------------------------------

def _act(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """``_apply_act`` of the Pallas kernels: none, relu, relu2, gelu (the
    tanh form, ``jax.nn.gelu``'s default) or silu."""
    if activation in (None, "none"):
        return y
    if activation == "relu":
        return torch.relu(y)
    if activation == "relu2":
        r = torch.relu(y)
        return r * r
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return y * torch.sigmoid(y)
    raise ValueError(f"unknown activation {activation!r}")


def matmul(x, w, bias=None, *, activation=None):
    """act(x (M, K) @ w (K, N) + bias (N,)): fp32 product, bias and
    activation in fp32, one cast to x's dtype."""
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return _act(y, activation).to(x.dtype)


def gated_matmul(x, w_gate, w_up, *, activation="silu"):
    """act(x @ w_gate) * (x @ w_up), both products and the gate in fp32,
    one cast to x's dtype."""
    xf = x.float()
    g = _act(xf @ w_gate.float(), activation)
    return (g * (xf @ w_up.float())).to(x.dtype)


# largest |act'| of gelu (tanh form, 1.129 near 1.5) and silu (1.0998 near 2.4)
_ACT_SLOPE = {"gelu": 1.13, "silu": 1.1}


def _act_error(z, dz, activation):
    """Bound on |act(z') - act(z)| over |z' - z| <= dz, plus each side's
    evaluation error of act: the slope bound times dz (relu2: ``(2 r + dz)
    dz`` with r = relu(z)), and for relu2 the square's rounding, for gelu
    and silu a few ulps of |act| and |z| (tanh/exp and the cancellation of
    ``1 + tanh`` far below 0)."""
    if activation in (None, "none", "relu"):
        return dz
    a = _act(z, activation).abs()
    if activation == "relu2":
        return (2 * torch.relu(z) + dz) * dz + 2 * _U32 * a
    return _ACT_SLOPE[activation] * dz + 8 * _U32 * (a + z.abs())


# How many units of ``u sqrt(K) (sqrt(sum t_k^2) + |z|)`` two fp32 sums of
# the same products may lie apart (:func:`_product_bound`).  The fp32
# kernels of ``csrc/hete_matmul.cu`` lay at most 1.53 units from cuBLAS's
# sums at the shapes of ``chip_smoke.py`` 4d (one H100 80GB HBM3, 700 W);
# 5 leaves over 3x of room.
_MM_UNITS = 5.0


def _product_bound(xf, wf):
    """(z = x @ w, the limit on two fp32 computations of it in different
    orders).  Not the worst case ``gamma_K sum_k |x_k w_k|``: at K = 4096
    that is about 2% of |z|, which a sum of TF32 or bf16-rounded
    operands passes.  Each side's error is ``sum_k d_k S_k`` over its
    partial sums S_k with |d_k| <= u; for terms t_k = x_k w_k of either
    sign the S_k wander like ``sqrt(k) rms(t)`` and the error like ``u
    sqrt(K) sqrt(sum t_k^2)``, for terms of one sign S_k grows to z and the
    error like ``u sqrt(K) |z|``.  The limit is ``_MM_UNITS`` times
    ``u sqrt(K) (sqrt(sum t_k^2) + |z|)``, its factor set from the card's
    runs; operands rounded to TF32 (2^-11) lie hundreds of units off."""
    z = xf @ wf
    rms = ((xf * xf) @ (wf * wf)).sqrt()
    unit = _U32 * math.sqrt(xf.shape[-1]) * (rms + z.abs())
    return z, _MM_UNITS * unit


# How many units of ``u (sqrt(sum_k t_k^2) + |z|)`` (t_k = x_k q_k, z their
# exact sum) an fp32 sum of an int8-weight product may lie from the exact
# product (:func:`q8_matmul_limit`).  The kernels of ``csrc/q8_matmul.cu``,
# which sum in blocks, use 0.33-0.75 of the limit at every shape of
# ``chip_smoke.py``'s q8 run (0.37-0.39 at M <= 16; 0.33-0.75 for the
# three-term bf16 tensor-core kernel above), and the plain version over x
# kept to 16 significant bits (what a two-term bf16 split of x carries)
# lies beyond it in about half of the elements; an earlier SGEMM, one fp32
# chain per output over all K, lay 1.7-5.6x beyond it (one H100 80GB HBM3,
# 700 W; PERF.md): this limit holds the kernels to blocked sums.
_Q8_UNITS = 32.0


def q8_matmul_limit(x, q, scale, want):
    """Per-element limit on |kernel - :func:`q8_matmul`| (``want``) for an
    fp32 computation of the same product that sums in blocks.  Not
    ``_product_bound``'s own limit, whose sqrt(K) factor lets a sequential
    fp32 sum pass and so also passes x kept to 16 significant bits (a
    two-term bf16 split) at K = 4096 and above: the exact product z (fp64,
    from :func:`_product_bound` over fp64 operands) splits the distance
    into the plain version's own, measured, ``|want - z s|``, and the
    kernel's, at most ``_Q8_UNITS`` units of ``u (sqrt(sum t_k^2) + |z|)``
    (``_product_bound``'s unit without its sqrt(K)) before the column
    scale and one rounding of ``z s`` after it."""
    kk = max(x.shape[-1], 1)
    z, dz = _product_bound(x.double(), q.double())
    unit = dz / (_MM_UNITS * math.sqrt(kk))
    s = scale.double()[None, :]
    own = (want.double() - z * s).abs()
    return (own + _SLACK * (_Q8_UNITS * unit + _U32 * z.abs()) * s.abs()
            ).float()


def matmul_limit(x, w, want, bias=None, *, activation=None):
    """Per-element limit on |kernel - :func:`matmul`| (``want``), for
    another fp32 summation of the same products: the two sums' distance
    (:func:`_product_bound`) and, with a bias, each side's rounding of
    the add, carried through the activation (:func:`_act_error`), plus
    one step of ``want``'s dtype where both round the result."""
    z, dz = _product_bound(x.float(), w.float())
    if bias is not None:
        z = z + bias.float()
        dz = dz + 2 * _U32 * z.abs()
    lim = _act_error(z, dz, activation)
    return _SLACK * (lim + torch.finfo(want.dtype).eps * want.float().abs())


def gated_matmul_limit(x, w_gate, w_up, want, *, activation="silu"):
    """Per-element limit on |kernel - :func:`gated_matmul`| (``want``):
    the gate's and the up product's distances (:func:`_product_bound`),
    the gate's through the activation (e_a), combined as
    ``e_a (|u| + d_u) + |act(g)| d_u`` plus each side's rounding of the
    product, and one step of ``want``'s dtype."""
    xf = x.float()
    g, dg = _product_bound(xf, w_gate.float())
    u, du = _product_bound(xf, w_up.float())
    ea = _act_error(g, dg, activation)
    a = _act(g, activation).abs()
    lim = ea * (u.abs() + du) + a * du + 2 * _U32 * a * u.abs()
    return _SLACK * (lim + torch.finfo(want.dtype).eps * want.float().abs())
