"""Plain PyTorch versions of the kernels on the serving path.

Each function mirrors one kernel's contract exactly (and the JAX
package's pure-jnp oracle of the same name).  They are what a CPU tensor
runs through :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py``
holds every CUDA kernel against on the card.  All arithmetic is fp32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N) int8, scale (N,)) -> (M, N)."""
    y = x.float() @ q.float()
    return (y * scale.float()[None, :]).to(x.dtype)


def decode_attention(q, k, v, kv_len, *, softcap=None):
    """q (B,Hq,D); k/v (B,Hkv,S,D); kv_len (B,)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, d).float()
    sc = torch.einsum("bkgd,bktd->bkgt", qf, k.float())
    sc = sc / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    mask = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(b, hq, d).to(q.dtype)


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
    position at or past ``n_live[b]``: those are masked anyway, and the
    pages behind them (the trash page, stale pool rows) may hold anything,
    NaN included, which must not reach the PV sum as 0 * NaN."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scale is not None:
        k = k.float() * gather_page_scales(k_scale, block_tables)[..., None]
        v = v.float() * gather_page_scales(v_scale, block_tables)[..., None]
    t = k.shape[2]
    live = (torch.arange(t, device=k.device)[None, :]
            < n_live.long()[:, None])[:, None, :, None]
    return torch.where(live, k, 0.0), torch.where(live, v, 0.0)


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
