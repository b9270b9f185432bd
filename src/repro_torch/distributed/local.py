"""The kernel call sites of the sharded path: each hand-written kernel runs
on its operands' local shards.

The kernels launch through ``ctypes`` on raw pointers and must never see a
``DTensor``.  Each function here takes the operands of one
:mod:`repro_torch.kernels.ops` wrapper as ``DTensor``s, picks the
placements the kernel can work under — every dim it needs whole is
replicated first (an explicit redistribute, never a quiet switch to the
plain form) — and calls the wrapper through
``torch.distributed.tensor.experimental.local_map``, the counterpart of
the JAX package's ``shard_map``:

* :func:`rmsnorm` — the normalized (last) dim whole;
* :func:`mlp_in` — the fused first MLP stage: the contraction dim whole
  (FSDP weights all-gathered over ``data``), the output dim sharded where
  the weight's is;
* :func:`decode_attention` — batch and kv heads as the cache has them;
  where the cache shards its SEQUENCE (kv heads that do not divide the
  ``model`` axis), every rank attends over its keys, the kernel returns
  each row's log-sum-exp, and the ranks combine with a max, a sum and a
  weighted sum over the group (the cache is never gathered);
* :func:`flash_attention` — the sequence whole, heads as the keys have
  them (a rank whose q heads are sharded over keys it holds whole takes
  the kv heads of its own q heads);
* :func:`ssd_chunk` — the sequence whole, heads sharded.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.distributed.shardings import is_dtensor
from repro_torch.kernels import ops as K


def _placements():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Partial, Replicate, Shard


def as_dtensor(t: Optional[torch.Tensor], mesh):
    """``t`` as a ``DTensor`` on ``mesh`` (a plain tensor: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _is_shard(p, dim: Optional[int] = None) -> bool:
    return p.is_shard() and (dim is None or p.dim == dim)


def _call(fn, mesh, in_pl: Sequence, out_pl, *args):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_pl,
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _keep(pl, whole: Sequence[int]) -> List:
    """``pl`` with every placement that shards a dim in ``whole`` (or is
    partial) replicated."""
    _, Replicate, _ = _placements()
    return [p if p.is_shard() and p.dim not in whole else Replicate()
            for p in pl]


def rmsnorm(x, scale, *, eps: float, plus_one: bool = False):
    mesh = x.device_mesh
    _, Replicate, _ = _placements()
    pl = _keep(x.placements, (x.ndim - 1,))
    rep = [Replicate()] * mesh.ndim
    return _call(lambda xl, sl: K.rmsnorm(xl, sl, eps=eps,
                                          plus_one=plus_one),
                 mesh, (pl, rep), pl, x, as_dtensor(scale, mesh))


def mlp_in(x, w, w_up=None, bias=None, *, activation: str, gated: bool):
    """``act(x @ w_gate) * (x @ w_up)`` (``gated``) or ``act(x @ w + b)``
    over x (..., d) through the matmul kernels, on local shards."""
    mesh = x.device_mesh
    _, Replicate, Shard = _placements()
    out_dim = x.ndim - 1
    w_pl, x_pl, o_pl = [], [], []
    for wp, xp in zip(w.placements, x.placements):
        if _is_shard(wp, w.ndim - 1):        # output (ff) dim sharded
            w_pl.append(Shard(w.ndim - 1))
            x_pl.append(Replicate())
            o_pl.append(Shard(out_dim))
        else:                                # FSDP input dim gathered
            w_pl.append(Replicate())
            keep = xp.is_shard() and xp.dim < out_dim
            x_pl.append(xp if keep else Replicate())
            o_pl.append(xp if keep else Replicate())
    b_pl = [Shard(0) if p.is_shard() else Replicate() for p in w_pl]

    def fn(xl, wl, ul, bl):
        x2 = xl.reshape(-1, xl.shape[-1])
        if gated:
            h = K.gated_matmul(x2, wl, ul, activation=activation)
        else:
            h = K.matmul(x2, wl, bl, activation=activation)
        return h.reshape(*xl.shape[:-1], h.shape[-1])

    return _call(fn, mesh, (x_pl, w_pl, w_pl if gated else None,
                            b_pl if bias is not None else None), o_pl,
                 x, w, w_up if gated else None,
                 as_dtensor(bias, mesh) if bias is not None else None)


def _coord(mesh, dims: Sequence[int]) -> int:
    """This rank's index along the mesh dims ``dims`` taken together (the
    first one major)."""
    c = 0
    for i in dims:
        c = c * mesh.size(i) + mesh.get_local_rank(i)
    return c


def _head_plan(q, k, *, seq_dim: int, shard_seq: bool):
    """Per mesh dim: q's and k's placements for an attention kernel over
    q (B, Hq, ...) and k (B, Hkv, ...), the mesh dims on which a rank
    takes the kv heads of its own q heads (``sliced``) and those that
    shard k's sequence (``seq``, kept only with ``shard_seq``)."""
    _, Replicate, Shard = _placements()
    hq, hkv = q.shape[1], k.shape[1]
    mesh = k.device_mesh
    q_pl, k_pl, sliced, seq = [], [], [], []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if _is_shard(kp, 0) or _is_shard(qp, 0):
            q_pl.append(Shard(0))
            k_pl.append(Shard(0))
        elif _is_shard(kp, 1):
            q_pl.append(Shard(1))
            k_pl.append(Shard(1))
        elif _is_shard(kp, seq_dim) and shard_seq:
            q_pl.append(Replicate())
            k_pl.append(Shard(seq_dim))
            seq.append(i)
        else:
            n = mesh.size(i)
            hq_l, g = hq // n, hq // hkv
            ok = _is_shard(qp, 1) and hq % n == 0 \
                and (hq_l % g == 0 or g % hq_l == 0)
            q_pl.append(Shard(1) if ok else Replicate())
            k_pl.append(Replicate())
            if ok:
                sliced.append(i)
    return q_pl, k_pl, sliced, seq


def _kv_heads_of(t, mesh, sliced, hq: int, hkv: int):
    """The kv heads (dim 1) of ``t``, a local shard holding them all, that
    this rank's q heads read: q heads [c hq_l, (c+1) hq_l) of group size
    g = hq / hkv."""
    if not sliced or t is None:
        return t
    n = 1
    for i in sliced:
        n *= mesh.size(i)
    hq_l, g = hq // n, hq // hkv
    h0 = _coord(mesh, sliced) * hq_l
    return t[:, h0 // g: h0 // g + max(hq_l // g, 1)]


def _combine(o, lse, group):
    """Merge per-rank attention over disjoint keys: o (B, H, D) and its
    log-sum-exp (B, H) -> the result over every rank's keys and its
    log-sum-exp."""
    import torch.distributed._functional_collectives as funcol
    m = funcol.all_reduce(lse, "max", group)
    w = torch.where(torch.isinf(lse), torch.zeros_like(lse),
                    torch.exp(lse - torch.where(torch.isinf(m),
                                                torch.zeros_like(m), m)))
    num = funcol.all_reduce(o.float() * w[..., None], "sum", group)
    den = funcol.all_reduce(w, "sum", group)
    out = num / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    lse_all = torch.where(den == 0, torch.full_like(m, float("-inf")),
                          m + torch.log(torch.where(den == 0,
                                                    torch.ones_like(den),
                                                    den)))
    return out.to(o.dtype), lse_all


def decode_attention(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                     softcap=None):
    """q (B, Hq, D); k/v (B, Hkv, T, D) ``DTensor``s; kv_len (B,) int32;
    -> (B, Hq, D) like q's batch and head placements."""
    mesh = k.device_mesh
    _, Replicate, Shard = _placements()
    hq, hkv = q.shape[1], k.shape[1]
    q_pl, k_pl, sliced, seq = _head_plan(q, k, seq_dim=2, shard_seq=True)
    len_pl = [Shard(0) if _is_shard(p, 0) else Replicate() for p in k_pl]
    s_pl = [Shard(p.dim) if p.is_shard() else Replicate() for p in k_pl]
    q8 = k_scale is not None

    def fn(ql, kl, vl, ll, ksl, vsl):
        kl, vl, ksl, vsl = (_kv_heads_of(t, mesh, sliced, hq, hkv)
                            for t in (kl, vl, ksl, vsl))
        if not seq:
            return K.decode_attention(ql, kl, vl, ll, k_scale=ksl,
                                      v_scale=vsl, softcap=softcap)
        t_l = kl.shape[2]
        off = _coord(mesh, seq) * t_l
        lens = (ll.long() - off).clamp(0, t_l).to(torch.int32)
        o, lse = K.decode_attention(ql, kl, vl, lens, k_scale=ksl,
                                    v_scale=vsl, softcap=softcap,
                                    return_lse=True)
        for i in seq:
            o, lse = _combine(o, lse, mesh.get_group(i))
        return o

    return _call(fn, mesh, (q_pl, k_pl, k_pl, len_pl,
                            s_pl if q8 else None, s_pl if q8 else None),
                 q_pl, q, k, v, as_dtensor(kv_len, mesh), k_scale, v_scale)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None):
    """q (B, Hq, S, D); k/v (B, Hkv, Skv, D) ``DTensor``s -> (B, Hq, S, D)
    with the sequence whole on every rank."""
    mesh = k.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    q_pl, k_pl, sliced, _ = _head_plan(q, k, seq_dim=2, shard_seq=False)

    def fn(ql, kl, vl):
        kl, vl = (_kv_heads_of(t, mesh, sliced, hq, hkv) for t in (kl, vl))
        return K.flash_attention(ql, kl, vl, causal=causal, window=window,
                                 softcap=softcap)

    return _call(fn, mesh, (q_pl, k_pl, k_pl), q_pl, q, k, v)


def ssd_chunk(x, dt, a, b, c, *, chunk: int):
    """The intra-chunk SSD over x (B, L, H, P) with the sequence whole and
    the heads as x has them; b / c (B, L, H, N) follow x's heads."""
    mesh = x.device_mesh
    _, Replicate, Shard = _placements()
    x_pl = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
            for p in x.placements]
    dt_pl = x_pl
    a_pl = [Shard(0) if _is_shard(p, 2) else Replicate() for p in x_pl]
    st_pl = [p if _is_shard(p, 0) else Shard(2) if p.is_shard()
             else Replicate() for p in x_pl]
    return _call(lambda *t: K.ssd_chunk(*t, chunk=chunk), mesh,
                 (x_pl, dt_pl, a_pl, x_pl, x_pl), (x_pl, st_pl, dt_pl),
                 x, dt, as_dtensor(a, mesh), b, c)


def update_kv(buf, new, cur_len, dim: int):
    """Write ``new`` (B, s, H, ...) into the cache ``buf`` (a ``DTensor``:
    (B, T, ...) with ``dim`` 1, (B, H, T, ...) with ``dim`` 2) at the
    scalar ``cur_len``, in place, each rank writing the positions its
    shard holds (a cache sharded along T keeps each position on one
    rank).  A decode write reads nothing on the host; a longer one reads
    ``cur_len`` (0 on the meta device, the dry-run's empty cache)."""
    mesh = buf.device_mesh
    _, Replicate, Shard = _placements()
    if cur_len.dim() != 0:
        raise NotImplementedError("a sharded cache takes a scalar length")
    to_new = (lambda d: d) if dim == 1 else \
        (lambda d: {1: 2, 2: 1}.get(d, d))
    b_pl = list(buf.placements)
    n_pl = [Shard(to_new(p.dim)) if p.is_shard() and p.dim != dim
            else Replicate() for p in b_pl]
    t_dims = [i for i, p in enumerate(b_pl) if _is_shard(p, dim)]
    s = new.shape[1]
    start = None
    if s > 1:
        start = 0 if cur_len.device.type == "meta" else int(
            cur_len.full_tensor() if hasattr(cur_len, "full_tensor")
            else cur_len)

    def fn(bl, nl, cl):
        t_l = bl.shape[dim]
        off = _coord(mesh, t_dims) * t_l
        src = nl.to(bl.dtype)
        if dim == 2:
            src = src.transpose(1, 2)
        if s == 1:
            pos = cl.long() - off
            keep = (pos >= 0) & (pos < t_l)
            pc = pos.clamp(0, t_l - 1).reshape(1)
            old = bl.index_select(dim, pc)
            bl.index_copy_(dim, pc, torch.where(keep, src, old))
            return bl
        lo, hi = max(0, start - off), min(t_l, start - off + s)
        if hi > lo:
            bl.narrow(dim, lo, hi - lo).copy_(
                src.narrow(dim, lo - (start - off), hi - lo))
        return bl

    rep = [Replicate()] * mesh.ndim
    return _call(fn, mesh, (b_pl, n_pl, rep), b_pl, buf,
                 as_dtensor(new, mesh), as_dtensor(cur_len, mesh))


def split_last(t, shape: Sequence[int]):
    """``t.reshape(*t.shape[:-1], *shape)``; a ``DTensor`` whose last dim
    is split over more ranks than ``shape[0]`` divides (a sub-head
    sharding) is gathered along it first."""
    if is_dtensor(t):
        last = t.ndim - 1
        n = 1
        for i, p in enumerate(t.placements):
            if _is_shard(p, last):
                n *= t.device_mesh.size(i)
        if shape[0] % n:
            t = t.redistribute(t.device_mesh, _keep(t.placements, (last,)))
        return _grad_guard(t.reshape(*t.shape[:-1], *shape), shape[0])
    return t.reshape(*t.shape[:-1], *shape)


def _grad_guard(t, heads: int):
    """``t`` unchanged, with a redistribute to its own placements that
    brings its gradient back to them: a gradient split unevenly over a
    dim of ``heads`` would otherwise meet the reshape that made ``t``."""
    if all(heads % t.device_mesh.size(i) == 0
           for i in range(t.device_mesh.ndim)):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def matmul(x, w):
    """``x @ w`` for x (..., d): a ``DTensor`` x whose leading dims no
    placement splits past the first is folded to 2-D first, so the
    product runs as one matmul of the local rows (the unfolded form can
    broadcast the weight over the batch)."""
    if is_dtensor(x) and x.ndim > 2 and all(
            not p.is_shard() or p.dim in (0, x.ndim - 1)
            for p in x.placements):
        y = x.reshape(-1, x.shape[-1]) @ w
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ w


def merge_last(t):
    """``t.reshape(*t.shape[:-2], -1)``; a ``DTensor`` whose second-to-last
    dim is split unevenly, or that is a partial sum, is gathered (summed)
    along it first."""
    if is_dtensor(t):
        dim = t.ndim - 2
        uneven = any(p.is_partial() or (_is_shard(p, dim) and t.shape[dim]
                                        % t.device_mesh.size(i))
                     for i, p in enumerate(t.placements))
        if uneven:
            t = t.redistribute(t.device_mesh, _keep(t.placements, (dim,)))
        return _grad_guard(t.reshape(*t.shape[:-2], t.shape[-2]
                                     * t.shape[-1]), t.shape[dim])
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
