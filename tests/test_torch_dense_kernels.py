"""The plain versions of the dense-cache kernels against the JAX package's
Pallas kernels, called directly in interpret mode (as the JAX kernel
tests run them on the CPU): flash-decode over a dense cache (fp32 and
int8, GQA, softcap, ragged ``kv_len``), flash attention (causal or not,
window, softcap) and RMSNorm (with and without ``plus_one``).  Inputs
come from numpy with a seed and go to both sides.

Tolerances: 2e-5 in fp32 and 2e-4 for int8 caches (fp32 arithmetic on
both sides, different summation orders); in bf16, element by element,
the ``ref.*_limit`` bounds: one bf16 step of the output, plus, for a bf16
cache, the most that rounding p to bf16 before the PV product can move
it (the Pallas kernels round p, the plain versions do not).  The CPU route of
``ops`` is the plain version and counts no launch; the CUDA wrappers
raise on CPU tensors instead of falling back.  Controls: the flash limit
rejects scores rounded to bf16 before the softmax, the fp32 attention
limits q and k rounded to TF32 (while an emulation of 3xTF32 products,
a tensor-core design measured for the fp32 route, stays within the
flash limit), and the RMSNorm bit check
(``ref.unequal_share``) three faults that stay within one bf16 step.
The bf16 gated MLP above 48 rows runs on wgmma: an emulation of its
order of sums (16-deep k steps into fp32 accumulators, one cast) lies
within ``ref.gated_matmul_limit`` of the plain version and of the Pallas
kernel, at K 18432 folded every 512 of K or not (the two-weight kernel's
unfolded order; both distances are printed).  The bf16 ``matmul`` routes (the folded
wgmma kernel, the split-K decode stream with its fixed-order reduction
over a cluster's ranks) are emulated the same way and held within
``ref.matmul_limit`` at K 768 and 18432 and against the Pallas kernel.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import flash_attention as jfa
from repro.kernels import hete_matmul as jhm
from repro.kernels import rmsnorm as jrn
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L

F32 = dict(rtol=2e-5, atol=2e-5)
Q8 = dict(rtol=2e-4, atol=2e-4)


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    if x is None:
        return None
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _cache(rng, b, hkv, s, d, q8):
    if q8:
        k = rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((b, hkv, s))) * 0.01
              ).astype(np.float32)
        vs = (np.abs(rng.standard_normal((b, hkv, s))) * 0.01
              ).astype(np.float32)
        return k, v, ks, vs
    return (rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            None, None)


@pytest.mark.parametrize("hq,hkv,softcap,q8", [
    (4, 2, None, False), (4, 2, 20.0, False), (4, 4, None, True),
    (8, 2, 30.0, True)])
def test_decode_attention_matches_pallas(hq, hkv, softcap, q8):
    rng = np.random.default_rng(hq * 10 + hkv + int(q8))
    b, s, d = 3, 32, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, hkv, s, d, q8)
    lens = np.asarray([1, 13, s], np.int32)               # ragged
    want = jdec.decode_attention(_j(q), _j(k), _j(v), _j(lens),
                                 k_scale=_j(ks), v_scale=_j(vs),
                                 softcap=softcap, interpret=True)
    got = R.decode_attention(_t(q), _t(k), _t(v), _t(lens), k_scale=_t(ks),
                             v_scale=_t(vs), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(Q8 if q8 else F32))


def test_decode_attention_ignores_nan_past_len_and_reads_strides():
    """Rows at or past kv_len hold NaN: the plain version's result does not
    change (the Pallas kernel's does, as 0 * NaN).  The backend cache's
    (B, T, Hkv, D) buffer seen through transpose(1, 2) gives the same
    result as the contiguous (B, Hkv, T, D) cache."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 2, 4, 2, 24, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v, _, _ = _cache(rng, b, hkv, s, d, False)
    lens = np.asarray([7, 19], np.int32)
    want = jdec.decode_attention(_j(q), _j(k), _j(v), _j(lens),
                                 interpret=True)
    k2, v2 = k.copy(), v.copy()
    for i in range(b):
        k2[i, :, lens[i]:] = np.nan
        v2[i, :, lens[i]:] = np.nan
    got = R.decode_attention(_t(q), _t(k2), _t(v2), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    bthd = _t(k2.transpose(0, 2, 1, 3)).transpose(1, 2)
    vthd = _t(v2.transpose(0, 2, 1, 3)).transpose(1, 2)
    assert not bthd.is_contiguous()
    again = K.decode_attention(_t(q), bthd, vthd, _t(lens))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 8, None), (True, None, 20.0),
    (False, None, None), (False, 8, 30.0)])
def test_flash_attention_matches_pallas(causal, window, softcap):
    rng = np.random.default_rng(int(causal) * 7 + (window or 0))
    b, hq, hkv, s, d = 2, 4, 2, 32, 16
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    want = jfa.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                               window=window, softcap=softcap, block_q=16,
                               block_kv=16, interpret=True)
    got = R.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                            window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_ragged_equals_layer_attention(window):
    """A ragged prompt (no block divides 13) over the first s positions of
    a longer cache buffer: the plain version equals the model's masked
    attention over the whole buffer with kv_len = s."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s, t, d = 2, 4, 2, 13, 20, 8
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    kb = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vb = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    pos = torch.arange(s)[None].expand(b, s)
    want = L.attention(_t(q), _t(kb), _t(vb), q_positions=pos,
                       kv_positions=torch.arange(t)[None], kv_len=s,
                       causal=True, window=window, kv_format="bthd")
    kh = _t(kb).transpose(1, 2)[:, :, :s]
    vh = _t(vb).transpose(1, 2)[:, :, :s]
    got = K.flash_attention(_t(q).transpose(1, 2), kh, vh, causal=True,
                            window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_pallas(plus_one):
    rng = np.random.default_rng(int(plus_one))
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jrn.rmsnorm(_j(x), _j(w), eps=1e-5, plus_one=plus_one,
                       interpret=True)
    got = R.rmsnorm(_t(x), _t(w), eps=1e-5, plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _within(kernel_out, limit, plain_out):
    err = (torch.from_numpy(np.array(kernel_out.astype(jnp.float32)))
           - plain_out.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def test_bf16_cases_match_pallas():
    """One bf16 case of each kernel, within the per-element limits."""
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    b, hq, hkv, s, d = 2, 4, 2, 32, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v, _, _ = _cache(rng, b, hkv, s, d, False)
    lens = np.asarray([9, 32], np.int32)
    want = jdec.decode_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                 _j(v, jnp.bfloat16), _j(lens),
                                 interpret=True)
    args = (_t(q, bf), _t(k, bf), _t(v, bf), _t(lens))
    got = R.decode_attention(*args)
    assert got.dtype == bf
    _within(want, R.decode_attention_limit(*args, got), got)

    qs = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    want = jfa.flash_attention(_j(qs, jnp.bfloat16), _j(k, jnp.bfloat16),
                               _j(v, jnp.bfloat16), window=12, block_q=16,
                               block_kv=16, interpret=True)
    args = (_t(qs, bf), _t(k, bf), _t(v, bf))
    got = R.flash_attention(*args, window=12)
    _within(want, R.flash_attention_limit(*args, got, window=12), got)

    x = rng.standard_normal((6, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    want = jrn.rmsnorm(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16),
                       interpret=True)
    got = R.rmsnorm(_t(x, bf), _t(w, bf))
    _within(want, R.rmsnorm_limit(got), got)


def test_ops_cpu_route_counts_nothing():
    """CPU tensors run the plain versions and count no launch; the
    plain-path counter counts only CUDA tensors."""
    rng = np.random.default_rng(4)
    K.reset_launch_counts()
    q = _t(rng.standard_normal((2, 4, 8)).astype(np.float32))
    k = _t(rng.standard_normal((2, 2, 6, 8)).astype(np.float32))
    lens = torch.tensor([3, 6], dtype=torch.int32)
    np.testing.assert_array_equal(
        K.decode_attention(q, k, k, lens).numpy(),
        R.decode_attention(q, k, k, lens).numpy())
    qs = _t(rng.standard_normal((2, 4, 6, 8)).astype(np.float32))
    np.testing.assert_array_equal(K.flash_attention(qs, k, k).numpy(),
                                  R.flash_attention(qs, k, k).numpy())
    x = _t(rng.standard_normal((3, 8)).astype(np.float32))
    np.testing.assert_array_equal(K.rmsnorm(x, torch.ones(8)).numpy(),
                                  R.rmsnorm(x, torch.ones(8)).numpy())
    K.count_plain("plain_dense_attention", qs)
    assert not any(K.launch_counts().values())


def test_dense_wrappers_reject_cpu_tensors():
    """A wrapper never falls back: handed CPU tensors it raises."""
    from repro_torch.kernels import decode_attention, flash_attention, \
        rmsnorm
    q = torch.zeros((1, 2, 8))
    k = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError):
        decode_attention.decode_attention(q, k, k,
                                          torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(k, k, k)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(q, torch.ones(8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_limits_reject_an_off_by_one(dtype):
    """The per-element limits are tight enough to fail a kernel with an
    off-by-one mask: decode that drops the last key, flash attention that
    drops the diagonal.  The bf16 cache's bound on rounding p is the
    loosest term; it still rejects both at the main path's sequence
    lengths' order (here 200 keys)."""
    rng = np.random.default_rng(7)
    b, hq, hkv, t, d = 2, 8, 2, 200, 64
    q = _t(rng.standard_normal((b, hq, d)).astype(np.float32), dtype)
    k, v, _, _ = (_t(a, dtype) if a is not None else None
                  for a in _cache(rng, b, hkv, t, d, False))
    lens = torch.tensor([t - 3, t], dtype=torch.int32)
    want = R.decode_attention(q, k, v, lens)
    lim = R.decode_attention_limit(q, k, v, lens, want)
    bad = R.decode_attention(q, k, v, lens - 1)
    assert bool(((bad.float() - want.float()).abs() > lim).any())

    qs = _t(rng.standard_normal((b, hq, t, d)).astype(np.float32), dtype)
    want = R.flash_attention(qs, k, v)
    lim = R.flash_attention_limit(qs, k, v, want)
    bad = want.clone()
    bad[:, :, 1:] = R.flash_attention(qs[:, :, 1:], k[:, :, :-1],
                                      v[:, :, :-1])
    assert bool(((bad.float() - want.float()).abs() > lim).any())


def _flash_scores_bf16(q, k, v):
    """The plain causal flash attention with one fault, the one a
    tensor-core kernel invites: each score q . k rounded to bf16 before
    the scale and the softmax."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    s = s.to(torch.bfloat16).float() / math.sqrt(d)
    ok = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
    p = torch.softmax(torch.where(ok, s, R.NEG_INF), dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def test_flash_limit_rejects_bf16_scores():
    """``flash_attention_limit`` rejects scores rounded to bf16 before the
    softmax at B 2, Hq 8, Hkv 2, S 512, D 128, causal, bf16, though in few
    elements (the share is printed)."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    b, hq, hkv, s, d = 2, 8, 2, 512, 128
    q = _t(rng.standard_normal((b, hq, s, d)).astype(np.float32), bf)
    k = _t(rng.standard_normal((b, hkv, s, d)).astype(np.float32), bf)
    v = _t(rng.standard_normal((b, hkv, s, d)).astype(np.float32), bf)
    want = R.flash_attention(q, k, v)
    lim = R.flash_attention_limit(q, k, v, want)
    beyond = (_flash_scores_bf16(q, k, v).float() - want.float()).abs() > lim
    print(f"bf16 scores: {float(beyond.float().mean()):.2e} of elements "
          f"beyond the limit")
    assert bool(beyond.any())


def _tf32(t):
    """t with the low 13 bits of each fp32 mantissa cleared: TF32's 10."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("kind", ["flash", "paged_prefill"])
def test_fp32_attention_limits_reject_tf32(kind):
    """The fp32 attention limits reject attention whose q and k were
    rounded to TF32 (what a TF32 tensor-core route would compute): at D 128
    over 71 keys (cell 3's longest chunk) some element of the plain version
    over TF32 operands lies beyond ``flash_attention_limit`` and
    ``paged_prefill_attention_limit`` (the share is printed)."""
    rng = np.random.default_rng(21)
    b, hq, hkv, d, s, ps = 2, 4, 2, 128, 32, 16
    q = torch.from_numpy(rng.standard_normal((b, hq, s, d))
                         .astype(np.float32))
    if kind == "flash":
        t = 71
        k, v = (torch.from_numpy(rng.standard_normal((b, hkv, t, d))
                                 .astype(np.float32)) for _ in range(2))
        q = torch.from_numpy(rng.standard_normal((b, hq, t, d))
                             .astype(np.float32))
        want = R.flash_attention(q, k, v)
        lim = R.flash_attention_limit(q, k, v, want)
        bad = R.flash_attention(_tf32(q), _tf32(k), v)
    else:
        nb = 5
        kp, vp = (torch.from_numpy(rng.standard_normal((1 + b * nb, hkv, ps,
                                                         d))
                                   .astype(np.float32)) for _ in range(2))
        bt = torch.from_numpy((rng.permutation(b * nb) + 1)
                              .reshape(b, nb).astype(np.int32))
        off = torch.tensor([0, 71 - s], dtype=torch.int32)
        want = R.paged_prefill_attention(q, kp, vp, bt, off)
        lim = R.paged_prefill_attention_limit(q, kp, vp, bt, off, want)
        bad = R.paged_prefill_attention(_tf32(q), _tf32(kp), vp, bt, off)
    beyond = (bad - want).abs() > lim
    print(f"{kind}, q and k in TF32: {float(beyond.float().mean()):.3g} of "
          f"elements beyond the limit")
    assert bool(beyond.any())


def _tf32_rna(t):
    """fp32 t rounded to TF32 (to nearest, ties away from zero), as the
    kernel rounds it: + 2^12 on the bit pattern, low 13 bits cleared."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(t):
    big = _tf32_rna(t)
    return big, _tf32_rna(t - big)


def _rz(v):
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _flash_3xtf32(q, k, v, *, causal=True, window=None, softcap=None):
    """fp32 flash attention with the products of the 3xTF32 tensor-core
    design (``tools/flash_f32_3xtf32.cu``, measured beside the port's
    CUDA-core kernel), emulated: every operand split into a TF32
    big and small term; per k step of 8 the exact products added to fp32
    accumulators rounded toward zero (a pessimistic model of mma.sync),
    S's cross terms in one and big * big in another, added at the end; P
    V's three products small * big, big * small, big * big in one per
    8 keys; the softmax in fp32 and base 2 with p = 0 for masked pairs and
    the division by l last.  (The kernel's online rescaling between key
    tiles, an fp32 reordering, is left out.)"""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf, vf = (t.repeat_interleave(g, dim=1) for t in (k, v))
    skv = kf.shape[2]
    (qb, qs), (kb, ks), (vb, vs) = (_split_tf32(t) for t in (q, kf, vf))
    sb = sx = torch.zeros((b, hq, sq, skv))
    for c in range(0, d, 8):
        dd = slice(c, c + 8)

        def prod(x, y):
            return torch.einsum("bhqd,bhkd->bhqk", x[..., dd].double(),
                                y[..., dd].double())
        sx = _rz(sx.double() + prod(qs, kb))
        sx = _rz(sx.double() + prod(qb, ks))
        sb = _rz(sb.double() + prod(qb, kb))
    s = sb + sx
    log2e = 1.4426950408889634
    x = s * (log2e / math.sqrt(d))
    if softcap is not None:
        x = softcap * torch.tanh(s / math.sqrt(d) / softcap) * log2e
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    x = torch.where(ok, x, R.NEG_INF)
    m = x.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp2(x - m), 0.0)
    l = p.sum(-1, keepdim=True)
    pb, ps = _split_tf32(p)
    o = torch.zeros((b, hq, sq, d))
    for c in range(0, skv, 8):
        kk = slice(c, c + 8)
        for x1, y1 in ((ps, vb), (pb, vs), (pb, vb)):
            o = _rz(o.double() + torch.einsum(
                "bhqk,bhkd->bhqd", x1[..., kk].double(), y1[:, :, kk].double()))
    return o / torch.where(l == 0, 1.0, l)


@pytest.mark.parametrize("d,s,causal,window,softcap", [
    (128, 64, True, None, None), (128, 64, True, 16, None),
    (128, 64, True, None, 30.0), (16, 64, True, 9, 20.0),
    (16, 40, False, None, None)])
def test_flash_3xtf32_emulation_within_limit(d, s, causal, window, softcap):
    """An emulation of the 3xTF32 design's arithmetic (``_flash_3xtf32``)
    lies within ``ref.flash_attention_limit``, so a tensor-core fp32 route
    need not be plain fp32 to pass it: causal,
    windowed and softcapped at OPT's head dim 128 over 64 keys, and at D
    16 (the worst share of the limit is printed; the one-term TF32 control
    above lies beyond the same limit)."""
    rng = np.random.default_rng(d + s + (window or 0))
    b, hq, hkv = 2, 8, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = R.flash_attention(q, k, v, **kw)
    lim = R.flash_attention_limit(q, k, v, want, **kw)
    worst = float(((_flash_3xtf32(q, k, v, **kw) - want).abs() / lim).max())
    print(f"3xTF32 at D {d}: {worst:.3f} of the limit at worst")
    assert worst < 1.0


def _rms_faults(x, w, eps):
    """Plain RMSNorms with one fault each (all within one bf16 step of the
    plain version, so within ``rmsnorm_limit``), and one sound reordering
    of the fp32 sum (per-lane partial sums of 32 lanes, then their
    total), as the kernel sums."""
    xf, wf = x.float(), w.float()
    d = x.shape[-1]

    def norm(var, y=None):
        y = xf * torch.rsqrt(var + eps) if y is None else y
        return (y * wf).to(x.dtype)

    sq = xf * xf
    return {
        "squares_bf16": norm(sq.to(x.dtype).float().mean(-1, keepdim=True)),
        "normalised_bf16": norm(None, (xf * torch.rsqrt(
            sq.mean(-1, keepdim=True) + eps)).to(x.dtype).float()),
        "mean_over_d_minus_1": norm(sq.sum(-1, keepdim=True) / (d - 1)),
        "lane_sums": norm(sq.reshape(-1, d // 32, 32).sum(1)
                          .sum(-1, keepdim=True) * (1.0 / d)),
    }


@pytest.mark.parametrize("variant,sound", [
    ("squares_bf16", False), ("normalised_bf16", False),
    ("mean_over_d_minus_1", False), ("lane_sums", True)])
def test_rmsnorm_bit_check_rejects_faults(variant, sound):
    """At 2048 x 5120 bf16 each fault stays within ``rmsnorm_limit`` (one
    bf16 step) but differs from the plain version in more than
    ``RMSNORM_UNEQUAL_MAX`` of its elements; a sound fp32 reordering
    differs in far fewer."""
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    x = _t(rng.standard_normal((2048, 5120)).astype(np.float32), bf)
    w = _t(rng.standard_normal(5120).astype(np.float32), bf)
    want = R.rmsnorm(x, w, eps=1e-5)
    got = _rms_faults(x, w, 1e-5)[variant]
    assert bool(((got.float() - want.float()).abs()
                 <= R.rmsnorm_limit(want)).all())
    share = R.unequal_share(got, want)
    print(f"{variant}: {share:.2e} of elements not bit-equal")
    assert (share <= R.RMSNORM_UNEQUAL_MAX) == sound


# ---------------------------------------------------------------------------
# gated_matmul above 48 rows: the wgmma kernel's order of sums
# ---------------------------------------------------------------------------


_ACTS = [None, "relu", "relu2", "gelu", "silu"]


def _rz32_t(v):
    """float64 tensor -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


PROMOTE_K = 512    # csrc/hete_matmul.cu's kPromoteK


def _tc_sums(x, w, runs, fold=PROMOTE_K):
    """fp32 totals of x @ w as the bf16 tensor-core kernels of
    ``csrc/hete_matmul.cu`` sum them: over each run (k0, k1) of K, an
    accumulator takes the exact products of one 16-deep k step at a time,
    each addition rounded toward zero (a pessimistic model of the tensor
    cores' fp32 accumulate); every ``fold`` columns from the run's start
    and at its end the accumulator is added into the run's fp32 total with
    round-to-nearest (``fold=None``: never before the end, the two-weight
    wgmma kernel's order); the runs' totals are summed in
    order with round-to-nearest (the split-K decode route's fixed-order
    reduction over a cluster's ranks; one run everywhere else)."""
    xd, wd = x.double(), w.double()
    out = torch.zeros((x.shape[0], w.shape[1]))
    for k0, k1 in runs:
        acc = torch.zeros_like(out)
        tot = torch.zeros_like(out)
        for s0 in range(k0, k1, 16):
            s = slice(s0, min(s0 + 16, k1))
            acc = _rz32_t(acc.double() + xd[:, s] @ wd[s])
            if fold and (s0 + 16 - k0) % fold == 0:
                tot, acc = tot + acc, torch.zeros_like(acc)
        out = out + (tot + acc)
    return out


def _split_runs(k, n, ranks=None, sms=132):
    """The K runs of the decode route's cluster ranks: ``ranks`` of them,
    or as many as its launch picks (a power of two up to 8, each with
    two 64-deep k-tiles at least, until 256-column blocks x ranks reach
    8 blocks an SM)."""
    kt, nb = -(-k // 64), -(-n // 256)
    if ranks is None:
        ranks = 1
        while ranks < 8 and 2 * ranks <= kt and nb * ranks < 8 * sms:
            ranks *= 2
    return [(r * kt // ranks * 64, min((r + 1) * kt // ranks * 64, k))
            for r in range(ranks)]


def _matmul_tc_emulation(x, w, bias, activation, runs, fold=PROMOTE_K):
    """act(x @ w + bias) as the bf16 ``matmul`` kernels compute it: the
    sums of :func:`_tc_sums`, the bias added and the activation taken in
    fp32, one cast to x's dtype."""
    z = _tc_sums(x, w, runs, fold)
    if bias is not None:
        z = z + bias.float()
    return R._act(z, activation).to(x.dtype)


def _gated_wgmma_emulation(x, wg, wu, activation, fold=None):
    """act(x @ wg) * (x @ wu) as the M > 48 kernels of
    ``csrc/hete_matmul.cu`` sum it: each weight's sums by
    :func:`_tc_sums` over all of K, unfolded (the two-weight kernel's
    order) or folded every ``fold``; the activation and the gate in fp32;
    one cast to x's dtype."""
    runs = [(0, x.shape[1])]
    g = _tc_sums(x, wg, runs, fold)
    u = _tc_sums(x, wu, runs, fold)
    return (R._act(g, activation) * u).to(x.dtype)


def _bf16_case(rng, m, k, n, weights=1):
    x = _t(rng.standard_normal((m, k)).astype(np.float32), torch.bfloat16)
    ws = [_t((rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32),
             torch.bfloat16) for _ in range(weights)]
    return x, ws


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("m,k,n", [(130, 1000, 136), (64, 5120, 64)])
def test_gated_wgmma_emulation_within_limit(m, k, n, act):
    """bf16 operands at the model's scale (x ~ N(0, 1), weights ~ N(0,
    1/K)), K 5120 (Mistral-NeMo-12B's width) and a K that is no multiple
    of 64: the emulated order of the wgmma kernel's sums and its one cast
    lie within ``ref.gated_matmul_limit`` of the plain version."""
    rng = np.random.default_rng(m + k + n)
    x = _t(rng.standard_normal((m, k)).astype(np.float32), torch.bfloat16)
    wg, wu = (_t((rng.standard_normal((k, n)) / math.sqrt(k)).astype(
        np.float32), torch.bfloat16) for _ in range(2))
    got = _gated_wgmma_emulation(x, wg, wu, act)
    want = R.gated_matmul(x, wg, wu, activation=act)
    limit = R.gated_matmul_limit(x, wg, wu, want, activation=act)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def test_gated_wgmma_emulation_folds_at_long_k():
    """K 18432 (Nemotron-4's width): the order of sums folded every 512 of
    K lies within ``ref.gated_matmul_limit``, and so does the unfolded
    order of the two-weight kernel, whose distance is printed as a ratio
    to the limit beside the folded one's."""
    rng = np.random.default_rng(18432)
    x, (wg, wu) = _bf16_case(rng, 8, 18432, 64, weights=2)
    want = R.gated_matmul(x, wg, wu, activation="silu")
    limit = R.gated_matmul_limit(x, wg, wu, want, activation="silu")
    ratios = {}
    for fold in (PROMOTE_K, None):
        got = _gated_wgmma_emulation(x, wg, wu, "silu", fold=fold)
        ratios[fold] = float(((got.float() - want.float()).abs()
                              / limit).max())
    print(f"gated K 18432: worst error / limit folded every {PROMOTE_K} "
          f"{ratios[PROMOTE_K]:.3f}, unfolded {ratios[None]:.3f}")
    assert ratios[PROMOTE_K] <= 1.0 and ratios[None] <= 1.0


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("k,bias", [(768, True), (18432, False)])
@pytest.mark.parametrize("route", ["wgmma", "split", "split2"])
def test_matmul_tc_emulation_within_limit(route, k, bias, act):
    """bf16 operands at the model's scale, K 768 (Whisper-small's MLP, with
    bias) and K 18432 (Nemotron-4's, without): the emulated sums of the
    redesigned bf16 ``matmul`` routes (the wgmma kernel's one run of K,
    folded every 512; the split-K decode route's runs over the ranks its
    launch picks, 8 at narrow N, or 2, each folded from its own start and
    summed in rank order) and their one cast lie within
    ``ref.matmul_limit`` of the plain version."""
    rng = np.random.default_rng(k + len(route))
    m, n = 8, 64
    x, (w,) = _bf16_case(rng, m, k, n)
    b = _t(rng.standard_normal(n).astype(np.float32), torch.bfloat16) \
        if bias else None
    runs = {"wgmma": [(0, k)], "split": _split_runs(k, n),
            "split2": _split_runs(k, n, ranks=2)}[route]
    assert runs[0][0] == 0 and runs[-1][1] == k
    got = _matmul_tc_emulation(x, w, b, act, runs)
    want = R.matmul(x, w, b, activation=act)
    limit = R.matmul_limit(x, w, want, b, activation=act)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("route", ["wgmma", "split"])
def test_matmul_tc_emulation_matches_pallas(route, act):
    """fp32 operands (this CPU's XLA has no bf16 x bf16 -> fp32 dot): the
    emulated sums of both bf16 ``matmul`` routes, with bias, lie within
    ``ref.matmul_limit`` of the JAX package's Pallas ``matmul`` in
    interpret mode."""
    rng = np.random.default_rng(6)
    m, k, n = 128, 1024, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = torch.from_numpy(np.array(jhm.matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=act,
        interpret=True)))
    runs = [(0, k)] if route == "wgmma" else _split_runs(k, n)
    got = _matmul_tc_emulation(_t(x), _t(w), _t(b), act, runs)
    limit = R.matmul_limit(_t(x), _t(w), want, _t(b), activation=act)
    err = (got - want).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("act", _ACTS)
def test_gated_wgmma_emulation_matches_pallas(act):
    """fp32 operands (this CPU's XLA has no bf16 x bf16 -> fp32 dot): the
    emulated sums lie within ``ref.gated_matmul_limit`` of the JAX
    package's Pallas ``gated_matmul`` in interpret mode."""
    rng = np.random.default_rng(5)
    m, k, n = 128, 256, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    wg, wu = ((rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
              for _ in range(2))
    want = torch.from_numpy(np.array(jhm.gated_matmul(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), activation=act,
        interpret=True)))
    got = _gated_wgmma_emulation(_t(x), _t(wg), _t(wu), act)
    limit = R.gated_matmul_limit(_t(x), _t(wg), _t(wu), want, activation=act)
    err = (got - want).abs()
    assert bool((err <= limit).all()), float((err / limit).max())
