"""The two kernels split across a thread-block cluster, on the CPU: the
int8-weight matmul (``q8_matmul``; its M > 16 kernel on bf16 tensor
cores too) and flash-decode over a dense cache (``decode_attention``)
under a bf16 q.  No card here, so these hold what
surrounds the kernels: the plain versions against the JAX package's
Pallas kernels in interpret mode at the group sizes and head dims the
split kernel takes, the statistical limit ``ref.q8_matmul_limit`` (a
blocked fp32 sum passes it; the plain version over x rounded to bf16 or
kept to 16 significant bits does not), the tensor-core kernel's split
of x into three bf16 terms (exact) and an emulation of its sums (within
the limit, and beyond it with two terms), the wrappers' refusal of CPU
tensors before anything touches CUDA, and the decode wrapper's refusal of
a bf16 q at a shape the split kernel does not take.  The paged decode
under a bf16 q runs the same split kernel over block tables: an
emulation of its arithmetic (key ranges per cluster rank, 64-key tiles
gathered over any page size, the base-2 online softmax, p rounded to bf16
over bf16 pages, K's scale on the score and p * V's scale as hi and lo
bf16 terms over int8 pages, the warps' and ranks' merges) lies within
``ref.paged_decode_attention_limit`` of the plain version and of the
Pallas kernel, and the same with one bf16 term over int8 pages does not.
Under an fp32 q the same cluster layout runs on the CUDA cores: an
emulation of its fp32 arithmetic (32-key tiles, four warps of 8 keys,
the per-warp and per-rank merges in order) lies within the same limit of
the Pallas kernel and of the plain version over fp32 and int8 pages.
Inputs come from numpy with a seed and go to both sides.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import paged_attention as jpa
from repro.kernels import q8_matmul as jq8
from repro_torch.kernels import ref as R
from repro_torch.kernels.q8_matmul import quantize_weights_np


def _q8_operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q, s = quantize_weights_np(rng.standard_normal((k, n)).astype(np.float32))
    return x, q, s


def _beyond(got, want, limit):
    """The share of elements of ``got`` beyond ``limit`` of ``want``."""
    return float(((got.float() - want.float()).abs() > limit).float().mean())


def _bits16(x):
    """x kept to 16 significant bits (the low 8 of the fp32 mantissa
    rounded off), what a two-term bf16 split of x carries at most."""
    i = x.view(torch.int32)
    return ((i + 0x80) & ~0xFF).view(torch.float32)


def _split2(x):
    """x as a two-term bf16 split computes it: bf16(x) + bf16(x - bf16(x))."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("m,k,n", [(4, 4096, 320), (1, 1024, 200),
                                   (16, 16384, 64), (37, 512, 130)])
def test_q8_matmul_limit_passes_blocked_sums_and_rejects_short_x(m, k, n):
    """A blocked fp32 sum of the same products (sequential runs of 128
    terms, then the run sums in order, as the kernels sum) lies within
    ``ref.q8_matmul_limit``; the plain version over x rounded to bf16, kept
    to 16 significant bits, or split into two bf16 terms lies beyond it in
    some elements."""
    x, q, s = (torch.from_numpy(a) for a in _q8_operands(k + n, m, k, n))
    want = R.q8_matmul(x, q, s)
    limit = R.q8_matmul_limit(x, q, s, want)
    blocked = sum(x[:, i:i + 128] @ q[i:i + 128].float()
                  for i in range(0, k, 128)) * s
    assert float(((blocked - want).abs() / limit).max()) < 1.0
    for control in (x.to(torch.bfloat16).float(), _bits16(x), _split2(x)):
        assert _beyond(R.q8_matmul(control, q, s), want, limit) > 0


def _trunc16(x):
    """fp32 x truncated to bf16 (its top 16 bits), as an fp32 array."""
    return (x.view(np.int32) & np.int32(-65536)).view(np.float32)


def _split3(x):
    """fp32 x as the M > 16 kernel of ``csrc/q8_matmul.cu`` splits it: hi,
    x truncated to bf16; mid, the remainder truncated; lo, the rest."""
    hi = _trunc16(x)
    r = x - hi
    mid = _trunc16(r)
    return hi, mid, r - mid


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge"])
def test_three_term_bf16_split_is_exact(kind):
    """Each of the three terms is a bf16 value (its low 16 bits clear, and
    unchanged by a round trip through bf16) and the three add up to x
    exactly: for normal values over 40 decades, for tiny ones (2^-110 to
    2^-100, where lo is often subnormal; below 2^-110 x has bits under
    bf16's smallest subnormal, 2^-133) and for the largest ones, fp32's
    maximum included (truncation never rounds up into infinity)."""
    rng = np.random.default_rng(["normal", "tiny", "huge"].index(kind))
    n = 1 << 14
    sign = rng.choice([-1.0, 1.0], n)
    if kind == "normal":
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
    elif kind == "tiny":
        x = sign * rng.uniform(1, 2, n) * 2.0 ** rng.integers(-110, -100, n)
    else:
        x = sign * rng.uniform(1, 2, n) * 2.0 ** rng.integers(120, 128, n)
        x[:2] = (np.finfo(np.float32).max, -np.finfo(np.float32).max)
    x = x.astype(np.float32)
    terms = _split3(x)
    for t in terms:
        assert np.isfinite(t).all()
        assert not (t.view(np.int32) & 0xFFFF).any()
        back = torch.from_numpy(t).to(torch.bfloat16).float().numpy()
        assert np.array_equal(back, t)
    total = sum(t.astype(np.float64) for t in terms)
    assert np.array_equal(total, x.astype(np.float64))
    if kind == "tiny":
        lo = terms[2]
        assert ((lo != 0) & (np.abs(lo) < np.finfo(np.float32).tiny)).any()


def _rz32(v):
    """float64 -> float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _q8_tc_emulation(x, q, s, n_launch, terms=3, sms=132):
    """y as the M > 16 kernel sums it, in numpy: K split over the cluster
    size the launcher picks at N = ``n_launch`` on ``sms`` SMs, each
    block's stages of 64 k rows shared by four warps of 16 rows; a warp's
    k step adds the exact products of its 16 rows to an fp32 accumulator
    rounded toward zero (a pessimistic model of mma.sync's fp32
    accumulate), the hi terms in one accumulator and lo then mid in
    another; every 8 steps (128 of its rows) the two go, added, into the
    warp's fp32 total; the four warps' totals are added in order, then the
    blocks' in rank order, and the column scale applied once.  ``terms``
    2 drops lo: x kept to 16 significant bits."""
    m, k = x.shape
    hi, mid, lo = (t.astype(np.float64) for t in _split3(x))
    if terms == 2:
        lo = np.zeros_like(lo)
    base = -(-n_launch // 64) * -(-m // (24 if m <= 24 else 32))
    cs = 2 * sms // base
    if cs < 2:
        cs = -(-2 * sms // base)
    cs = max(1, min(cs, 8, k // 256))
    kper = -(-(-(-k // cs)) // 64) * 64
    w = q.astype(np.float64)
    zero = np.zeros((m, q.shape[1]), np.float32)
    y = zero
    for rank in range(cs):
        kb = min(k, rank * kper)
        ke = min(k, kb + kper)
        part = zero
        for ks in range(4):
            tot, ah, am = zero, zero, zero
            for i, k0 in enumerate(range(kb + 16 * ks, ke, 64)):
                rows = slice(k0, min(k0 + 16, ke))
                ah = _rz32(ah + hi[:, rows] @ w[rows])
                am = _rz32(am + lo[:, rows] @ w[rows])
                am = _rz32(am + mid[:, rows] @ w[rows])
                if i % 8 == 7:
                    tot, ah, am = tot + (ah + am), zero, zero
            part = part + (tot + (ah + am))
        y = y + part
    return y * s


@pytest.mark.parametrize("m", [18, 32])
@pytest.mark.parametrize("k,n_launch", [(4096, 2944), (4096, 11776),
                                        (16384, 2944)])
def test_q8_tensor_core_emulation_within_limit(m, k, n_launch):
    """An emulation of the M > 16 kernel's arithmetic (``_q8_tc_emulation``)
    at cell 3's prefill rows and (K, N) cluster splits, over 48 of the
    columns, lies within ``ref.q8_matmul_limit``; the same sum with x split
    into two bf16 terms (16 significant bits) lies beyond it in some
    elements (the shares are printed)."""
    x, q, s = _q8_operands(m * 3 + k + n_launch, m, k, 48)
    want = R.q8_matmul(*(torch.from_numpy(a) for a in (x, q, s)))
    limit = R.q8_matmul_limit(*(torch.from_numpy(a) for a in (x, q, s)),
                              want).numpy()
    err = np.abs(_q8_tc_emulation(x, q, s, n_launch) - want.numpy())
    worst = float((err / limit).max())
    two = np.abs(_q8_tc_emulation(x, q, s, n_launch, terms=2)
                 - want.numpy()) > limit
    print(f"M {m}, K {k}: three terms {worst:.3f} of the limit at worst; "
          f"two terms beyond it in {two.mean():.3f} of elements")
    assert worst < 1.0
    assert two.any()


@pytest.mark.parametrize("m,k,n", [(4, 256, 128), (16, 512, 64),
                                   (3, 128, 32)])
def test_q8_matmul_pallas_within_limit(m, k, n):
    """The Pallas kernel (interpret mode) is another fp32 computation of
    the same product: within ``ref.q8_matmul_limit`` of the plain
    version."""
    x, q, s = _q8_operands(m * 7 + n, m, k, n)
    want = R.q8_matmul(*(torch.from_numpy(a) for a in (x, q, s)))
    got = np.array(jq8.q8_matmul(jnp.asarray(x), jnp.asarray(q),
                                 jnp.asarray(s), block_m=m, block_n=n,
                                 block_k=128, interpret=True))
    limit = R.q8_matmul_limit(*(torch.from_numpy(a) for a in (x, q, s)),
                              want)
    assert _beyond(torch.from_numpy(got), want, limit) == 0


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 2, 128), (16, 2, 256),
                                      (8, 1, 64)])
def test_decode_attention_bf16_groups_match_pallas(hq, hkv, d):
    """The plain bf16 decode against the Pallas kernel at group sizes 1,
    4, 8 and head dims 64, 128, 256, over ragged ``kv_len``, within
    ``ref.decode_attention_limit``; rows of no key give 0, not NaN."""
    rng = np.random.default_rng(hq * 100 + hkv * 10 + d)
    b, t = 4, 64
    bf = torch.bfloat16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    lens = np.asarray([1, 17, 63, t], np.int32)
    want = jdec.decode_attention(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16),
                                 jnp.asarray(lens), block_kv=32,
                                 interpret=True)
    args = tuple(torch.from_numpy(a).to(bf) for a in (q, k, v)) \
        + (torch.from_numpy(lens),)
    got = R.decode_attention(*args)
    limit = R.decode_attention_limit(*args, got)
    err = (torch.from_numpy(np.array(want.astype(jnp.float32)))
           - got.float()).abs()
    assert bool((err <= limit).all())
    empty = R.decode_attention(*args[:3], torch.zeros(b, dtype=torch.int32))
    assert not bool(empty.isnan().any())


def _no_cuda(monkeypatch):
    """Make every CUDA query and kernel lookup fail loudly, so that a
    wrapper that reaches one before its checks shows it."""
    from repro_torch.kernels import build

    def boom(*a, **kw):
        raise AssertionError("touched CUDA before refusing a CPU tensor")

    for name in ("current_device", "get_device_properties", "device_count",
                 "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(build, "c_function", boom)
    monkeypatch.setattr(build, "launch", boom)


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (4, 4096, 64),
                                   (16, 32, 1001), (17, 64, 64)])
def test_q8_wrapper_refuses_cpu_tensors_first(monkeypatch, m, k, n):
    """Every route of the one C entry (the split kernel at M <= 16, the
    SGEMM above) is refused on CPU tensors with ``ValueError`` before any
    CUDA call."""
    from repro_torch.kernels import q8_matmul
    _no_cuda(monkeypatch)
    with pytest.raises(ValueError):
        q8_matmul.q8_matmul(torch.zeros((m, k)),
                            torch.zeros((k, n), dtype=torch.int8),
                            torch.ones(n))


@pytest.mark.parametrize("kv_dtype,hq,hkv,d", [
    (torch.bfloat16, 32, 8, 128), (torch.int8, 32, 8, 128),
    (torch.bfloat16, 8, 1, 256), (torch.int8, 4, 4, 64)])
def test_decode_wrapper_refuses_cpu_tensors_first(monkeypatch, kv_dtype, hq,
                                                   hkv, d):
    """A bf16 q over a bf16 or int8 cache (the split kernel's operands) on
    the CPU is refused with ``ValueError`` before any CUDA call."""
    from repro_torch.kernels import decode_attention
    _no_cuda(monkeypatch)
    b, t = 2, 40
    q = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    kv = torch.zeros((b, hkv, t, d), dtype=kv_dtype)
    kw = {}
    if kv_dtype == torch.int8:
        kw = dict(k_scale=torch.ones((b, hkv, t)),
                  v_scale=torch.ones((b, hkv, t)))
    with pytest.raises(ValueError):
        decode_attention.decode_attention(
            q, kv, kv, torch.full((b,), t, dtype=torch.int32), **kw)


def _padded(shape, dtype, pad, offset=0):
    """A zero tensor of ``shape`` whose last dim is a view into rows of
    ``shape[-1] + pad`` elements, starting ``offset`` elements in."""
    *lead, d = shape
    base = torch.zeros((*lead, d + pad), dtype=dtype)
    return base[..., offset:offset + d]


@pytest.mark.parametrize("case,ok", [
    ("bf16 d 128", True), ("int8 d 64", True), ("bthd layout", True),
    ("d 48", True), ("d 192", True), ("int8 d 80", True),
    ("d 8", False), ("d 72", False), ("d 320", False),
    ("q off 16 bytes", False),
    ("bf16 token stride 68", False), ("int8 token stride 72", False),
    ("v off 16 bytes", False)])
def test_decode_refuses_bf16_shapes_off_the_split_kernel(case, ok):
    """A bf16 q has one kernel, the split one: head dims in multiples of
    16 from 16 to 256 (192 is Nemotron-4's) with every base pointer and
    stride but the last a multiple of 16 bytes.  Anything else is refused
    with ``ValueError`` (on the card before the launch) rather than run by
    another kernel."""
    from repro_torch.kernels.decode_attention import check_bf16_operands
    b, hq, hkv, t = 2, 8, 2, 40
    d = {"d 48": 48, "d 8": 8, "int8 d 64": 64, "d 192": 192,
         "int8 d 80": 80, "d 72": 72, "d 320": 320}.get(case, 128)
    kv_dt = torch.int8 if case.startswith("int8") else torch.bfloat16
    q = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    k = torch.zeros((b, hkv, t, d), dtype=kv_dt)
    v = torch.zeros((b, hkv, t, d), dtype=kv_dt)
    if case == "bthd layout":
        k = torch.zeros((b, t, hkv, d), dtype=kv_dt).transpose(1, 2)
        v = torch.zeros((b, t, hkv, d), dtype=kv_dt).transpose(1, 2)
    elif case == "q off 16 bytes":
        q = _padded((b, hq, d), torch.bfloat16, 8, offset=4)
    elif case.endswith("token stride 68") or case.endswith("stride 72"):
        pad = 68 - 64 if kv_dt == torch.bfloat16 else 72 - 64
        k = _padded((b, hkv, t, 64), kv_dt, pad)
        v = _padded((b, hkv, t, 64), kv_dt, pad)
        q = torch.zeros((b, hq, 64), dtype=torch.bfloat16)
    elif case == "v off 16 bytes":
        v = torch.zeros(b * hkv * t * d + 4, dtype=kv_dt)[4:].view(
            b, hkv, t, d)
    if ok:
        check_bf16_operands(q, k, v)
    else:
        with pytest.raises(ValueError):
            check_bf16_operands(q, k, v)


# ---------------------------------------------------------------------------
# paged decode under a bf16 q: the split-KV cluster kernel over page tables
# ---------------------------------------------------------------------------


_LOG2E = 1.4426950408889634
_NEG = -1.0e30


def _bf(x):
    """fp32 ``x`` rounded to bf16 and back."""
    return x.to(torch.bfloat16).float()


def _cluster_size(b, hq, hkv, capacity, sms=132):
    """The cluster size ``split_decode::launch`` picks: about one block an
    SM over b * hkv * groups clusters, at most 8, a 64-key tile a block."""
    rows = b * hkv * -(-(hq // hkv) // 16)
    return max(1, min(8, -(-sms // rows), max(1, -(-capacity // 64))))


def _merge(states):
    """(m, l, o) states merged in order, as the kernel merges warps and
    then ranks: weights exp2(m - max), 0 where l is 0."""
    mm = torch.stack([m for m, _, _ in states]).max(0).values
    ll = torch.zeros_like(mm)
    oo = torch.zeros_like(states[0][2])
    for m, l, o in states:
        f = torch.where(l == 0, torch.zeros_like(m), torch.exp2(m - mm))
        ll = ll + l * f
        oo = oo + o * f[:, None]
    return mm, ll, oo


def _paged_split_emulation(q, kp, vp, bt, lens, ks=None, vs=None,
                           softcap=None, cs=None, single_term=False):
    """The bf16-q paged decode as ``csrc/split_decode.h`` computes it, in
    torch on the CPU: per (batch, kv-head, group of 16 q-heads) a cluster
    of ``cs`` blocks (the launcher's choice by default) takes contiguous
    key ranges (a share of kv_len rounded up to 16); each block walks
    64-key tiles gathered through the block table (any page size), its
    four warps 16 keys each, with an fp32 online softmax in base 2 per
    tile; over bf16 pages p is rounded to bf16 before P V, over int8 pages
    the values are exact, K's scale multiplies the score in fp32 and p *
    V's scale is split into hi and lo bf16 terms (``single_term``: hi
    only, the control); l sums the unrounded p; the warps merge in warp
    order, the ranks in rank order; a row with no valid key gives 0."""
    b, hq, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    nb = bt.shape[1]
    group = hq // hkv
    if cs is None:
        cs = _cluster_size(b, hq, hkv, nb * ps)
    scale = 1.0 / math.sqrt(d)
    q8 = ks is not None
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        n = max(0, min(int(lens[bi]), nb * ps))
        chunk = ((n + cs - 1) // cs + 15) // 16 * 16
        for kvh in range(hkv):
            for h0 in range(kvh * group, (kvh + 1) * group, 16):
                gn = min(16, (kvh + 1) * group - h0)
                qf = q[bi, h0:h0 + gn].float()
                ranks = []
                for rank in range(cs):
                    t_lo = min(n, rank * chunk)
                    t_hi = min(n, t_lo + chunk)
                    warps = [(torch.full((gn,), _NEG), torch.zeros(gn),
                              torch.zeros((gn, d))) for _ in range(4)]
                    for j0 in range(t_lo, t_hi, 64):
                        for w in range(4):
                            w0 = j0 + 16 * w
                            if w0 >= t_hi:
                                continue
                            t = torch.arange(w0, w0 + 16)
                            ok = t < t_hi
                            tc = torch.where(ok, t, 0)
                            page = bt[bi, tc // ps].long()
                            row = tc % ps
                            kk = torch.where(ok[:, None],
                                             kp[page, kvh, row].float(), 0.0)
                            vv = torch.where(ok[:, None],
                                             vp[page, kvh, row].float(), 0.0)
                            raw = qf @ kk.T
                            if q8:
                                raw = raw * torch.where(
                                    ok, ks[page, kvh, row], 0.0)[None, :]
                            if softcap:
                                x = softcap * torch.tanh(raw * scale
                                                         / softcap) * _LOG2E
                            else:
                                x = raw * (scale * _LOG2E)
                            x = torch.where(ok[None, :], x, _NEG)
                            m, l, o = warps[w]
                            mx = torch.maximum(m, x.max(1).values)
                            alpha = torch.exp2(m - mx)
                            p = torch.where(x == _NEG, 0.0,
                                            torch.exp2(x - mx[:, None]))
                            l = l * alpha + p.sum(1)
                            if q8:
                                pv = p * torch.where(
                                    ok, vs[page, kvh, row], 0.0)[None, :]
                                hi = _bf(pv)
                                pa = hi if single_term else hi + _bf(pv - hi)
                            else:
                                pa = _bf(p)
                            warps[w] = (mx, l, o * alpha[:, None] + pa @ vv)
                    ranks.append(_merge(warps))
                _, ll, oo = _merge(ranks)
                out[bi, h0:h0 + gn] = torch.where(
                    ll[:, None] == 0, 0.0, oo / torch.where(
                        ll == 0, 1.0, ll)[:, None])
    return out.to(torch.bfloat16)


def _paged_pool(rng, b, hkv, nb, ps, d, q8):
    """bf16-valued (or int8) pages shuffled over the pool, page 0 the trash
    page, and the block tables, as numpy arrays."""
    n_pages = 1 + b * nb
    shape = (n_pages, hkv, ps, d)
    if q8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.0, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.0, 0.02, shape[:3]).astype(np.float32)
    else:
        kp = _bf(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))).numpy()
        vp = _bf(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))).numpy()
        ks = vs = None
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, nb).astype(
        np.int32)
    return kp, vp, ks, vs, bt


def _paged_torch(q, kp, vp, ks, vs, bt, lens, q8):
    """The numpy operands as the kernel's torch operands: bf16 q and pages
    (int8 pages as they are), fp32 scales, int32 tables and lengths."""
    t = torch.from_numpy
    pages = (t(kp), t(vp)) if q8 else (t(kp).to(torch.bfloat16),
                                       t(vp).to(torch.bfloat16))
    return (t(q).to(torch.bfloat16), *pages,
            None if ks is None else t(ks), None if vs is None else t(vs),
            t(bt), t(lens))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("ps,cs", [(8, 1), (16, 3), (32, 5), (128, 8),
                                   (16, 8)])
def test_paged_split_emulation_within_limit(ps, cs, q8):
    """The bf16-q paged decode's arithmetic (``_paged_split_emulation``)
    at page sizes 8-128 and cluster sizes 1-8, over a GQA group of 4 and a
    group of 32 (two clusters a kv-head), rows of kv_len 1, 37, a page
    boundary and one past a 64-key tile (so some ranks are empty), lies
    within ``ref.paged_decode_attention_limit`` of the plain version; a
    row of kv_len 0 gives zeros."""
    rng = np.random.default_rng(ps * 10 + cs + 100 * q8)
    d = 64
    lens = np.asarray([1, 37, 2 * ps, 0, 129], np.int32)
    b = len(lens)
    nb = -(-int(lens.max()) // ps) + 1
    for hq, hkv in ((8, 2), (32, 1)):
        kp, vp, ks, vs, bt = _paged_pool(rng, b, hkv, nb, ps, d, q8)
        qn = rng.standard_normal((b, hq, d)).astype(np.float32)
        q, kpt, vpt, kst, vst, btt, lt = _paged_torch(qn, kp, vp, ks, vs, bt,
                                                     lens, q8)
        kw = dict(k_scale=kst, v_scale=vst)
        got = _paged_split_emulation(q, kpt, vpt, btt, lt, kst, vst, cs=cs)
        want = R.paged_decode_attention(q, kpt, vpt, btt, lt, **kw)
        limit = R.paged_decode_attention_limit(q, kpt, vpt, btt, lt, want,
                                               **kw)
        err = (got.float() - want.float()).abs()
        assert bool((err <= limit).all()), float((err / limit).max())
        assert not bool(got[3].float().abs().any())


@pytest.mark.parametrize("q8,softcap", [(False, None), (True, None),
                                        (False, 30.0), (True, 20.0)])
def test_paged_split_emulation_matches_pallas(q8, softcap):
    """At fp32 inputs that bf16 holds exactly (the same values on both
    sides: this CPU's XLA has no bf16 x bf16 -> fp32 dot), the emulation
    of the bf16-q paged decode at the launcher's own cluster size lies
    within ``ref.paged_decode_attention_limit`` of the JAX package's
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7 + 2 * q8 + (softcap is not None))
    b, hq, hkv, d, ps, nb = 3, 8, 2, 32, 8, 5
    kp, vp, ks, vs, bt = _paged_pool(rng, b, hkv, nb, ps, d, q8)
    qn = _bf(torch.from_numpy(rng.standard_normal((b, hq, d)).astype(
        np.float32))).numpy()
    lens = np.asarray([1, 19, nb * ps], np.int32)
    want = jpa.paged_decode_attention(
        jnp.asarray(qn), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), softcap=softcap,
        interpret=True)
    q, kpt, vpt, kst, vst, btt, lt = _paged_torch(qn, kp, vp, ks, vs, bt,
                                                 lens, q8)
    got = _paged_split_emulation(q, kpt, vpt, btt, lt, kst, vst,
                                 softcap=softcap)
    want = torch.from_numpy(np.array(want)).to(torch.bfloat16)
    limit = R.paged_decode_attention_limit(q, kpt, vpt, btt, lt, want,
                                           k_scale=kst, v_scale=vst,
                                           softcap=softcap)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def test_paged_split_single_term_control_beyond_limit():
    """Over int8 pages the kernel keeps the fp32 rule by splitting p *
    scale_v into two bf16 terms: the same emulation with one bf16 term
    lies beyond ``ref.paged_decode_attention_limit`` in some elements,
    while the two-term sum stays within it (the shares are printed)."""
    rng = np.random.default_rng(11)
    b, hq, hkv, d, ps, nb = 4, 16, 2, 128, 16, 4
    kp, vp, ks, vs, bt = _paged_pool(rng, b, hkv, nb, ps, d, True)
    qn = rng.standard_normal((b, hq, d)).astype(np.float32)
    lens = np.asarray([3, 9, 17, 40], np.int32)
    q, kpt, vpt, kst, vst, btt, lt = _paged_torch(qn, kp, vp, ks, vs, bt,
                                                 lens, True)
    kw = dict(k_scale=kst, v_scale=vst)
    want = R.paged_decode_attention(q, kpt, vpt, btt, lt, **kw)
    limit = R.paged_decode_attention_limit(q, kpt, vpt, btt, lt, want, **kw)
    two = _paged_split_emulation(q, kpt, vpt, btt, lt, kst, vst)
    one = _paged_split_emulation(q, kpt, vpt, btt, lt, kst, vst,
                                 single_term=True)
    print(f"two terms: {float(((two.float() - want.float()).abs() / limit).max()):.3f} "
          f"of the limit at worst; one term beyond it in "
          f"{_beyond(one, want, limit):.4f} of elements")
    assert _beyond(two, want, limit) == 0
    assert _beyond(one, want, limit) > 0


def _f32_rows(group):
    """q-heads a block of the fp32 kernel: the least of 1, 2, 4, 8 that
    holds the group, 8 beyond it."""
    return next(r for r in (1, 2, 4, 8) if group <= r or r == 8)


def _paged_f32_emulation(q, kp, vp, bt, lens, ks=None, vs=None,
                         softcap=None):
    """The fp32-q paged decode as ``csrc/paged_decode_attention.cu``
    computes it, in torch on the CPU: per (batch, kv-head, group of up to
    8 q-heads) a cluster of the launcher's size (about one block an SM, a
    32-key tile a block at least) takes contiguous key ranges (a share of
    kv_len rounded up to 16); each block walks 32-key tiles gathered
    through the block table, its four warps 8 keys each, with an fp32
    online softmax in base 2 per tile; over int8 pages the values are
    exact, K's scale multiplies the score and V's scale p; the warps merge
    in warp order, the ranks in rank order; a row with no valid key gives
    0."""
    b, hq, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    nb = bt.shape[1]
    group = hq // hkv
    gr = _f32_rows(group)
    rows = b * hkv * -(-group // gr)
    cs = max(1, min(8, -(-132 // rows), max(1, -(-(nb * ps) // 32))))
    scale = 1.0 / math.sqrt(d)
    q8 = ks is not None
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        n = max(0, min(int(lens[bi]), nb * ps))
        chunk = ((n + cs - 1) // cs + 15) // 16 * 16
        for kvh in range(hkv):
            for h0 in range(kvh * group, (kvh + 1) * group, gr):
                gn = min(gr, (kvh + 1) * group - h0)
                qf = q[bi, h0:h0 + gn].float()
                ranks = []
                for rank in range(cs):
                    t_lo = min(n, rank * chunk)
                    t_hi = min(n, t_lo + chunk)
                    warps = [(torch.full((gn,), _NEG), torch.zeros(gn),
                              torch.zeros((gn, d))) for _ in range(4)]
                    for j0 in range(t_lo, t_hi, 32):
                        for w in range(4):
                            w0 = j0 + 8 * w
                            if w0 >= t_hi:
                                continue
                            t = torch.arange(w0, w0 + 8)
                            ok = t < t_hi
                            tc = torch.where(ok, t, 0)
                            page = bt[bi, tc // ps].long()
                            row = tc % ps
                            kk = torch.where(ok[:, None],
                                             kp[page, kvh, row].float(), 0.0)
                            vv = torch.where(ok[:, None],
                                             vp[page, kvh, row].float(), 0.0)
                            raw = qf @ kk.T
                            if q8:
                                raw = raw * ks[page, kvh, row][None, :]
                            if softcap:
                                x = softcap * torch.tanh(raw * scale
                                                         / softcap) * _LOG2E
                            else:
                                x = raw * (scale * _LOG2E)
                            x = torch.where(ok[None, :], x, _NEG)
                            m, l, o = warps[w]
                            mx = torch.maximum(m, x.max(1).values)
                            alpha = torch.exp2(m - mx)
                            p = torch.where(x == _NEG, 0.0,
                                            torch.exp2(x - mx[:, None]))
                            l = l * alpha + p.sum(1)
                            if q8:
                                p = p * torch.where(
                                    ok, vs[page, kvh, row], 0.0)[None, :]
                            warps[w] = (mx, l, o * alpha[:, None] + p @ vv)
                    ranks.append(_merge(warps))
                _, ll, oo = _merge(ranks)
                out[bi, h0:h0 + gn] = torch.where(
                    ll[:, None] == 0, 0.0, oo / torch.where(
                        ll == 0, 1.0, ll)[:, None])
    return out


def _f32_pool(rng, b, hkv, nb, ps, d, q8):
    """fp32 (or int8) pages with fp32 scales and the block tables, as
    torch tensors (page 0 the trash page)."""
    kp, vp, ks, vs, bt = _paged_pool(rng, b, hkv, nb, ps, d, q8)
    t = torch.from_numpy
    if not q8:
        kp, vp = (rng.standard_normal(kp.shape).astype(np.float32)
                  for _ in range(2))
    return (t(kp), t(vp), None if ks is None else t(ks),
            None if vs is None else t(vs), t(bt))


@pytest.mark.parametrize("q8,softcap", [(False, None), (True, None),
                                        (False, 30.0), (True, 20.0)])
@pytest.mark.parametrize("hq,hkv,ps", [(4, 4, 16), (8, 2, 8), (12, 1, 32)])
def test_paged_f32_emulation_matches_pallas(hq, hkv, ps, q8, softcap):
    """The fp32-q paged decode's arithmetic (``_paged_f32_emulation``:
    32-key tiles, four warps of 8 keys, per-warp and per-rank (m, l, O)
    merged in order) over fp32 and int8 pages, GQA groups 1, 4 and 12 (a
    block of 8 q-heads and one of 4), ragged kv_len (0, 1, a page edge, a
    few tiles) lies within ``ref.paged_decode_attention_limit`` of the JAX
    package's Pallas kernel in interpret mode and of the plain version."""
    rng = np.random.default_rng(hq * 10 + ps + 2 * q8 + (softcap is not None))
    d = 64
    lens = np.asarray([0, 1, 2 * ps, 77, 150], np.int32)
    b, nb = len(lens), -(-150 // ps) + 1
    kp, vp, ks, vs, bt = _f32_pool(rng, b, hkv, nb, ps, d, q8)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    lt = torch.from_numpy(lens)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
    got = _paged_f32_emulation(q, kp, vp, bt, lt, ks, vs, softcap=softcap)
    want = R.paged_decode_attention(q, kp, vp, bt, lt, **kw)
    limit = R.paged_decode_attention_limit(q, kp, vp, bt, lt, want, **kw)
    assert bool(((got - want).abs() <= limit).all())
    pallas = jpa.paged_decode_attention(
        *(jnp.asarray(t.numpy()) for t in (q, kp, vp, bt, lt)),
        k_scale=None if ks is None else jnp.asarray(ks.numpy()),
        v_scale=None if vs is None else jnp.asarray(vs.numpy()),
        softcap=softcap, interpret=True)
    pallas = torch.from_numpy(np.array(pallas))
    limit = R.paged_decode_attention_limit(q, kp, vp, bt, lt, pallas, **kw)
    err = (got - pallas).abs()
    assert bool((err <= limit).all()), float((err / limit).max())
    assert not bool(got[0].abs().any())


@pytest.mark.parametrize("case,ok", [
    ("bf16 d 128", True), ("int8 d 64", True), ("bf16 d 16", True),
    ("d 48", True), ("d 96", True), ("int8 d 192", True),
    ("d 72", False), ("d 320", False), ("q off 16 bytes", False)])
def test_paged_decode_refuses_bf16_shapes_off_the_split_kernel(case, ok):
    """A bf16 q in ``paged_decode_attention`` has one kernel, the split
    one, and applies the dense decode's rule: head dims in multiples of 16
    from 16 to 256, every base pointer and stride but the last a multiple
    of 16 bytes; anything else is refused with ``ValueError``."""
    from repro_torch.kernels.decode_attention import check_bf16_operands
    b, hq, hkv, ps, n_pages = 2, 8, 2, 16, 5
    d = {"d 48": 48, "d 96": 96, "int8 d 64": 64, "bf16 d 16": 16,
         "int8 d 192": 192, "d 72": 72, "d 320": 320}.get(case, 128)
    kv_dt = torch.int8 if case.startswith("int8") else torch.bfloat16
    q = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    if case == "q off 16 bytes":
        q = _padded((b, hq, d), torch.bfloat16, 8, offset=4)
    pages = torch.zeros((n_pages, hkv, ps, d), dtype=kv_dt)
    if ok:
        check_bf16_operands(q, pages, pages)
    else:
        with pytest.raises(ValueError):
            check_bf16_operands(q, pages, pages)


@pytest.mark.parametrize("q8", [False, True])
def test_paged_decode_wrapper_refuses_cpu_tensors_first(monkeypatch, q8):
    """A bf16 q over bf16 or int8 pages on the CPU is refused with
    ``ValueError`` before any CUDA call."""
    from repro_torch.kernels import paged_attention
    _no_cuda(monkeypatch)
    b, hq, hkv, ps, d = 2, 32, 8, 16, 128
    q = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    pages = torch.zeros((5, hkv, ps, d),
                        dtype=torch.int8 if q8 else torch.bfloat16)
    kw = {}
    if q8:
        kw = dict(k_scale=torch.ones((5, hkv, ps)),
                  v_scale=torch.ones((5, hkv, ps)))
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(
            q, pages, pages, torch.ones((b, 2), dtype=torch.int32),
            torch.full((b,), 20, dtype=torch.int32), **kw)
