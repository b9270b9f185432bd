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
a bf16 q at a shape the split kernel does not take.  Inputs come from
numpy with a seed and go to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
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
    ("d 48", False), ("d 8", False), ("q off 16 bytes", False),
    ("bf16 token stride 68", False), ("int8 token stride 72", False),
    ("v off 16 bytes", False)])
def test_decode_refuses_bf16_shapes_off_the_split_kernel(case, ok):
    """A bf16 q has one kernel, the split one: head dims in
    ``BF16_HEAD_DIMS`` with every base pointer and stride but the last a
    multiple of 16 bytes.  Anything else is refused with ``ValueError``
    (on the card before the launch) rather than run by another kernel."""
    from repro_torch.kernels.decode_attention import check_bf16_operands
    b, hq, hkv, t = 2, 8, 2, 40
    d = {"d 48": 48, "d 8": 8, "int8 d 64": 64}.get(case, 128)
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
