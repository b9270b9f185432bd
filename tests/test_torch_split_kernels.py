"""The two kernels split across a thread-block cluster, on the CPU: the
int8-weight matmul (``q8_matmul``) and flash-decode over a dense cache
(``decode_attention``) under a bf16 q.  No card here, so these hold what
surrounds the kernels: the plain versions against the JAX package's
Pallas kernels in interpret mode at the group sizes and head dims the
split kernel takes, the statistical limit ``ref.q8_matmul_limit`` (a
blocked fp32 sum passes it; the plain version over x rounded to bf16 or
kept to 16 significant bits does not), the wrappers' refusal of CPU
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
