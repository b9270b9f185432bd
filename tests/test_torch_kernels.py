"""The port's kernel plain versions against the JAX package's Pallas
kernels (run in interpret mode, as the JAX kernel tests run them on the
CPU): paged decode and paged prefill attention (fp32 and int8 pages) and
the int8-weight matmul.  Inputs come from numpy with a seed and go to both
sides.  Tolerances: 2e-5 for fp32 pages, 2e-4 for int8 pages (fp32
arithmetic in both; the kernels and the plain versions sum in different
orders).  The CPU route of ``ops`` must be the plain version, with no
kernel launch counted.  The launch path's C functions are looked up and
declared once (``build.c_function``, against a stand-in library: there
is no nvcc here).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import paged_prefill as jpp
from repro.kernels import q8_matmul as jq8
from repro.models import model as JM
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.kernels.q8_matmul import quantize_weights_np
from repro_torch.models import model as TM

F32 = dict(rtol=2e-5, atol=2e-5)
Q8 = dict(rtol=2e-4, atol=2e-4)


def _pool(rng, b, hkv, nb, ps, d, q8=False):
    """Pages for ``b`` rows of ``nb`` blocks each, shuffled over the pool
    (page 0 stays the trash page), plus the block tables."""
    n_pages = 1 + b * nb
    if q8:
        kp = rng.integers(-127, 128, (n_pages, hkv, ps, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, hkv, ps, d)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((n_pages, hkv, ps))) * 0.01
              ).astype(np.float32)
        vs = (np.abs(rng.standard_normal((n_pages, hkv, ps))) * 0.01
              ).astype(np.float32)
    else:
        kp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
        vp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
        ks = vs = None
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, nb) \
        .astype(np.int32)
    return kp, vp, ks, vs, bt


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("hq,hkv,softcap,q8", [
    (4, 4, None, False), (4, 2, None, False), (8, 2, 30.0, False),
    (4, 2, None, True), (4, 1, 20.0, True)])
def test_paged_decode_matches_pallas(hq, hkv, softcap, q8):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, d, ps, nb = 3, 32, 8, 4
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp, vp, ks, vs, bt = _pool(rng, b, hkv, nb, ps, d, q8)
    lens = np.asarray([1, 13, nb * ps], np.int32)      # ragged, page-unaligned
    want = jpa.paged_decode_attention(
        _j(q), _j(kp), _j(vp), _j(bt), _j(lens), k_scale=_j(ks),
        v_scale=_j(vs), softcap=softcap, interpret=True)
    got = R.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                                   k_scale=_t(ks), v_scale=_t(vs),
                                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(Q8 if q8 else F32))


def test_paged_decode_ignores_nan_pages_past_len():
    """Pages wholly past kv_len (the trash page, stale pool rows) are
    poisoned with NaN: the result must not change."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, ps, nb = 2, 4, 2, 16, 8, 4
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp, vp, _, _, bt = _pool(rng, b, hkv, nb, ps, d)
    lens = np.asarray([9, 16], np.int32)
    base = R.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens))
    kp2, vp2 = kp.copy(), vp.copy()
    for i in range(b):
        dead = bt[i, -(-lens[i] // ps):]
        kp2[dead] = np.nan
        vp2[dead] = np.nan
    kp2[0] = np.nan                                     # the trash page
    vp2[0] = np.nan
    got = R.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(bt),
                                   _t(lens))
    want = jpa.paged_decode_attention(_j(q), _j(kp2), _j(vp2), _j(bt),
                                      _j(lens), interpret=True)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    np.testing.assert_allclose(np.asarray(want), base.numpy(), **F32)


@pytest.mark.parametrize("hq,hkv,offs,window,softcap,q8", [
    (4, 2, (0, 0), None, None, False),
    (4, 4, (5, 19), None, None, False),                # page-unaligned
    (8, 2, (3, 11), 6, None, False),
    (4, 1, (8, 2), None, 25.0, False),
    (4, 2, (7, 13), None, None, True),
    (4, 2, (0, 9), 5, 30.0, True)])
def test_paged_prefill_matches_pallas(hq, hkv, offs, window, softcap, q8):
    rng = np.random.default_rng(sum(offs) + hq)
    b, d, ps, nb, s = 2, 16, 8, 4, 11
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    kp, vp, ks, vs, bt = _pool(rng, b, hkv, nb, ps, d, q8)
    off = np.asarray(offs, np.int32)
    want = jpp.paged_prefill_attention(
        _j(q), _j(kp), _j(vp), _j(bt), _j(off), k_scale=_j(ks),
        v_scale=_j(vs), softcap=softcap, window=window, block_q=8,
        interpret=True)
    got = R.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(off),
                                    k_scale=_t(ks), v_scale=_t(vs),
                                    softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(Q8 if q8 else F32))


def test_paged_prefill_ignores_nan_tail():
    """Pages past the chunk's last position are poisoned with NaN.  (The
    chunk fills whole Pallas query blocks: its pad rows would otherwise
    read one page further.)"""
    rng = np.random.default_rng(3)
    b, hq, hkv, d, ps, nb, s = 1, 4, 2, 16, 8, 5, 8
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    kp, vp, _, _, bt = _pool(rng, b, hkv, nb, ps, d)
    off = np.asarray([9], np.int32)
    base = R.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(off))
    dead = bt[0, -(-(9 + s) // ps):]
    kp[dead] = np.nan
    vp[dead] = np.nan
    got = R.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(off))
    want = jpp.paged_prefill_attention(_j(q), _j(kp), _j(vp), _j(bt),
                                       _j(off), block_q=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    np.testing.assert_allclose(np.asarray(want), base.numpy(), **F32)


@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (37, 96, 130), (1, 16, 8)])
def test_q8_matmul_matches_pallas(m, k, n):
    """Ragged shapes on the port's side; the Pallas kernel needs its
    blocks to divide the shape, so it gets block sizes that do."""
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s = quantize_weights_np(w)
    want = jq8.q8_matmul(_j(x), _j(q), _j(s), block_m=m, block_n=n,
                         block_k=k, interpret=True)
    got = R.q8_matmul(_t(x), _t(q), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Q8)
    assert (np.abs(got.numpy() - x @ w) <= 0.05 * np.abs(x).sum(1)[:, None]
            * np.abs(w).max(0)[None]).all()


def test_quantize_weights_bit_identical():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    q, s = quantize_weights_np(w)
    jq, js = jq8.quantize_weights_np(w)
    jq2, js2 = jq8.quantize_weights(jnp.asarray(w))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(q, np.asarray(jq2))
    np.testing.assert_array_equal(s, np.asarray(js2))
    # a strided column view quantizes exactly like its contiguous copy
    qv, sv = quantize_weights_np(w[:, 8:])
    qc, sc = quantize_weights_np(np.ascontiguousarray(w[:, 8:]))
    np.testing.assert_array_equal(qv, qc)
    np.testing.assert_array_equal(sv, sc)


def test_quantize_kv_bit_identical():
    rng = np.random.default_rng(1)
    new = (rng.standard_normal((2, 5, 3, 16)) * 3).astype(np.float32)
    jq, jm = JM._quantize_kv(jnp.asarray(new))
    tq, tm = TM._quantize_kv(torch.from_numpy(new))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_ops_cpu_route_is_plain_version():
    rng = np.random.default_rng(2)
    K.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    q, s = quantize_weights_np(rng.standard_normal((8, 5)).astype(np.float32))
    y = K.q8_matmul(x, torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(
        y.numpy(), R.q8_matmul(x, torch.from_numpy(q),
                               torch.from_numpy(s)).numpy())
    assert K.launch_counts() == {"paged_decode_attention": 0,
                                 "paged_prefill_attention": 0,
                                 "q8_matmul": 0, "decode_attention": 0,
                                 "flash_attention": 0, "rmsnorm": 0,
                                 "ssd_chunk": 0, "matmul": 0,
                                 "gated_matmul": 0,
                                 "plain_dense_attention": 0,
                                 "plain_ssd_scan": 0}


def test_cuda_wrappers_reject_cpu_tensors():
    """A wrapper never falls back: handed CPU tensors it raises."""
    from repro_torch.kernels import paged_attention, q8_matmul
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        q8_matmul.q8_matmul(x, torch.zeros((4, 3), dtype=torch.int8),
                            torch.ones(3))
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(
            torch.zeros((1, 2, 4)), torch.zeros((3, 2, 4, 4)),
            torch.zeros((3, 2, 4, 4)), torch.ones((1, 2), dtype=torch.int32),
            torch.ones((1,), dtype=torch.int32))


class _StandInFunction:
    """A C entry point that records every assignment of its signature."""

    def __init__(self):
        self.sets = []

    def __setattr__(self, name, value):
        if name in ("argtypes", "restype"):
            self.sets.append(name)
        object.__setattr__(self, name, value)


class _StandInLibrary:
    def __init__(self):
        self.lookups = 0
        self.fn = _StandInFunction()

    def __getattr__(self, symbol):
        if symbol.startswith("__"):
            raise AttributeError(symbol)
        self.lookups += 1
        return self.fn


@pytest.mark.parametrize("kernel,symbol", [
    ("rmsnorm", "rmsnorm"), ("hete_matmul", "hete_gated_matmul")])
def test_c_function_is_declared_once(monkeypatch, kernel, symbol):
    """``build.c_function`` looks a symbol up and declares its signature
    (one pointer to the packed arguments) once per (library, symbol):
    later calls return the same object and set nothing again (no nvcc
    here: the library is a stand-in).  The packing gives every argument
    an 8-byte slot, a float as float64."""
    import struct

    from repro_torch.kernels import build
    lib = _StandInLibrary()
    loads = []
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "library",
                        lambda name: loads.append(name) or lib)
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p)
    first = build.c_function(kernel, symbol, argtypes)
    second = build.c_function(kernel, symbol, argtypes)
    assert first is second and first.fn is lib.fn
    assert first.__name__ == symbol
    assert lib.fn.argtypes == [ctypes.c_char_p]
    assert lib.fn.restype is ctypes.c_int
    assert lib.fn.sets == ["argtypes", "restype"]
    assert loads == [kernel] and lib.lookups == 1
    packed = first.pack(4096, 5120, 3, 1e-5, 77)
    assert packed == struct.pack("<qqqdq", 4096, 5120, 3, 1e-5, 77)
    assert len(packed) == 8 * len(argtypes)
    other = build.c_function(kernel, symbol + "_other", argtypes)
    assert other is not first and lib.lookups == 2
