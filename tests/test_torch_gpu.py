"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes, plus the offload engine on the card.  Every
test carries the ``gpu`` marker and skips without a CUDA device; this
file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 for fp32 pages, 2e-4 for int8 pages; for the int8-weight
matmul, the dense-cache kernels, RMSNorm and the dense matmuls, element by
element, the limits of ``ref.q8_matmul_limit``,
``ref.decode_attention_limit``,
``ref.flash_attention_limit``, ``ref.rmsnorm_limit``,
``ref.matmul_limit`` and ``ref.gated_matmul_limit``: fp32 summation
order (for the int8-weight matmul, a blocked sum's distance from the
exact product beside the plain version's own), one step of a bf16 output,
and, over a bf16 cache, the most that rounding p to bf16 before the PV
product can move the output (the kernels round p, the plain versions do
not).  A bf16 RMSNorm output is also held bit-equal to the plain version
but for at most ``ref.RMSNORM_UNEQUAL_MAX`` of its elements.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(gen, b, hkv, nb, ps, d, q8, dev):
    n_pages = 1 + b * nb
    shape = (n_pages, hkv, ps, d)
    if q8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device=dev) * 0.02
        vs = torch.rand(shape[:3], generator=gen, device=dev) * 0.02
    else:
        kp = torch.randn(shape, generator=gen, device=dev)
        vp = torch.randn(shape, generator=gen, device=dev)
        ks = vs = None
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, nb).to(torch.int32)
    return kp, vp, ks, vs, bt


@pytest.mark.parametrize("hq,hkv,d,softcap,q8", [
    (4, 4, 128, None, False), (8, 2, 64, 30.0, False), (4, 1, 16, None, True),
    (32, 32, 128, None, True)])
def test_paged_decode_kernel(cuda, hq, hkv, d, softcap, q8):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, ps, nb = 3, 16, 5
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    q = torch.randn((b, hq, d), generator=gen, device=cuda)
    lens = torch.tensor([1, 37, nb * ps], dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    want = ref.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    tol = 2e-4 if q8 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    if not q8:
        # pages wholly past kv_len (and the trash page) may hold NaN
        for i in range(b):
            dead = bt[i, -(-int(lens[i]) // ps):].long()
            kp[dead] = float("nan")
            vp[dead] = float("nan")
        kp[0] = float("nan")
        again = ops.paged_decode_attention(q, kp, vp, bt, lens, **kw)
        torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("hq,hkv,d,offs,window,softcap,q8", [
    (4, 2, 64, (0, 0), None, None, False),
    (4, 4, 128, (5, 37), None, None, False),
    (8, 2, 32, (3, 20), 9, 25.0, False),
    (4, 2, 64, (16, 7), None, None, True),
    (4, 1, 128, (0, 33), 6, None, True)])
def test_paged_prefill_kernel(cuda, hq, hkv, d, offs, window, softcap, q8):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, ps, nb, s = 2, 16, 6, 37                  # ragged: 37 = 2*16 + 5
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap, window=window)
    got = ops.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    want = ref.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    torch.cuda.synchronize()
    tol = 2e-4 if q8 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, off, **kw),
                       got)
    if not q8:
        for i in range(b):
            dead = bt[i, -(-(offs[i] + s) // ps):].long()
            kp[dead] = float("nan")
            vp[dead] = float("nan")
        again = ops.paged_prefill_attention(q, kp, vp, bt, off, **kw)
        torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 1280), (37, 96, 130),
                                   (1, 16, 8), (200, 512, 384)])
def test_q8_matmul_kernel(cuda, m, k, n):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.q8_matmul import quantize_weights_np
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    q, s = quantize_weights_np(rng.standard_normal((k, n))
                               .astype(np.float32))
    x, q, s = x.to(cuda), torch.from_numpy(q).to(cuda), \
        torch.from_numpy(s).to(cuda)
    got = ops.q8_matmul(x, q, s)
    want = ref.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.q8_matmul_limit(x, q, s, want))


@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 2560), (4, 4096, 2560), (16, 4096, 2560), (17, 4096, 2560),
    (4, 4096, 1000), (4, 4097, 640), (4, 16384, 2560), (3, 200, 1001),
    (8, 4096, 10112), (2, 48, 24)])
def test_q8_matmul_split_kernel(cuda, m, k, n):
    """The streaming kernel (M <= 16; M = 17 the tensor-core kernel) at
    decode widths, N
    no multiple of the 64-column slab (1000; 1001 and 24 also not of 16,
    the byte-load path), K no multiple of the cluster's split (4097) and
    K = 16384 at N = 2560: within ``ref.q8_matmul_limit``, one launch, and
    the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.q8_matmul import quantize_weights_np
    rng = np.random.default_rng(m * 31 + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    q, s = quantize_weights_np(rng.standard_normal((k, n))
                               .astype(np.float32))
    x, q, s = x.to(cuda), torch.from_numpy(q).to(cuda), \
        torch.from_numpy(s).to(cuda)
    before = ops.launch_counts()["q8_matmul"]
    got = ops.q8_matmul(x, q, s)
    assert ops.launch_counts()["q8_matmul"] == before + 1
    want = ref.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.q8_matmul_limit(x, q, s, want))
    assert torch.equal(ops.q8_matmul(x, q, s), got)


# cell 3's prefill shapes of q8_matmul (chunk rows x each (K, N) of the
# q8 wire), then the tensor-core kernel's edges: M past one 32-row block,
# K no multiple of 16 or 4, N no multiple of 8 or 16
_Q8_PREFILL = [(m, k, n) for m in (18, 24, 28, 31, 32)
               for k, n in ((4096, 2944), (4096, 11776), (16384, 2944))]


@pytest.mark.parametrize("m,k,n,offset", [
    *((m, k, n, 0) for m, k, n in _Q8_PREFILL),
    (17, 4097, 1001, 0), (37, 4097, 1001, 0), (200, 4097, 1001, 0),
    (512, 4097, 1001, 0), (20, 4096, 2944, 1), (33, 96, 130, 1)])
def test_q8_matmul_tensor_core_kernel(cuda, m, k, n, offset):
    """The three-term bf16 tensor-core kernel (M > 16) at every prefill
    shape of cell 3 and at its edges, x starting ``offset`` floats past a
    16-byte boundary where given (the 4-byte copy path): within
    ``ref.q8_matmul_limit``, one launch, and the same bits from a second
    call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.q8_matmul import quantize_weights_np
    rng = np.random.default_rng(m * 7 + k + n)
    xs = rng.standard_normal(m * k + offset).astype(np.float32)
    q, s = quantize_weights_np(rng.standard_normal((k, n))
                               .astype(np.float32))
    x = torch.from_numpy(xs).to(cuda)[offset:].view(m, k)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = ops.launch_counts()["q8_matmul"]
    got = ops.q8_matmul(x, q, s)
    assert ops.launch_counts()["q8_matmul"] == before + 1
    want = ref.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.q8_matmul_limit(x, q, s, want))
    assert torch.equal(ops.q8_matmul(x, q, s), got)


def test_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_attention, q8_matmul, rmsnorm)
    x = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        q8_matmul.q8_matmul(x, torch.zeros((4, 3), device=cuda),
                            torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        q8_matmul.q8_matmul(x.t(), torch.zeros((2, 3), dtype=torch.int8,
                                               device=cuda),
                            torch.ones(3, device=cuda))
    # the paged kernels take fp32 and bf16: a float16 q raises, a bf16 q
    # over bf16 pages runs, a bf16 q over fp32 pages raises
    gen = torch.Generator(device=cuda).manual_seed(0)
    kp, vp, _, _, bt = _pool(gen, 2, 2, 2, 16, 64, False, cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        paged_attention.paged_decode_attention(
            torch.zeros((2, 4, 64), dtype=torch.float16, device=cuda),
            kp.half(), vp.half(), bt, ones)
    qb = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=cuda)
    out = paged_attention.paged_decode_attention(qb, kp.bfloat16(),
                                                 vp.bfloat16(), bt, ones)
    assert out.dtype == torch.bfloat16 and out.shape == qb.shape
    with pytest.raises(TypeError):
        paged_attention.paged_decode_attention(qb, kp, vp, bt, ones)
    # dense kernels: a wrong dtype or layout raises
    q = torch.zeros((2, 4, 64), device=cuda)
    k = torch.zeros((2, 2, 8, 64), device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention.decode_attention(q, k.bfloat16(), k.bfloat16(),
                                          lens)
    with pytest.raises(TypeError):
        decode_attention.decode_attention(q, k, k, lens.long())
    with pytest.raises(ValueError):
        decode_attention.decode_attention(q, k.transpose(2, 3),
                                          k.transpose(2, 3), lens)
    # a bf16 q runs only the split kernel: another head dim, or a row off
    # 16-byte alignment, raises instead of taking another kernel
    kb = torch.zeros((2, 2, 8, 72), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                      # D 72: no kernel
        decode_attention.decode_attention(
            torch.zeros((2, 4, 72), dtype=torch.bfloat16, device=cuda), kb,
            kb, lens)
    qb = torch.zeros((2, 4, 72), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        decode_attention.decode_attention(qb[..., 4:68], k.bfloat16(),
                                          k.bfloat16(), lens)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(k.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(k, k, k.transpose(1, 2))
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm(q, torch.ones(64, device=cuda, dtype=torch.bfloat16))
    # SSD: a wrong dtype, layout or width raises
    from repro_torch.kernels import ssd_chunk
    x = torch.zeros((1, 32, 2, 8), device=cuda)
    dt = torch.zeros((1, 32, 2), device=cuda)
    a = -torch.ones(2, device=cuda)
    bm = torch.zeros((1, 32, 2, 16), device=cuda)
    with pytest.raises(TypeError):
        ssd_chunk.ssd_chunk(x.half(), dt, a, bm.half(), bm.half(), chunk=16)
    with pytest.raises(TypeError):
        ssd_chunk.ssd_chunk(x, dt, a, bm.bfloat16(), bm, chunk=16)
    with pytest.raises(ValueError):
        ssd_chunk.ssd_chunk(x, dt, a, bm.transpose(2, 3).contiguous()
                            .transpose(2, 3), bm, chunk=16)
    with pytest.raises(ValueError):
        ssd_chunk.ssd_chunk(x, dt, a, bm, bm, chunk=12)
    with pytest.raises(ValueError):
        ssd_chunk.ssd_chunk(torch.zeros((1, 32, 2, 160), device=cuda), dt,
                            a, bm, bm, chunk=16)


def _dense_cache(gen, b, hkv, t, d, dtype, layout, dev):
    """K/V (and int8 scales) in the stacked (B, Hkv, T, D) layout, or as
    the backend's (B, T, Hkv, D) buffer seen through transpose(1, 2)."""
    shape = (b, hkv, t, d) if layout == "bhtd" else (b, t, hkv, d)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        sshape = shape[:3]
        ks = torch.rand(sshape, generator=gen, device=dev) * 0.02
        vs = torch.rand(sshape, generator=gen, device=dev) * 0.02
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        ks = vs = None
    if layout == "bthd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if ks is not None:
            ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    return k, v, ks, vs


def _assert_within(got, want, limit):
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), \
        f"worst error {float((err / limit).max()):.3f} x its limit"


@pytest.mark.parametrize("qdt,kvdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("hq,hkv,d,softcap", [
    (8, 2, 128, None), (4, 4, 64, 30.0), (4, 1, 16, None)])
def test_decode_attention_kernel(cuda, qdt, kvdt, layout, hq, hkv, d,
                                 softcap):
    """An int8 cache is dequantized in q's dtype: under a bf16 q as
    bf16(bf16(k) * bf16(scale)) with p rounded to bf16, the stacked
    path's rule."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, t = 4, 300
    k, v, ks, vs = _dense_cache(gen, b, hkv, t, d, kvdt, layout, cuda)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(qdt)
    lens = torch.tensor([1, 37, 256, t], dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, lens, **kw)
    want = ref.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert got.dtype == qdt and got.shape == (b, hq, d)
    _assert_within(got, want,
                   ref.decode_attention_limit(q, k, v, lens, want, **kw))
    assert ops.launch_counts()["decode_attention"] == before + 1
    if kvdt != torch.int8:
        # rows at or past kv_len may hold NaN: never read
        for i in range(b):
            k[i, :, int(lens[i]):] = float("nan")
            v[i, :, int(lens[i]):] = float("nan")
        again = ops.decode_attention(q, k, v, lens, **kw)
        torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("hq,hkv,d,t,softcap", [
    (32, 8, 128, 528, None), (8, 8, 64, 300, None), (16, 2, 256, 300, 30.0),
    (32, 4, 128, 4096, None), (20, 1, 64, 130, 50.0),
    # Llama-4 Scout (a group of 5), Zamba2's shared block, Gemma-2
    (40, 8, 128, 528, None), (32, 32, 64, 528, None),
    (8, 4, 256, 4624, 50.0)])
def test_decode_attention_split_kernel(cuda, kvdt, layout, hq, hkv, d, t,
                                       softcap):
    """The split-KV kernel (bf16 q over a bf16 or int8 cache): group sizes
    1, 4, 8 and 20 (two clusters of q-heads), head dims 64, 128, 256, T
    no multiple of the 64-token tile, kv_len of 0, 1, 16 and 64 tokens +-
    1 (the block and tile edges) and T, within
    ``ref.decode_attention_limit``, one launch, the same bits from a second
    call and with NaN in every row past kv_len (int8: NaN scales)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(hq + d + t)
    lens = [0, 1, 15, 17, 63, 65, t - 1, t]
    b = len(lens)
    k, v, ks, vs = _dense_cache(gen, b, hkv, t, d, kvdt, layout, cuda)
    q = torch.randn((b, hq, d), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, kl, **kw)
    assert ops.launch_counts()["decode_attention"] == before + 1
    want = ref.decode_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, d)
    _assert_within(got, want,
                   ref.decode_attention_limit(q, k, v, kl, want, **kw))
    assert not bool(got[0].float().any())          # kv_len 0 writes 0
    assert torch.equal(ops.decode_attention(q, k, v, kl, **kw), got)
    for i, n in enumerate(lens):
        if kvdt == torch.int8:
            ks[i, :, n:] = float("nan")
            vs[i, :, n:] = float("nan")
        else:
            k[i, :, n:] = float("nan")
            v[i, :, n:] = float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, kl, **kw), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("hq,hkv,d,s,causal,window,softcap", [
    (8, 2, 128, 77, True, None, None), (4, 4, 64, 64, True, 9, 25.0),
    (4, 2, 32, 37, False, None, None), (4, 1, 16, 50, False, 7, 20.0)])
def test_flash_attention_kernel(cuda, dtype, layout, hq, hkv, d, s, causal,
                                window, softcap):
    """The first s positions of a longer cache (a strided view), ragged s,
    output written straight into the (B, S, Hq, D) layout."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, t = 2, s + 19
    k, v, _, _ = _dense_cache(gen, b, hkv, t, d, dtype, layout, cuda)
    k, v = k[:, :, :s], v[:, :, :s]
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(dtype) \
        .transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    _assert_within(got, want, ref.flash_attention_limit(q, k, v, want, **kw))
    if layout == "bhtd":
        # positions past s (outside the view) may hold NaN: never read
        kfull = k.as_strided((b, hkv, t, d), k.stride())
        kfull[:, :, s:] = float("nan")
        again = ops.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("b,hq,hkv,d,s", [(4, 32, 32, 128, 64),
                                          (2, 4, 2, 20, 45),
                                          (2, 4, 4, 18, 40)])
def test_flash_attention_f32_kernel(cuda, layout, b, hq, hkv, d, s):
    """The fp32 route at OPT-6.7B's prefill shape (3c, 3f) and at head dims
    off the padded widths (20: zeros staged past D; 18: rows off 16-byte
    alignment, 4-byte copies and scalar stores), causal, over the first s
    positions of a longer cache: within ``ref.flash_attention_limit``, one
    launch, the same bits from a second call, and the same bits again with
    NaN at every position past s."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(d)
    t = s + 8
    k, v, _, _ = _dense_cache(gen, b, hkv, t, d, torch.float32, layout, cuda)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda) \
        .transpose(1, 2)
    kv = k[:, :, :s], v[:, :, :s]
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, *kv)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention(q, *kv)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.flash_attention_limit(q, *kv, want))
    assert torch.equal(ops.flash_attention(q, *kv), got)
    k[:, :, s:] = float("nan")
    v[:, :, s:] = float("nan")
    assert torch.equal(ops.flash_attention(q, *kv), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,plus_one,sliced", [
    ((4, 5120), False, False), ((3, 7, 100), True, False),
    ((4, 9, 5120), False, True), ((2, 6, 4, 128), False, False),
    ((4, 2304), True, False)])
def test_rmsnorm_kernel(cuda, dtype, shape, plus_one, sliced):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    if sliced:
        x = x[:, -1:]                     # rows with a stride of 9 rows
    w = torch.randn(shape[-1], generator=gen, device=cuda).to(dtype)
    got = ops.rmsnorm(x, w, eps=1e-5, plus_one=plus_one)
    want = ref.rmsnorm(x, w, eps=1e-5, plus_one=plus_one)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    _assert_within(got, want, ref.rmsnorm_limit(want))
    if dtype == torch.bfloat16:
        assert ref.unequal_share(got, want) <= ref.RMSNORM_UNEQUAL_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2560, 5120, 128, 256, 768, 2048, 2304, 4096])
@pytest.mark.parametrize("rows", [1, 4, 2048])
def test_rmsnorm_kernel_model_widths(cuda, rows, d, dtype):
    """The model widths (qk-norm's 128, MLA's latent 256 and 768, the
    scan-stacked families' d_model) at decode and prefill row counts:
    within the
    limit, and a bf16 output bit-equal to the plain version but for at
    most ``ref.RMSNORM_UNEQUAL_MAX`` of its elements."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
    w = torch.randn(d, generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w, eps=1e-5)
    want = ref.rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.rmsnorm_limit(want))
    if dtype == torch.bfloat16:
        assert ref.unequal_share(got, want) <= ref.RMSNORM_UNEQUAL_MAX
    assert ops.launch_counts()["rmsnorm"] == before + 1


@pytest.mark.parametrize("hq,hkv,d,s,window,softcap", [
    (32, 8, 128, 512, None, None), (32, 8, 128, 500, None, None),
    (32, 8, 128, 77, None, None), (4, 2, 256, 200, None, None),
    (4, 1, 256, 130, 50, 30.0),
    # Llama-4 Scout (a group of 5), Zamba2's shared block, Gemma-2's local
    (40, 8, 128, 512, None, None), (32, 32, 64, 512, None, None),
    (8, 4, 256, 600, 512, 50.0)])
def test_flash_attention_bf16_tensor_cores(cuda, hq, hkv, d, s, window,
                                           softcap):
    """The bf16 kernel at Mistral-NeMo's head layout (S 512, 500 and 77:
    whole, ragged and short tiles) and at D 256 (32-key tiles, Q from
    shared memory): within the limit, and positions past s holding NaN
    are never read."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    b, t = 2, s + 24
    k, v, _, _ = _dense_cache(gen, b, hkv, t, d, torch.bfloat16, "bhtd",
                              cuda)
    k, v = k[:, :, :s], v[:, :, :s]
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda) \
        .to(torch.bfloat16).transpose(1, 2)
    kw = dict(window=window, softcap=softcap)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.flash_attention_limit(q, k, v, want, **kw))
    assert ops.launch_counts()["flash_attention"] == before + 1
    for x in (k, v):
        x.as_strided((b, hkv, t, d), x.stride())[:, :, s:] = float("nan")
    again = ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_flash_attention_refuses_unsupported_operands(cuda):
    """bf16 takes only the head dims it is built for (multiples of 16 up
    to 256) and rows in 16-byte steps; it raises on anything else and
    never falls back."""
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    for d in (72, 320):
        q = torch.zeros((1, 4, 8, d), device=cuda, dtype=bf)
        with pytest.raises(ValueError):
            fa.flash_attention(q, q[:, :2], q[:, :2])       # D 72, 320
    buf = torch.zeros((1, 2, 8, 68), device=cuda, dtype=bf)
    k = buf[..., :64]                                       # row stride 68
    q = torch.zeros((1, 4, 8, 64), device=cuda, dtype=bf)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError):                         # 2-byte offset
        fa.flash_attention(torch.zeros(4 * 8 * 64 + 1, device=cuda,
                                       dtype=bf)[1:].view(1, 4, 8, 64),
                           q[:, :2], q[:, :2])
    fa.flash_attention(q, q[:, :2], q[:, :2])               # aligned: runs
    kf = torch.zeros((1, 2, 8, 66), device=cuda)[..., :64]
    fa.flash_attention(q.float(), kf, kf)                   # fp32: any stride


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_oneshot_on_card_matches_cpu(cuda, kv_dtype):
    """The tiny model's one-shot generation on the card (every attention
    and RMSNorm through a kernel) gives the CPU run's greedy tokens, with
    the launch counts the route rule predicts and no plain attention."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Generator
    cfg = dataclasses.replace(get_config("tiny"), kv_dtype=kv_dtype)
    params = M.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 20)).astype(np.int32)
    want = Generator(cfg, params).generate({"tokens": prompts}, 6)
    ops.reset_launch_counts()
    got = Generator(cfg, M.tree_to(params, cuda)).generate(
        {"tokens": prompts}, 6)
    n = ops.launch_counts()
    assert got.tokens == want.tokens
    assert n["flash_attention"] == cfg.n_layers
    assert n["decode_attention"] == cfg.n_layers * 5
    assert n["rmsnorm"] == (2 * cfg.n_layers + 1) * 6
    assert n["gated_matmul"] == cfg.n_layers * 6
    assert n["plain_dense_attention"] == 0


@pytest.mark.parametrize("wstream", ["fp", "q8"])
def test_engine_on_card(cuda, wstream):
    """Host share, pinned ring, copy stream and device share on the card
    equal x @ W + b (fp: 1e-4; q8: the quantization bound)."""
    from repro_torch.core.engine import HeteGenEngine, ModulePlan
    rng = np.random.default_rng(2)
    w = {f"l{i}": rng.standard_normal((256, 512)).astype(np.float32)
         for i in range(4)}
    b = {n: rng.standard_normal(512).astype(np.float32) for n in w}
    plan = [ModulePlan(n, "g", "hetegen", 0.5) for n in w]
    eng = HeteGenEngine(w, plan, biases=b, device=cuda, wstream=wstream)
    try:
        x = rng.standard_normal((3, 7, 256)).astype(np.float32)
        for _ in range(2):
            for n in w:
                got = eng.linear(torch.from_numpy(x).to(cuda), n).cpu()
                want = x @ w[n] + b[n]
                bound = 1e-4 if wstream == "fp" else float(
                    (np.abs(x).sum(-1).max() * np.abs(w[n]).max() / 127))
                assert np.abs(got.numpy() - want).max() <= bound
        st = eng.finish_stats()
        assert st.trans > 0 and st.dev > 0 and st.cpu > 0
        assert eng.manager.rings["g"].slots[0].buffer.is_pinned()
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("q8", [False, True])
def test_paged_kernels_bf16(cuda, kind, q8):
    """A bf16 q over bf16 pages (p rounded to bf16 before the PV product)
    or over int8 pages (dequantized in fp32), held to the per-element
    limits of ``ref.paged_*_attention_limit``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, hq, hkv, d, ps, nb = 2, 8, 2, 128, 16, 6
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    if not q8:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    kw = dict(k_scale=ks, v_scale=vs)
    if kind == "decode":
        q = torch.randn((b, hq, d), generator=gen, device=cuda).bfloat16()
        lens = torch.tensor([37, nb * ps], dtype=torch.int32, device=cuda)
        got = ops.paged_decode_attention(q, kp, vp, bt, lens, **kw)
        want = ref.paged_decode_attention(q, kp, vp, bt, lens, **kw)
        limit = ref.paged_decode_attention_limit(q, kp, vp, bt, lens,
                                                 want, **kw)
    else:
        s = 37
        q = torch.randn((b, hq, s, d), generator=gen, device=cuda).bfloat16()
        off = torch.tensor([3, 50], dtype=torch.int32, device=cuda)
        got = ops.paged_prefill_attention(q, kp, vp, bt, off, **kw)
        want = ref.paged_prefill_attention(q, kp, vp, bt, off, **kw)
        limit = ref.paged_prefill_attention_limit(q, kp, vp, bt, off,
                                                  want, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within(got, want, limit)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("hq,hkv,d,s,offs,window,softcap", [
    (8, 2, 128, 37, (3, 50), None, None),
    (8, 2, 64, 37, (0, 21), 9, 30.0),
    (4, 4, 16, 37, (16, 5), None, 25.0),
    (32, 8, 128, 512, (0,), None, None)])
def test_paged_prefill_bf16_tensor_cores(cuda, hq, hkv, d, s, offs, window,
                                         softcap, q8):
    """A bf16 q over bf16 or int8 pages (the tensor-core kernel, GQA
    groups of 4 and 1) at ragged S (37) and at 3e's S (512, 32 / 8 heads),
    with a window and a softcap: within ``ref.paged_prefill_attention_
    limit``, one launch, the same bits from a second call, and the same
    bits again with NaN (int8: NaN scales) in every page past a row's last
    diagonal and in the trash page."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    ps = 16
    nb = max(-(-(o + s) // ps) for o in offs) + 1
    b = len(offs)
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    if not q8:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).bfloat16()
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap, window=window)
    before = ops.launch_counts()["paged_prefill_attention"]
    got = ops.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    assert ops.launch_counts()["paged_prefill_attention"] == before + 1
    want = ref.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    limit = ref.paged_prefill_attention_limit(q, kp, vp, bt, off, want,
                                              **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within(got, want, limit)
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, off, **kw),
                       got)
    # every page wholly past a row's last diagonal, and the trash page
    dead = [bt[i, -(-(o + s) // ps):].long() for i, o in enumerate(offs)]
    for pages in dead + [torch.zeros(1, dtype=torch.long, device=cuda)]:
        for t in ((ks, vs) if q8 else (kp, vp)):
            t[pages] = float("nan")
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, off, **kw),
                       got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 32])
def test_paged_prefill_page_sizes(cuda, ps, dtype):
    """Pages of 4, 8 and 32 tokens (a 32-key tile spans several pages, or
    one page): both kernels within ``ref.paged_prefill_attention_limit``
    at ragged S and a kv offset inside a page, and the same bits with NaN
    in every page past a row's last diagonal."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(ps)
    hq, hkv, d, s, offs = 8, 2, 64, 37, (3, 45)
    nb = max(-(-(o + s) // ps) for o in offs) + 1
    kp, vp, _, _, bt = _pool(gen, len(offs), hkv, nb, ps, d, False, cuda)
    kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.randn((len(offs), hq, s, d), generator=gen,
                    device=cuda).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    got = ops.paged_prefill_attention(q, kp, vp, bt, off)
    want = ref.paged_prefill_attention(q, kp, vp, bt, off)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.paged_prefill_attention_limit(
        q, kp, vp, bt, off, want))
    for i, o in enumerate(offs):
        dead = bt[i, -(-(o + s) // ps):].long()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, off), got)


def test_paged_prefill_refuses_unsupported_operands(cuda):
    """One kernel per q dtype and no fallback: a bf16 q at a head dim
    that is no multiple of 16 up to 256 (72, 320), an fp32 q at a head dim
    that is no multiple of 4, or of 16 over int8 pages, raises
    ``ValueError``."""
    from repro_torch.kernels import paged_prefill
    gen = torch.Generator(device=cuda).manual_seed(3)
    off = torch.zeros(1, dtype=torch.int32, device=cuda)
    for d, dtype, q8 in ((72, torch.bfloat16, False),
                         (320, torch.bfloat16, True),
                         (6, torch.float32, False),
                         (20, torch.float32, True)):
        kp, vp, ks, vs, bt = _pool(gen, 1, 2, 2, 16, d, q8, cuda)
        if not q8:
            kp, vp = kp.to(dtype), vp.to(dtype)
        q = torch.zeros((1, 4, 8, d), dtype=dtype, device=cuda)
        with pytest.raises(ValueError):
            paged_prefill.paged_prefill_attention(q, kp, vp, bt, off,
                                                  k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("nc,chunk,p,n", [(1, 128, 64, 128), (4, 16, 16, 16),
                                          (4, 64, 24, 40)])
def test_ssd_chunk_kernel(cuda, dtype, groups, nc, chunk, p, n):
    """y_intra, state_c and cum against the plain version within the
    per-element limits of ``ref.ssd_chunk_limit``; B/C broadcast over the
    heads as a stride-0 expand (one group) or a copy (two)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import heads_of_groups
    gen = torch.Generator(device=cuda).manual_seed(8)
    bs, h = 2, 4
    ln = nc * chunk
    x = torch.randn((bs, ln, h, p), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bs, ln, h), generator=gen, device=cuda) - 1.0)
    a = -torch.rand(h, generator=gen, device=cuda) - 0.5
    bc = torch.randn((bs, ln, 2 * groups * n), generator=gen,
                     device=cuda).to(dtype)
    bm = heads_of_groups(bc[..., :groups * n].reshape(bs, ln, groups, n), h)
    cm = heads_of_groups(bc[..., groups * n:].reshape(bs, ln, groups, n), h)
    if groups == 1:
        assert bm.stride(2) == 0
    before = ops.launch_counts()["ssd_chunk"]
    got = ops.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    want = ref.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    limits = ref.ssd_chunk_limit(x, dt, a, bm, cm, got[2], chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    for g, w, lim in zip(got, want, limits):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _assert_within(g, w, lim)


@pytest.mark.parametrize("s", [32, 20])
def test_mamba_oneshot_on_card_matches_cpu(cuda, s):
    """A reduced Mamba2 on the card gives the CPU's greedy tokens; a
    chunked prompt (32) launches ssd_chunk once per layer, a scanned one
    (20) takes the counted plain scan; RMSNorm runs twice per layer and
    once more per forward."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Generator
    cfg = reduced(get_config("mamba2-2.7b"))
    params = M.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, s)).astype(np.int32)
    want = Generator(cfg, params).generate({"tokens": prompts}, 6)
    ops.reset_launch_counts()
    got = Generator(cfg, M.tree_to(params, cuda)).generate(
        {"tokens": prompts}, 6)
    n = ops.launch_counts()
    assert got.tokens == want.tokens
    chunked = s % cfg.ssm_chunk == 0 and s > cfg.ssm_chunk
    assert n["ssd_chunk"] == (cfg.n_layers if chunked else 0)
    assert n["plain_ssd_scan"] == (0 if chunked else cfg.n_layers)
    assert n["rmsnorm"] == (2 * cfg.n_layers + 1) * 6


MM_ACTS = [None, "relu", "relu2", "gelu", "silu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(256, 384), (200, 136), (104, 88)])
@pytest.mark.parametrize("m", [1, 4, 37, 500, 2048])
def test_matmul_kernels(cuda, m, k, n, dtype):
    """Both matmul kernels against their plain versions, every activation,
    with and without bias, at row counts of decode (1, 4), a ragged middle
    (37), a paged prefill (500) and a one-shot prefill (2048); K and N not
    multiples of 128, and (104, 88) not of 16 either, so the last K step
    and the last column tile are part-filled."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x, w, wu = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                for s in ((m, k), (k, n), (k, n)))
    b = torch.randn(n, generator=gen, device=cuda).to(dtype)
    for act in MM_ACTS:
        for bias in (None, b):
            before = ops.launch_counts()["matmul"]
            got = ops.matmul(x, w, bias, activation=act)
            want = ref.matmul(x, w, bias, activation=act)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (m, n)
            assert ops.launch_counts()["matmul"] == before + 1
            _assert_within(got, want, ref.matmul_limit(x, w, want, bias,
                                                       activation=act))
        got = ops.gated_matmul(x, w, wu, activation=act)
        want = ref.gated_matmul(x, w, wu, activation=act)
        torch.cuda.synchronize()
        _assert_within(got, want, ref.gated_matmul_limit(x, w, wu, want,
                                                         activation=act))


@pytest.mark.parametrize("m", [256, 4])
def test_matmul_f32_fc1_shapes(cuda, m):
    """fp32 ``matmul`` at OPT-6.7B's fc1 (K 4096, N 16384, bias, ReLU) at
    3f's prefill (256 rows, the pipelined SGEMM) and decode (4 rows, the
    weight-streaming kernel): within ``ref.matmul_limit`` and the same bits
    from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(m)
    k, n = 4096, 16384
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    b = torch.randn(n, generator=gen, device=cuda)
    got = ops.matmul(x, w, b, activation="relu")
    want = ref.matmul(x, w, b, activation="relu")
    torch.cuda.synchronize()
    _assert_within(got, want, ref.matmul_limit(x, w, want, b,
                                               activation="relu"))
    assert torch.equal(ops.matmul(x, w, b, activation="relu"), got)


def test_matmul_wrappers_raise(cuda):
    """A wrong dtype, a non-contiguous weight, a K that differs between x
    and w, a bias of another dtype, a K or N that is not a multiple of 16
    bytes, or an x off 16-byte alignment raises; nothing falls back."""
    from repro_torch.kernels import hete_matmul as H
    x = torch.zeros((4, 32), device=cuda)
    w = torch.zeros((32, 16), device=cuda)
    with pytest.raises(TypeError):
        H.matmul(x.half(), w.half())
    with pytest.raises(TypeError):
        H.gated_matmul(x, w.bfloat16(), w)
    with pytest.raises(ValueError):
        H.matmul(x, torch.zeros((16, 32), device=cuda).t())
    with pytest.raises(ValueError):
        H.gated_matmul(x, w, torch.zeros((16, 32), device=cuda).t())
    with pytest.raises(ValueError):
        H.matmul(x, torch.zeros((31, 16), device=cuda))
    with pytest.raises(ValueError):
        H.gated_matmul(x[:, :31], w, w)
    with pytest.raises(ValueError):
        H.matmul(x, w, torch.zeros(16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        H.matmul(x, w, activation="tanh")
    with pytest.raises(ValueError):
        H.matmul(x[:, :30], torch.zeros((30, 16), device=cuda))
    with pytest.raises(ValueError):
        H.gated_matmul(x.bfloat16(), *(torch.zeros((32, 12), device=cuda,
                                                   dtype=torch.bfloat16),) * 2)
    with pytest.raises(ValueError):
        H.matmul(torch.zeros(4 * 32 + 1, device=cuda)[1:].view(4, 32), w)


def test_opt_resident_on_card_matches_cpu(cuda):
    """A reduced OPT (fp32, fc1 with bias and ReLU) one-shot on the card
    gives the CPU run's greedy tokens, with one ``matmul`` launch per
    layer and forward and no gated one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Generator
    cfg = reduced(get_config("opt-6.7b"))
    params = M.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 20)).astype(np.int32)
    want = Generator(cfg, params).generate({"tokens": prompts}, 6)
    ops.reset_launch_counts()
    got = Generator(cfg, M.tree_to(params, cuda)).generate(
        {"tokens": prompts}, 6)
    n = ops.launch_counts()
    assert got.tokens == want.tokens
    assert n["matmul"] == cfg.n_layers * 6 and n["gated_matmul"] == 0


# ---------------------------------------------------------------------------
# bf16 gated_matmul (and matmul) above 48 rows: the wgmma kernel
# ---------------------------------------------------------------------------

def _bf16_operands(gen, m, k, n, pad, dev, weights=2):
    """x (M, K) as a view into rows of K + pad elements (a strided x where
    pad > 0) and weights (K, N) at the model's scale, all bf16."""
    x = torch.randn((m, k + pad), generator=gen, device=dev) \
        .to(torch.bfloat16)[:, :k]
    ws = [(torch.randn((k, n), generator=gen, device=dev) / k ** 0.5)
          .to(torch.bfloat16) for _ in range(weights)]
    return x, ws


@pytest.mark.parametrize("k,n,pad", [(5120, 14336, 0), (1000, 3000, 24),
                                     (2560, 6400, 0), (5120, 8192, 0),
                                     (4096, 8192, 0)])
@pytest.mark.parametrize("m", [49, 130, 500, 512, 2048])
def test_gated_matmul_wgmma_kernel(cuda, m, k, n, pad):
    """bf16 ``gated_matmul`` above 48 rows (the persistent wgmma kernel)
    at Mistral-NeMo-12B's widths and at a K that is no multiple of 64, an N
    that is no multiple of 128 and a strided x: within
    ``ref.gated_matmul_limit``, one launch, and the same bits from a second
    call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x, (wg, wu) = _bf16_operands(gen, m, k, n, pad, cuda)
    before = ops.launch_counts()["gated_matmul"]
    got = ops.gated_matmul(x, wg, wu, activation="silu")
    want = ref.gated_matmul(x, wg, wu, activation="silu")
    torch.cuda.synchronize()
    assert ops.launch_counts()["gated_matmul"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_within(got, want, ref.gated_matmul_limit(x, wg, wu, want,
                                                     activation="silu"))
    assert torch.equal(ops.gated_matmul(x, wg, wu, activation="silu"), got)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", MM_ACTS)
def test_matmul_bf16_wgmma_kernel(cuda, act, bias):
    """bf16 ``matmul`` above 48 rows shares the wgmma kernel with one
    weight and the bias epilogue: every activation, with and without bias,
    a strided x, K and N off the tile sizes, within ``ref.matmul_limit``
    and the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(17 + bias)
    x, (w,) = _bf16_operands(gen, 130, 1000, 3000, 8, cuda, weights=1)
    b = torch.randn(3000, generator=gen, device=cuda).to(torch.bfloat16) \
        if bias else None
    got = ops.matmul(x, w, b, activation=act)
    want = ref.matmul(x, w, b, activation=act)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.matmul_limit(x, w, want, b, activation=act))
    assert torch.equal(ops.matmul(x, w, b, activation=act), got)


# ---------------------------------------------------------------------------
# bf16 matmul: the folded wgmma kernel (M > 48) and the split-K weight stream
# (M <= 48)
# ---------------------------------------------------------------------------

def _launch_once(fn, name):
    """fn()'s result, checked to have launched kernel ``name`` once."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()[name]
    out = fn()
    assert ops.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("m,k,n,act,bias", [
    (6000, 768, 3072, "gelu", True), (16, 768, 3072, "gelu", True),
    (4, 768, 3072, "gelu", True), (2048, 18432, 73728, "relu2", False),
    (4, 18432, 73728, "relu2", False)])
def test_matmul_bf16_path_shapes(cuda, m, k, n, act, bias):
    """bf16 ``matmul`` at every shape 3l gives it (Whisper-small's MLP with
    bias and GELU over 6000, 16 and 4 rows; Nemotron-4-340B's with the
    squared ReLU over 2048 and 4 rows): within ``ref.matmul_limit``, one
    launch, the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x, (w,) = _bf16_operands(gen, m, k, n, 0, cuda, weights=1)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16) \
        if bias else None
    got = _launch_once(lambda: ops.matmul(x, w, b, activation=act), "matmul")
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = ref.matmul(x, w, b, activation=act)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.matmul_limit(x, w, want, b, activation=act))
    del want
    assert torch.equal(ops.matmul(x, w, b, activation=act), got)


@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("m", [1, 47, 48, 49, 130, 6000])
def test_matmul_bf16_rows_and_edges(cuda, m, act):
    """bf16 ``matmul`` on both sides of the route boundary (48 rows and
    below: the split-K stream; 49 and up: the folded wgmma kernel), every
    activation, without bias, with it and with a bias 2 bytes off 4-byte
    alignment (read one element at a time): K 1000 (a tail past the
    64-deep k-tiles), N 3000 (no multiple of the 192- or 256-column tiles)
    and a strided x; within ``ref.matmul_limit`` and the same bits
    twice."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(1000 + m)
    x, (w,) = _bf16_operands(gen, m, 1000, 3000, 24, cuda, weights=1)
    b = torch.randn(3001, generator=gen, device=cuda).to(torch.bfloat16)
    for bias in (None, b[:3000], b[1:]):
        got = _launch_once(lambda: ops.matmul(x, w, bias, activation=act),
                           "matmul")
        want = ref.matmul(x, w, bias, activation=act)
        torch.cuda.synchronize()
        _assert_within(got, want, ref.matmul_limit(x, w, want, bias,
                                                   activation=act))
        assert torch.equal(ops.matmul(x, w, bias, activation=act), got)


@pytest.mark.parametrize("m", [130, 2048])
def test_gated_matmul_long_k_within_limit(cuda, m):
    """bf16 ``gated_matmul`` above 48 rows at K 18432 (Nemotron-4's width;
    the two-weight wgmma kernel, whose accumulators are not folded), N
    2048, SiLU: within ``ref.gated_matmul_limit``, one launch, the same
    bits from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(18432 + m)
    x, (wg, wu) = _bf16_operands(gen, m, 18432, 2048, 0, cuda)
    got = _launch_once(lambda: ops.gated_matmul(x, wg, wu, activation="silu"),
                       "gated_matmul")
    want = ref.gated_matmul(x, wg, wu, activation="silu")
    torch.cuda.synchronize()
    _assert_within(got, want, ref.gated_matmul_limit(x, wg, wu, want,
                                                     activation="silu"))
    assert torch.equal(ops.gated_matmul(x, wg, wu, activation="silu"), got)


# ---------------------------------------------------------------------------
# bf16-q paged decode: the split-KV cluster kernel over block tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 32, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_paged_decode_bf16_split_kernel(cuda, group, ps, q8):
    """A bf16 q over bf16 or int8 pages (the split-KV cluster kernel) at GQA
    groups 1-32 (32: two clusters a kv-head), page sizes 8-128, kv_len 1,
    37, a page boundary and 3001 in one batch, with a softcap at every
    other group: within ``ref.paged_decode_attention_limit``, one launch,
    the same bits from a second call, and the same bits again with NaN in
    the pages (or, over int8 pages, the scales) wholly past kv_len and in
    the trash page."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(group * 1000 + ps + q8)
    hkv = 1 if group == 32 else 2
    hq, d = group * hkv, 128
    lens = [1, 37, 2 * ps, 3001]
    b, nb = len(lens), -(-3001 // ps) + 1
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    if not q8:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    q = torch.randn((b, hq, d), generator=gen, device=cuda).bfloat16()
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs,
              softcap=30.0 if group in (2, 8, 32) else None)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    want = ref.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    limit = ref.paged_decode_attention_limit(q, kp, vp, bt, ln, want, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within(got, want, limit)
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, ln, **kw),
                       got)
    poison = (ks, vs) if q8 else (kp, vp)
    for i in range(b):
        dead = bt[i, -(-lens[i] // ps):].long()
        for t in poison:
            t[dead] = float("nan")
    for t in poison:
        t[0] = float("nan")
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, ln, **kw),
                       got)


@pytest.mark.parametrize("d", [72, 320])
def test_paged_decode_bf16_refuses_head_dims(cuda, d):
    """A bf16 q at a head dim that is no multiple of 16 up to 256 raises
    ``ValueError`` before any launch, over bf16 and int8 pages alike."""
    from repro_torch.kernels import paged_attention
    gen = torch.Generator(device=cuda).manual_seed(d)
    kp, vp, _, _, bt = _pool(gen, 2, 2, 2, 16, d, False, cuda)
    q = torch.zeros((2, 4, d), dtype=torch.bfloat16, device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    before = paged_attention.paged_decode_attention.launches
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(q, kp.bfloat16(),
                                               vp.bfloat16(), bt, ones)
    scales = torch.ones(kp.shape[:3], device=cuda)
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(
            q, kp.to(torch.int8), vp.to(torch.int8), bt, ones,
            k_scale=scales, v_scale=scales)
    assert paged_attention.paged_decode_attention.launches == before


# ---------------------------------------------------------------------------
# bf16 ssd_chunk on the tensor cores; fp32-q paged decode split over a
# cluster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["one group, 80 heads", "two groups",
                                  "p24 n40", "b/c off 16 bytes"])
def test_ssd_chunk_bf16_tensor_cores(cuda, case):
    """The bf16 route: one group over 80 heads (one S for a run of heads,
    runs of 3 with a last run of 2), two groups (S per head), P 24 / N 40
    at chunk 64, and b/c views 2 bytes off 16-byte alignment (element
    loads): y, state_c and cum within ``ref.ssd_chunk_limit``, one launch,
    and the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import heads_of_groups
    bs, nc, chunk, h, p, n, groups, off = {
        "one group, 80 heads": (2, 2, 128, 80, 64, 128, 1, 0),
        "two groups": (2, 2, 128, 8, 64, 128, 2, 0),
        "p24 n40": (2, 3, 64, 6, 24, 40, 1, 0),
        "b/c off 16 bytes": (1, 2, 128, 4, 64, 128, 1, 1)}[case]
    gen = torch.Generator(device=cuda).manual_seed(24 + h + p)
    ln = nc * chunk
    x = torch.randn((bs, ln, h, p), generator=gen,
                    device=cuda).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn((bs, ln, h), generator=gen, device=cuda) - 1.0)
    a = -torch.rand(h, generator=gen, device=cuda) - 0.5
    bc = torch.randn((bs, ln, off + 2 * groups * n), generator=gen,
                     device=cuda).to(torch.bfloat16)
    gn = groups * n
    bm = heads_of_groups(bc[..., off:off + gn].reshape(bs, ln, groups, n), h)
    cm = heads_of_groups(bc[..., off + gn:].reshape(bs, ln, groups, n), h)
    assert (bm.stride(2) == 0) == (groups == 1)
    assert (bm.data_ptr() % 16 != 0) == bool(off)
    before = ops.launch_counts()["ssd_chunk"]
    got = ops.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    want = ref.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    limits = ref.ssd_chunk_limit(x, dt, a, bm, cm, got[2], chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    for g, w, lim in zip(got, want, limits):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _assert_within(g, w, lim)
    again = ops.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    assert all(torch.equal(u, v) for u, v in zip(again, got))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_paged_decode_f32_split_kernel(cuda, group, ps, q8):
    """An fp32 q over fp32 or int8 pages (the split-KV cluster kernel on
    the CUDA cores) at GQA groups 1, 4 and 8, page sizes 8-32, kv_len 1,
    37, a page boundary and 3001 in one batch, with a softcap at group 4:
    within ``ref.paged_decode_attention_limit``, one launch, the same bits
    from a second call, and the same bits again with NaN in the pages (or,
    over int8 pages, the scales) wholly past kv_len and in the trash
    page."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(group * 100 + ps + q8)
    hkv, d = 2, 128
    hq = group * hkv
    lens = [1, 37, 2 * ps, 3001]
    b, nb = len(lens), -(-3001 // ps) + 1
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    q = torch.randn((b, hq, d), generator=gen, device=cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, softcap=30.0 if group == 4 else None)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    want = ref.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    limit = ref.paged_decode_attention_limit(q, kp, vp, bt, ln, want, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    _assert_within(got, want, limit)
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, ln, **kw),
                       got)
    poison = (ks, vs) if q8 else (kp, vp)
    for i in range(b):
        dead = bt[i, -(-lens[i] // ps):].long()
        for t in poison:
            t[dead] = float("nan")
    for t in poison:
        t[0] = float("nan")
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, ln, **kw),
                       got)


@pytest.mark.parametrize("d,q8", [(4, False), (20, False), (64, False),
                                  (200, False), (256, False), (16, True),
                                  (48, True), (256, True)])
def test_paged_decode_f32_head_dims(cuda, d, q8):
    """An fp32 q at head dims in multiples of 4 (16 over int8 pages) up to
    256, GQA group 3 (a block of four rows, one unused): within
    ``ref.paged_decode_attention_limit``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(d + q8)
    hkv, ps = 2, 16
    lens = [5, 100, 300]
    b, nb = len(lens), -(-300 // ps)
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    q = torch.randn((b, 3 * hkv, d), generator=gen, device=cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs)
    got = ops.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    want = ref.paged_decode_attention(q, kp, vp, bt, ln, **kw)
    limit = ref.paged_decode_attention_limit(q, kp, vp, bt, ln, want, **kw)
    _assert_within(got, want, limit)


@pytest.mark.parametrize("d,q8", [(18, False), (260, False), (36, True)])
def test_paged_decode_f32_refuses_head_dims(cuda, d, q8):
    """An fp32 q at a head dim the route does not take (not a multiple of
    4, of 16 over int8 pages, or above 256) raises ``ValueError`` before
    any launch."""
    from repro_torch.kernels import paged_attention
    gen = torch.Generator(device=cuda).manual_seed(d)
    kp, vp, ks, vs, bt = _pool(gen, 2, 2, 2, 16, d, q8, cuda)
    q = torch.zeros((2, 4, d), device=cuda)
    ones = torch.ones(2, dtype=torch.int32, device=cuda)
    before = paged_attention.paged_decode_attention.launches
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(q, kp, vp, bt, ones,
                                               k_scale=ks, v_scale=vs)
    assert paged_attention.paged_decode_attention.launches == before


# ---------------------------------------------------------------------------
# the request-level sampler on the card (plain PyTorch, no kernel of its
# own): the CPU's filter, the same bits twice, rows independent, and draws
# that follow the filtered distribution
# ---------------------------------------------------------------------------

SAMPLER_KINDS = [dict(kind="greedy"),
                 dict(kind="temperature", temperature=0.8),
                 dict(kind="topk", top_k=50),
                 dict(kind="topp", top_p=0.9),
                 dict(kind="topp", top_p=1.0),
                 dict(kind="topp", top_p=0.95, top_k=64, temperature=1.5)]


def _sampler_case(cuda, v, seed):
    from repro_torch.serving import sampling as smp
    gen = torch.Generator(device=cuda).manual_seed(seed)
    # quantized to 1/16: every row holds ties
    logits = (torch.randn((len(SAMPLER_KINDS), v), generator=gen,
                          device=cuda) * 64).round() / 16
    params = [smp.SamplingParams(**kw) for kw in SAMPLER_KINDS]
    return smp, logits, params


@pytest.mark.parametrize("v", [64, 4096, 131072])
def test_sample_rows_card_filter_equals_cpu(cuda, v):
    """The card's sort order equals the CPU's (the reference's tie order);
    its kept set equals the CPU's except at tokens whose exact mass before
    them lies within (V - 1) 2^-24 of top_p (an fp32 sum in another
    order); two calls give the same bits; every draw stays in its row's
    kept set; a row moved beside other rows draws the same token."""
    smp, logits, params = _sampler_case(cuda, v, v)
    order, _, keep = smp.filter_sorted(
        logits, smp.pack_sampling(params, device=cuda))
    c_order, c_scaled, c_keep = smp.filter_sorted(
        logits.cpu(), smp.pack_sampling(params))
    assert torch.equal(order.cpu(), c_order)
    pr = torch.softmax(c_scaled.double(), dim=-1)
    top_p = torch.tensor([p.top_p for p in params], dtype=torch.float64)
    margin = (torch.cumsum(pr, -1) - pr - top_p[:, None]).abs()
    diff = keep.cpu() != c_keep
    assert bool((margin[diff] <= (v - 1) * 2.0 ** -24).all())
    keys = [smp.seed_key(100 + i) for i in range(len(params))]
    packed = smp.pack_sampling(params, device=cuda)
    a, ia = smp.sample_rows(logits, keys, packed, top_logprobs=5)
    b, ib = smp.sample_rows(logits, keys, packed, top_logprobs=5)
    assert a.device == logits.device and a.dtype == torch.int32
    assert torch.equal(a, b) and all(torch.equal(ia[k], ib[k]) for k in ia)
    kept = torch.zeros_like(keep).scatter_(-1, order, keep)
    assert bool(kept.gather(-1, a[:, None].long()).all())
    assert int(a[0]) == int(logits[0].argmax())
    moved = torch.stack([logits[3], logits[1], logits[5]])
    sub = [params[3], params[1], params[5]]
    c = smp.sample_rows(moved, [keys[3], keys[1], keys[5]],
                        smp.pack_sampling(sub, device=cuda))
    assert c.tolist() == [int(a[3]), int(a[1]), int(a[5])]


def test_sample_rows_card_draws_follow_distribution(cuda):
    """2^14 card draws of one top-p 0.95 / top-k 64 row at temperature 1.5
    against the CPU's filtered distribution: chi-square p > 1e-3 (bins
    expecting fewer than five draws merged)."""
    from scipy import stats
    smp, logits, params = _sampler_case(cuda, 4096, 7)
    row, p = logits[5:6], params[5]
    n = 1 << 14
    keys = [smp.fold_in(smp.seed_key(7), j) for j in range(n)]
    toks = smp.sample_rows(row.expand(n, -1), keys,
                           smp.pack_sampling([p] * n, device=cuda))
    counts = torch.bincount(toks.long(), minlength=4096).cpu().double()
    order, scaled, keep = smp.filter_sorted(row.cpu(),
                                            smp.pack_sampling([p]))
    pr = torch.softmax(scaled.double(), dim=-1) * keep
    want = torch.zeros_like(pr).scatter_(-1, order, pr / pr.sum())[0] * n
    assert float(counts[want == 0].sum()) == 0.0
    big = want >= 5
    obs = np.append(counts[big].numpy(), counts[~big].sum().item())
    exp = np.append(want[big].numpy(), want[~big].sum().item())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue > 1e-3


def test_sampler_noise_card_equals_cpu(cuda):
    """The Gumbel noise is integer arithmetic on the step keys: the card's
    equals the CPU's (the log in float64 within 1 ulp of fp32), so a row
    draws the same token on both wherever no two scores lie within that
    rounding of each other."""
    from repro_torch.serving import sampling as smp
    keys = [smp.seed_key(s) for s in range(8)] + [0, (1 << 64) - 1]
    mix_cpu = smp._mix64_t(smp.key_tensor(keys))
    assert torch.equal(smp._mix64_t(smp.key_tensor(keys, cuda)).cpu(),
                       mix_cpu)
    g = smp.gumbel_noise(smp.key_tensor(keys, cuda), 131072).cpu()
    torch.testing.assert_close(g, smp.gumbel_noise(smp.key_tensor(keys),
                                                   131072),
                               rtol=1.2e-7, atol=1e-7)


def test_sample_rows_in_cuda_graph(cuda):
    """Given tensors only (logits, a key tensor, packed parameters),
    ``sample_rows`` is a fixed chain of device operations: a CUDA graph
    captures it, and its replay gives the eager call's tokens and
    logprobs for new logits and keys copied into the same buffers."""
    smp, logits, params = _sampler_case(cuda, 4096, 11)
    packed = smp.pack_sampling(params, device=cuda)
    keys = smp.key_tensor([smp.seed_key(i) for i in range(len(params))],
                          cuda)
    static_l, static_k = logits.clone(), keys.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        smp.sample_rows(static_l, static_k, packed, top_logprobs=3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, info = smp.sample_rows(static_l, static_k, packed,
                                    top_logprobs=3)
    new_l = logits.flip(-1)
    new_k = smp.key_tensor([smp.seed_key(50 + i)
                            for i in range(len(params))], cuda)
    static_l.copy_(new_l)
    static_k.copy_(new_k)
    graph.replay()
    want, winfo = smp.sample_rows(new_l, new_k, packed, top_logprobs=3)
    assert torch.equal(out, want)
    assert all(torch.equal(info[k], winfo[k]) for k in info)


# ---------------------------------------------------------------------------
# speculative decoding on the card: verify-shaped paged prefill, greedy
# identity, the model drafter and the event loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,q8", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.bfloat16, False),
                                      (torch.bfloat16, True)])
@pytest.mark.parametrize("s", [2, 3, 4, 5])
def test_paged_prefill_verify_shapes(cuda, dtype, q8, s):
    """A verify batch: 4 rows of S = k + 1 queries at ragged kv offsets;
    rows 1 and 3 carry one real token and S - 1 pads, so their block
    tables end at the trash page past kv_len + 1, as the batcher exports
    them.  Within ``ref.paged_prefill_attention_limit`` of the plain
    version, one launch, the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(40 + s)
    b, hq, hkv, d, ps = 4, 8, 2, 128, 16
    offs = (47, 52, 63, 69)
    nb = max(-(-(o + s) // ps) for o in offs)
    kp, vp, ks, vs, bt = _pool(gen, b, hkv, nb, ps, d, q8, cuda)
    if not q8:
        kp, vp = kp.to(dtype), vp.to(dtype)
    for i in (1, 3):
        bt[i, -(-(offs[i] + 1) // ps):] = 0
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs)
    before = ops.launch_counts()["paged_prefill_attention"]
    got = ops.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    assert ops.launch_counts()["paged_prefill_attention"] == before + 1
    want = ref.paged_prefill_attention(q, kp, vp, bt, off, **kw)
    limit = ref.paged_prefill_attention_limit(q, kp, vp, bt, off, want,
                                              **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _assert_within(got, want, limit)
    assert torch.equal(ops.paged_prefill_attention(q, kp, vp, bt, off, **kw),
                       got)


def _spec_prompts(vocab, n=4, run=6, length=24, seed=9):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, vocab, run)]
             * (length // run + 1))[:length] for _ in range(n)]


@pytest.mark.parametrize("arch", ["opt-6.7b", "mistral-nemo-12b"])
def test_spec_greedy_on_card_equals_plain(cuda, arch):
    """Greedy speculation (prompt lookup, k 4) on the card gives the
    plain paged run's tokens: reduced OPT offloaded through
    ``HeteGenBackend(tile=16)`` (a verify engine of its own), reduced
    Mistral resident; the verify forwards launch the paged prefill
    kernel and no plain attention."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM
    from repro_torch.serving.backends import HeteGenBackend
    from repro_torch.serving.speculative import NgramDrafter, SpecConfig
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device=cuda)
    prompts = _spec_prompts(cfg.vocab_size)

    def serve(spec):
        kw = dict(paged=True, max_slots=4, max_len=64, page_size=16,
                  spec=spec)
        if arch == "opt-6.7b":
            kw.update(backend=HeteGenBackend(
                cfg, M.tree_to(params, "cpu"), batch=4, tile=16,
                device=cuda), own_backend=True)
            llm = LLM(cfg, **kw)
        else:
            llm = LLM(cfg, params, **kw)
        with llm:
            ops.reset_launch_counts()
            outs = llm.generate(prompts, max_new=12)
            st = llm.stats()
        return [o.tokens for o in outs], st, ops.launch_counts()

    base, _, _ = serve(None)
    got, st, n = serve(SpecConfig(NgramDrafter(), k=4))
    assert got == base
    assert st["spec"]["drafted"] > 0
    assert n["paged_prefill_attention"] > 0
    assert n["plain_dense_attention"] == 0
    if arch == "opt-6.7b":
        assert "verify" in st["phase_alpha"]


def test_model_drafter_self_draft_on_card(cuda):
    """The target model as its own drafter on the card (a dense cache per
    request, flash and decode kernels): the tokens are the plain run's
    and nearly every draft is accepted."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM
    from repro_torch.serving.speculative import ModelDrafter, SpecConfig
    cfg = reduced(get_config("opt-6.7b"))
    params = M.init_params(cfg, 0, device=cuda)
    prompts = _spec_prompts(cfg.vocab_size, n=2, seed=10)
    with LLM(cfg, params, paged=True, max_slots=2, max_len=64) as llm:
        base = [o.tokens for o in llm.generate(prompts, max_new=10)]
    drafter = ModelDrafter(cfg, params, max_len=64)
    assert drafter.device.type == "cuda"
    with LLM(cfg, params, paged=True, max_slots=2, max_len=64,
             spec=SpecConfig(drafter, k=3)) as llm:
        got = [o.tokens for o in llm.generate(prompts, max_new=10)]
        st = llm.stats()["spec"]
    drafter.close()
    assert got == base
    assert st["drafted"] > 0 and st["acceptance_rate"] >= 0.9


def test_async_llm_on_card(cuda):
    """AsyncLLM's loop thread launches the kernels on the card (it enters
    the backend's device) and streams the synchronous facade's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM, AsyncLLM
    cfg = get_config("tiny")
    params = M.init_params(cfg, 0, device=cuda)
    prompts = _spec_prompts(cfg.vocab_size, n=3, seed=11)
    with LLM(cfg, params, paged=True, max_slots=4, max_len=64) as llm:
        rids = [llm.submit(p, 8) for p in prompts]
        out = llm.drain()
        want = [out[r].tokens for r in rids]
    ops.reset_launch_counts()
    with AsyncLLM(cfg, params, paged=True, max_slots=4,
                  max_len=64) as allm:
        assert allm.llm.device.type == "cuda"
        its = [allm.stream(p, 8) for p in prompts]
        got = [list(it) for it in its]
    n = ops.launch_counts()
    assert got == want
    assert n["paged_prefill_attention"] > 0 and n["paged_decode_attention"] > 0


FAMILIES = ["gemma2-2b", "minicpm3-4b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-a17b", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_card_tokens_equal_cpu(cuda, arch):
    """A reduced model of each scan-stacked family, fp32: one-shot
    generation on the card (attention, norms, MLP first stages and SSD
    chunks through the kernels) gives the CPU's greedy tokens; the
    kernels the family reaches were launched (MLA attends in plain
    code)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    prompts = [list(map(int, r)) for r in np.random.default_rng(12)
               .integers(0, cfg.vocab_size, (3, 48))]
    with LLM(cfg, params, device="cpu") as llm:
        want = [o.tokens for o in llm.generate(prompts, max_new=8)]
    ops.reset_launch_counts()
    with LLM(cfg, M.tree_to(params, cuda)) as llm:
        got = [o.tokens for o in llm.generate(prompts, max_new=8)]
        assert llm.last_executor == "generator"
    n = ops.launch_counts()
    assert got == want
    assert n["rmsnorm"] > 0 and n["gated_matmul"] > 0
    if cfg.attn_kind != "mla":
        assert n["flash_attention"] > 0 and n["decode_attention"] > 0
    if cfg.family == "hybrid":
        assert n["ssd_chunk"] > 0 and n["plain_ssd_scan"] == 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "minicpm3-4b",
                                  "llama4-scout-17b-16e"])
def test_scan_resident_batcher_on_card(cuda, arch):
    """The dense batcher's ScanResidentBackend on the card, with chunked
    admissions and ragged budgets, gives the CPU batcher's tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.backends import ScanResidentBackend
    from repro_torch.serving.batcher import ContinuousBatcher
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (5, 11, 8, 11)]

    def serve(device):
        b = ContinuousBatcher(cfg, M.tree_to(params, device), max_slots=2,
                              max_len=40, chunk_tokens=6, device=device)
        assert isinstance(b.backend, ScanResidentBackend)
        rids = [b.submit(p, n) for p, n in zip(prompts, (5, 7, 5, 7))]
        out = b.run_until_done()
        b.close()
        return [out[r] for r in rids]

    assert serve(cuda) == serve("cpu")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e",
                                  "llama4-maverick-400b-a17b"])
def test_moe_layer_on_card_equals_cpu(cuda, arch):
    """The MoE layer in fp32 on the card and on the CPU: the same experts
    and capacity drops (at a group of 8 tokens and capacity factor 1.25)
    and outputs within 1e-5 of the largest |value|, at prefill and at
    dropless decode."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              capacity_factor=1.25, moe_group_size=8)
    params = M.init_params(cfg, 0, device="cpu")
    j = 1 if arch.startswith("llama4-maverick") else 0
    p = M._pick(params["blocks"][f"pos{j}"]["moe"], 0)
    pc = M.tree_to(p, cuda)
    rng = np.random.default_rng(14)
    x = torch.from_numpy((rng.standard_normal(cfg.d_model) + 0.5
                          * rng.standard_normal((2, 12, cfg.d_model)))
                         .astype(np.float32))
    r_cpu = L.moe_route(cfg, p, x.reshape(3, 8, -1), capacity=3)
    r_card = L.moe_route(cfg, pc, x.to(cuda).reshape(3, 8, -1), capacity=3)
    for a, b in zip(r_cpu, r_card):
        assert torch.equal(a, b.cpu()) if a.dtype != torch.float32 \
            else torch.allclose(a, b.cpu(), rtol=1e-5, atol=1e-6)
    assert not bool(r_cpu[3].all())
    for xs in (x, x[:, :1]):
        want = L.moe(cfg, p, xs)
        got = L.moe(cfg, pc, xs.to(cuda)).cpu()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the bf16 attention kernels at every head dim in multiples of 16 (192:
# Nemotron-4-340B's, at its GQA group of 12), and bf16 matmul with GELU and
# squared ReLU (Whisper's and Nemotron's MLPs)
# ---------------------------------------------------------------------------

NEW_HEAD_DIMS = [48, 80, 96, 112, 144, 160, 176, 192, 208, 224, 240]


def _heads(d):
    """Nemotron's 96 / 8 heads cut to one kv-head's group of 12 at its
    head dim; a group of 4 elsewhere."""
    return (24, 2) if d == 192 else (8, 2)


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_flash_attention_bf16_head_dims(cuda, d):
    """bf16 flash attention, causal over a strided cache view and
    non-causal with Sq != Skv (Whisper's cross attention: a 4-token
    prompt over 1500 frames), within ``ref.flash_attention_limit``, one
    launch each."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(d)
    hq, hkv = _heads(d)
    for causal, sq, skv in ((True, 77, 77), (False, 4, 1500),
                            (False, 130, 130)):
        k, v, _, _ = _dense_cache(gen, 2, hkv, skv + 8, d, torch.bfloat16,
                                  "bhtd", cuda)
        k, v = k[:, :, :skv], v[:, :, :skv]
        q = torch.randn((2, sq, hq, d), generator=gen, device=cuda) \
            .to(torch.bfloat16).transpose(1, 2)
        before = ops.launch_counts()["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal)
        assert ops.launch_counts()["flash_attention"] == before + 1
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _assert_within(got, want, ref.flash_attention_limit(
            q, k, v, want, causal=causal))


@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_decode_attention_bf16_head_dims(cuda, d, kvdt):
    """The split-KV decode over a bf16 or int8 cache in both layouts at
    kv_len 0, 1, 65, 527 and T: within ``ref.decode_attention_limit``,
    one launch, a row with no key writing 0."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    hq, hkv = _heads(d)
    t = 528
    lens = [0, 1, 65, t - 1, t]
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for layout in ("bhtd", "bthd"):
        k, v, ks, vs = _dense_cache(gen, len(lens), hkv, t, d, kvdt, layout,
                                    cuda)
        q = torch.randn((len(lens), hq, d), generator=gen,
                        device=cuda).to(torch.bfloat16)
        kw = dict(k_scale=ks, v_scale=vs)
        before = ops.launch_counts()["decode_attention"]
        got = ops.decode_attention(q, k, v, kl, **kw)
        assert ops.launch_counts()["decode_attention"] == before + 1
        want = ref.decode_attention(q, k, v, kl, **kw)
        torch.cuda.synchronize()
        _assert_within(got, want,
                       ref.decode_attention_limit(q, k, v, kl, want, **kw))
        assert not bool(got[0].float().any())


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_paged_kernels_bf16_head_dims(cuda, d, q8):
    """bf16 paged prefill (a chunk at an offset and one from 0, a
    window) and paged decode (kv_len 1, 37 and 3001) over bf16 or int8
    pages, within their ``ref.*_limit``, one launch each."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(d + 2 * q8)
    hq, hkv = _heads(d)
    ps, s, offs = 16, 37, (0, 21)
    nb = -(-3001 // ps) + 1
    kp, vp, ks, vs, bt = _pool(gen, 3, hkv, nb, ps, d, q8, cuda)
    if not q8:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    q = torch.randn((2, hq, s, d), generator=gen, device=cuda).bfloat16()
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    for window in (None, 9):
        kw = dict(k_scale=ks, v_scale=vs, window=window)
        before = ops.launch_counts()["paged_prefill_attention"]
        got = ops.paged_prefill_attention(q, kp, vp, bt[:2], off, **kw)
        assert ops.launch_counts()["paged_prefill_attention"] == before + 1
        want = ref.paged_prefill_attention(q, kp, vp, bt[:2], off, **kw)
        limit = ref.paged_prefill_attention_limit(q, kp, vp, bt[:2], off,
                                                  want, **kw)
        torch.cuda.synchronize()
        _assert_within(got, want, limit)
    qd = torch.randn((3, hq, d), generator=gen, device=cuda).bfloat16()
    ln = torch.tensor([1, 37, 3001], dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(qd, kp, vp, bt, ln, **kw)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = ref.paged_decode_attention(qd, kp, vp, bt, ln, **kw)
    limit = ref.paged_decode_attention_limit(qd, kp, vp, bt, ln, want, **kw)
    torch.cuda.synchronize()
    _assert_within(got, want, limit)


@pytest.mark.parametrize("d", [72, 320])
def test_bf16_attention_refuses_head_dims(cuda, d):
    """A bf16 head dim that is no multiple of 16, or above 256, raises
    ``ValueError`` in every bf16 attention kernel, before any launch."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(d)
    bf = torch.bfloat16
    before = ops.launch_counts()
    q = torch.zeros((1, 4, 8, d), device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    k = torch.zeros((1, 2, 8, d), device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[:, :, 0], k, k,
                             torch.ones(1, dtype=torch.int32, device=cuda))
    kp, vp, _, _, bt = _pool(gen, 1, 2, 2, 16, d, False, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_prefill_attention(q, kp.bfloat16(), vp.bfloat16(), bt,
                                    torch.zeros(1, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode_attention(q[:, :, 0].contiguous(), kp.bfloat16(),
                                   vp.bfloat16(), bt,
                                   torch.ones(1, dtype=torch.int32,
                                              device=cuda))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("act,bias", [("gelu", True), ("relu2", False)])
@pytest.mark.parametrize("m", [4, 130])
def test_matmul_bf16_model_activations(cuda, m, act, bias):
    """bf16 ``matmul`` at Whisper's MLP (768 -> 3072, bias, GELU) and a
    Nemotron-like squared ReLU without bias, at decode rows (4: the
    M <= 48 route) and prefill rows (130: the wgmma kernel), within
    ``ref.matmul_limit``, the same bits from a second call."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(m)
    k, n = (768, 3072) if act == "gelu" else (1536, 6144)
    x, (w,) = _bf16_operands(gen, m, k, n, 0, cuda, weights=1)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16) \
        if bias else None
    before = ops.launch_counts()["matmul"]
    got = ops.matmul(x, w, b, activation=act)
    assert ops.launch_counts()["matmul"] == before + 1
    want = ref.matmul(x, w, b, activation=act)
    torch.cuda.synchronize()
    _assert_within(got, want, ref.matmul_limit(x, w, want, b, activation=act))
    assert torch.equal(ops.matmul(x, w, b, activation=act), got)


@pytest.mark.parametrize("m", [4, 130])
def test_matmul_bf16_long_k_folds_accumulator(cuda, m):
    """At Nemotron-4's K = 18432 the tensor cores' truncating accumulation
    alone lies up to 5.5 units of ``ref._product_bound`` from the exact
    product (cuBLAS's too); the kernels fold their accumulator into an
    fp32 total every 512 columns of K, so the sum stays within one unit
    where the output is small enough for bf16 to show it, and the squared
    ReLU's output within ``ref.matmul_limit``."""
    import math
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(18432 + m)
    k, n = 18432, 2048
    x, (w,) = _bf16_operands(gen, m, k, n, 0, cuda, weights=1)
    y = ops.matmul(x, w).double()
    xd, wd = x.double(), w.double()
    z = xd @ wd
    unit = 2.0 ** -24 * math.sqrt(k) * (((xd * xd) @ (wd * wd)).sqrt()
                                       + z.abs())
    small = z.abs() < 2e-4                   # bf16 resolves the fp32 sum
    assert int(small.sum()) > 0
    assert float(((y - z).abs() / unit)[small].max()) <= 1.0
    got = ops.matmul(x, w, activation="relu2")
    want = ref.matmul(x, w, activation="relu2")
    _assert_within(got, want, ref.matmul_limit(x, w, want,
                                               activation="relu2"))


# ---------------------------------------------------------------------------
# The sharded path's kernel sites (repro_torch.distributed.local)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh1(cuda):
    """A (1, 1) ("data", "model") mesh over an NCCL world of one rank."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cuda")
    finally:
        dist.destroy_process_group()


def _dt(t, mesh, *placements):
    from torch.distributed.tensor import DTensor, Replicate
    pl = list(placements) + [Replicate()] * (mesh.ndim - len(placements))
    return DTensor.from_local(t, mesh, pl, run_check=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_kernel_sites_bit_equal(mesh1, dtype):
    """Every kernel site of the sharded path, called on DTensors of a
    world-1 mesh (batch on "data", heads / ff on "model"), gives the bits
    of the plain call of the same kernel on the same tensors."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import local as DL
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(11)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x = rnd(4, 8, 256)
    w = rnd(256)
    got = DL.rmsnorm(_dt(x, mesh1, Shard(0)), w, eps=1e-6).to_local()
    assert torch.equal(got, ops.rmsnorm(x, w, eps=1e-6))

    wg, wu, wi, bi = rnd(256, 512), rnd(256, 512), rnd(256, 512), rnd(512)
    got = DL.mlp_in(_dt(x, mesh1, Shard(0)), _dt(wg, mesh1, Replicate(),
                                                 Shard(1)),
                    _dt(wu, mesh1, Replicate(), Shard(1)),
                    activation="silu", gated=True).to_local()
    want = ops.gated_matmul(x.reshape(-1, 256), wg, wu, activation="silu")
    assert torch.equal(got.reshape(-1, 512), want)
    got = DL.mlp_in(_dt(x, mesh1, Shard(0)), _dt(wi, mesh1, Replicate(),
                                                 Shard(1)),
                    bias=_dt(bi, mesh1, Replicate(), Shard(0)),
                    activation="relu2", gated=False).to_local()
    want = ops.matmul(x.reshape(-1, 256), wi, bi, activation="relu2")
    assert torch.equal(got.reshape(-1, 512), want)

    q, k, v = rnd(4, 8, 128), rnd(4, 2, 300, 128), rnd(4, 2, 300, 128)
    lens = torch.tensor([300, 200, 17, 1], dtype=torch.int32, device=dev)
    for kp in (Shard(1), Shard(2)):          # heads, or the sequence
        got = DL.decode_attention(_dt(q, mesh1, Shard(0), Shard(1)),
                                  _dt(k, mesh1, Shard(0), kp),
                                  _dt(v, mesh1, Shard(0), kp),
                                  lens).to_local()
        # on a sequence-sharded cache one rank holds every key, and the
        # combine of one member weighs its output by exp(0) = 1
        assert torch.equal(got, ops.decode_attention(q, k, v, lens))

    qf, kf, vf = rnd(2, 8, 64, 128), rnd(2, 2, 64, 128), rnd(2, 2, 64, 128)
    got = DL.flash_attention(_dt(qf, mesh1, Shard(0), Shard(1)),
                             _dt(kf, mesh1, Shard(0), Shard(1)),
                             _dt(vf, mesh1, Shard(0), Shard(1))).to_local()
    assert torch.equal(got, ops.flash_attention(qf, kf, vf))

    xs = rnd(2, 64, 4, 64)
    dt = torch.rand(2, 64, 4, generator=g, device=dev) * 0.1
    a = -torch.rand(4, generator=g, device=dev)
    bs = torch.randn(2, 64, 4, 16, generator=g, device=dev).to(dtype)
    cs = torch.randn(2, 64, 4, 16, generator=g, device=dev).to(dtype)
    got = DL.ssd_chunk(_dt(xs, mesh1, Shard(0), Shard(2)),
                       _dt(dt, mesh1, Shard(0), Shard(2)), a,
                       _dt(bs, mesh1, Shard(0), Shard(2)),
                       _dt(cs, mesh1, Shard(0), Shard(2)), chunk=32)
    want = ops.ssd_chunk(xs, dt, a, bs, cs, chunk=32)
    for gg, ww in zip(got, want):
        assert torch.equal(gg.to_local(), ww)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.float32, 40),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 192)])
def test_decode_attention_lse(cuda, dtype, d):
    """The kernel's log-sum-exp (return_lse) against its plain version's:
    -inf on the same rows (no key), elsewhere within 1e-3; the output the
    same bits as a call without it."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(6, 8, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(6, 2, 700, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(6, 2, 700, d, generator=g, device="cuda").to(dtype)
    lens = torch.tensor([700, 699, 333, 64, 1, 0], dtype=torch.int32,
                        device="cuda")
    o, lse = ops.decode_attention(q, k, v, lens, softcap=30.0,
                                  return_lse=True)
    assert torch.equal(o, ops.decode_attention(q, k, v, lens, softcap=30.0))
    _, want = ref.decode_attention(q, k, v, lens, softcap=30.0,
                                   return_lse=True)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(lse))
    assert not bool(fin[-1].any())
    assert float((lse[fin] - want[fin]).abs().max()) <= 1e-3


def test_sequence_split_decode_combine(cuda):
    """Two halves of the keys, each through the kernel with its
    log-sum-exp, combined as the sharded decode combines ranks, against
    the whole cache: within the whole call's own distance from the plain
    version, doubled."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(4, 8, 128, generator=g, device="cuda")
    k = torch.randn(4, 2, 512, 128, generator=g, device="cuda")
    v = torch.randn(4, 2, 512, 128, generator=g, device="cuda")
    lens = torch.tensor([512, 300, 256, 7], dtype=torch.int32, device="cuda")
    parts = []
    for lo in (0, 256):
        ll = (lens - lo).clamp(0, 256).to(torch.int32)
        parts.append(ops.decode_attention(q, k[:, :, lo:lo + 256],
                                          v[:, :, lo:lo + 256], ll,
                                          return_lse=True))
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.where(torch.isinf(p[1]), 0.0, torch.exp(p[1] - m))
         for p in parts]
    got = (parts[0][0] * w[0][..., None] + parts[1][0] * w[1][..., None]) \
        / (w[0] + w[1])[..., None]
    whole = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention(q, k, v, lens)
    lim = 2 * float((whole - want).abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= lim


def test_dryrun_cell_on_card(cuda):
    """``run_cell`` with device cuda on rank 0 of a fake (16, 16) world:
    tiny x decode_32k executes; its argument bytes equal the analytic
    params plus cache, and the kernels launched on the card."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json; from repro_torch.launch import dryrun as DR; "
            "r = DR.run_cell('tiny', 'decode_32k', 'single', "
            "device='cuda', verbose=False); "
            "print(json.dumps({k: r.get(k) for k in ('status', 'memory', "
            "'launches', 'step_ms', 'traceback')}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec["traceback"]
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["analytic"]["params"] \
        + mem["analytic"]["cache"]
    assert mem["measured_peak_bytes"] >= mem["argument_bytes"]
    assert rec["launches"].get("decode_attention", 0) > 0
    assert rec["step_ms"] > 0
