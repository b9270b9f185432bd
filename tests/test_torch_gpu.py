"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes, plus the offload engine on the card.  Every
test carries the ``gpu`` marker and skips without a CUDA device; this
file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 for fp32 pages, 2e-4 for int8 pages, 1e-5 relative for
the int8-weight matmul (fp32 arithmetic; different summation orders).
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
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels import q8_matmul
    x = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        q8_matmul.q8_matmul(x, torch.zeros((4, 3), device=cuda),
                            torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        q8_matmul.q8_matmul(x.t(), torch.zeros((2, 3), dtype=torch.int8,
                                               device=cuda),
                            torch.ones(3, device=cuda))


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
