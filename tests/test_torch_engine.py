"""The port's HeteGen engine and pinned rings on the CPU (device="cpu").

``HeteGenEngine.linear`` must equal ``x @ W + b`` in every placement mode
over an alpha grid, on both wires (fp: atol 1e-5; q8: within the
per-column quantization bound), and under q8 the host columns must be
bit-equal to the JAX engine's (both are numpy GEMMs on the same fp
weights).  The parameter manager must hand back exactly the staged bytes
and keep at most two slots per group."""
import numpy as np
import pytest
import torch

from repro.core.engine import HeteGenEngine as JEngine
from repro.core.engine import ModulePlan as JPlan
from repro_torch.core.engine import HeteGenEngine, ModulePlan
from repro_torch.core.param_manager import (AsyncParamManager,
                                            plan_prefetch_order)

ALPHAS = (0.0, 0.25, 0.5, 0.8, 1.0)


def _weights(rng, n=3, k=48, m=64):
    w = {f"l{i}": rng.standard_normal((k, m)).astype(np.float32)
         for i in range(n)}
    b = {f"l{i}": rng.standard_normal((m,)).astype(np.float32)
         for i in range(n)}
    return w, b


@pytest.mark.parametrize("mode", ["resident", "hetegen", "stream", "host"])
@pytest.mark.parametrize("wstream", ["fp", "q8"])
def test_linear_matches_dense(mode, wstream):
    rng = np.random.default_rng(0)
    w, b = _weights(rng)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    for a in (ALPHAS if mode == "hetegen" else (1.0,)):
        plan = [ModulePlan(n, "g", mode, a) for n in w]
        eng = HeteGenEngine(w, plan, biases=b, tile=16, device="cpu",
                            wstream=wstream)
        try:
            eng.warm_prefetch()
            for n in w:
                got = eng.linear(torch.from_numpy(x), n).numpy()
                want = x @ w[n] + b[n]
                cols = eng._dev_cols.get(n, 0)
                if wstream == "fp" or mode in ("resident", "host"):
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5)
                else:
                    bound = (np.abs(x).sum(-1, keepdims=True)
                             * np.abs(w[n][:, :cols]).max(0) / 127.0)
                    assert (np.abs(got[..., :cols] - want[..., :cols])
                            <= bound + 1e-5).all()
                    np.testing.assert_allclose(got[..., cols:],
                                               want[..., cols:],
                                               rtol=1e-5, atol=1e-5)
        finally:
            eng.close()


def test_q8_host_columns_bit_equal_to_jax_engine():
    rng = np.random.default_rng(1)
    w, b = _weights(rng, n=2)
    x = rng.standard_normal((3, 48)).astype(np.float32)
    plan_t = [ModulePlan(n, "g", "hetegen", 0.5) for n in w]
    plan_j = [JPlan(n, "g", "hetegen", 0.5) for n in w]
    eng = HeteGenEngine(w, plan_t, biases=b, tile=16, device="cpu",
                        wstream="q8")
    jeng = JEngine(w, plan_j, biases=b, tile=16, wstream="q8")
    try:
        for n in w:
            cols = eng._dev_cols[n]
            assert cols == jeng._dev_cols[n] and 0 < cols < 64
            got = eng.linear(torch.from_numpy(x), n).numpy()
            want = np.asarray(jeng.linear(x, n))
            np.testing.assert_array_equal(got[:, cols:], want[:, cols:])
            np.testing.assert_allclose(got[:, :cols], want[:, :cols],
                                       rtol=2e-4, atol=2e-4)
            # the staged wire format is JAX's, bit for bit
            tq, ts = eng.manager.weights[n]
            jq, js = jeng.manager.weights[n]
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(ts, js)
    finally:
        eng.close()
        jeng.close()


def test_stream_stats_and_partition_views():
    rng = np.random.default_rng(2)
    w, b = _weights(rng)
    plan = [ModulePlan(n, "g", "hetegen", 0.5) for n in w]
    eng = HeteGenEngine(w, plan, biases=b, tile=16, device="cpu")
    try:
        x = torch.from_numpy(rng.standard_normal((4, 48)).astype(np.float32))
        for _ in range(2):
            for n in w:
                eng.linear(x, n)
        st = eng.finish_stats()
        assert st.cpu > 0 and st.pin > 0 and st.trans > 0 and st.dev > 0
        assert st.wall >= st.dev
        # partitions are views of the caller's weights: no second copy
        for n in w:
            assert np.shares_memory(eng._host_part[n], w[n])
            assert np.shares_memory(eng.manager.weights[n], w[n])
        assert eng.pinned_overhead_bytes() == 2 * 48 * 32 * 4
    finally:
        eng.close()


def test_engine_rejects_unknown_wire():
    with pytest.raises(ValueError):
        HeteGenEngine({}, [], device="cpu", wstream="fp8")


def test_param_manager_exact_bytes_and_ring_bound():
    rng = np.random.default_rng(3)
    full = rng.standard_normal((8, 24)).astype(np.float32)
    weights = {"a": full[:, :8], "b": np.ascontiguousarray(full[:, 8:]),
               "c": (rng.integers(-127, 127, (8, 8)).astype(np.int8),
                     rng.standard_normal(8).astype(np.float32))}
    groups = {"a": "g", "b": "g", "c": "h"}
    mgr = AsyncParamManager(weights, groups, pinned=False)
    try:
        assert mgr.prefetch("a") and mgr.prefetch("b")
        got = mgr.acquire("a")
        np.testing.assert_array_equal(got.numpy(), weights["a"])
        mgr.release("a")
        got = mgr.acquire("b")
        np.testing.assert_array_equal(got.numpy(), weights["b"])
        mgr.release("b")
        q, s = mgr.acquire("c")
        np.testing.assert_array_equal(q.numpy(), weights["c"][0])
        np.testing.assert_array_equal(s.numpy(), weights["c"][1])
        assert q.data_ptr() % 64 == 0 and s.data_ptr() % 64 == 0
        mgr.release("c")
        assert len(mgr.rings["g"].slots) == 2
        assert mgr.pinned_overhead_bytes() == 2 * (8 * 16 * 4) \
            + 2 * (64 + 8 * 4)
    finally:
        mgr.shutdown()
    order = plan_prefetch_order(["a", "b", "c"], groups)
    assert order == {"a": "b", "b": "a", "c": None}
