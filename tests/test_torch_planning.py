"""The port's pure planning code gives the JAX package's numbers exactly:
alpha law, tile quantization, decisions, the alpha benchmark's refinement,
residency scheduling and whole placement plans (OPT-6.7B's linears on
the paper's A10 rig, prefill and decode, fp and q8 wires, with and
without a residency budget).  Also the copied telemetry surfaces."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.core import alpha as ja
from repro.core import alpha_benchmark as jab
from repro.core import hw as jhw
from repro.core import module_scheduler as jms
from repro.core import policy as jpol
from repro.serving.backends import enumerate_linears as j_enum
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.core import alpha as ta
from repro_torch.core import alpha_benchmark as tab
from repro_torch.core import hw as thw
from repro_torch.core import module_scheduler as tms
from repro_torch.core import policy as tpol
from repro_torch.serving.backends import enumerate_linears as t_enum
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracer import NULL_TRACER, Tracer


def _plan_tuple(res):
    return ([dataclasses.astuple(p) for p in res.plan], res.alpha,
            res.predicted_step_time, res.resident_bytes, res.batch,
            res.phase, res.tokens_per_seq, res.wstream,
            None if res.schedule is None else
            (res.schedule.resident, res.schedule.offloaded,
             res.schedule.used_bytes))


def test_configs_equal():
    for name in ("tiny", "opt-125m", "opt-6.7b", "opt-30b", "mamba2-2.7b"):
        assert dataclasses.asdict(tget(name)) == \
            dataclasses.asdict(jget(name))
    from repro.configs import reduced as jreduced
    assert dataclasses.asdict(treduced(tget("opt-6.7b"), layers=3)) == \
        dataclasses.asdict(jreduced(jget("opt-6.7b"), layers=3))
    assert dataclasses.asdict(treduced(tget("mamba2-2.7b"))) == \
        dataclasses.asdict(jreduced(jget("mamba2-2.7b")))


@pytest.mark.parametrize("wire", ["fp", "q8"])
@pytest.mark.parametrize("phase,batch,tokens", [
    ("decode", 1, None), ("decode", 4, None), ("prefill", 2, 96),
    ("prefill", 1, None)])
@pytest.mark.parametrize("budget", [None, 4e9])
def test_build_policy_plans_equal(wire, phase, batch, tokens, budget):
    cfg = jget("opt-6.7b")
    want = jpol.build_policy(j_enum(cfg, wire), jhw.PAPER_A10,
                             budget_bytes=budget, batch=batch, phase=phase,
                             tokens_per_seq=tokens)
    got = tpol.build_policy(t_enum(tget("opt-6.7b"), wire), thw.PAPER_A10,
                            budget_bytes=budget, batch=batch, phase=phase,
                            tokens_per_seq=tokens)
    assert _plan_tuple(got) == _plan_tuple(want)


def test_alpha_law_and_decide_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        v = rng.uniform(1e9, 2e11, 4)
        n_out = int(rng.integers(1, 20000))
        assert ta.alpha_analytic(*v[:3]) == ja.alpha_analytic(*v[:3])
        assert ta.alpha_approx(v[0], v[2]) == ja.alpha_approx(v[0], v[2])
        a = float(rng.uniform())
        assert ta.quantize_alpha(a, n_out) == ja.quantize_alpha(a, n_out)
        assert ta.split_columns(a, n_out, 16) == \
            ja.split_columns(a, n_out, 16)
        kw = dict(v_cpu=v[0], v_gpu=v[1], v_com=v[2], v_pin=v[3])
        assert dataclasses.astuple(ta.decide(n_out, 1e8, **kw)) == \
            dataclasses.astuple(ja.decide(n_out, 1e8, **kw))
    for hw_t, hw_j in ((thw.PAPER_A10, jhw.PAPER_A10),
                       (thw.TPU_V5E, jhw.TPU_V5E)):
        assert dataclasses.asdict(hw_t) == dataclasses.asdict(hw_j)
        for b in (1, 8, 512):
            assert ta.alpha_for_batch(hw_t, b) == ja.alpha_for_batch(hw_j, b)
            assert ta.alpha_for_phase(hw_t, b, "prefill", 64) == \
                ja.alpha_for_phase(hw_j, b, "prefill", 64)


def test_refine_alpha_and_schedule_equal():
    def t_cpu(a):
        return (1 - a) * 3.0 + 0.1 * a * a

    def t_com(a):
        return a * 5.0 + 0.05

    got = tab.refine_alpha(t_cpu, t_com, 0.4)
    want = jab.refine_alpha(t_cpu, t_com, 0.4)
    assert got.alpha == want.alpha
    np.testing.assert_array_equal(got.probes, want.probes)
    assert tab.probe_schedule(0.3, 0.08, 0.02) == \
        jab.probe_schedule(0.3, 0.08, 0.02)
    mods = [(f"m{i}", float(i * 7 % 5 + 1), 0.1 * (i % 3), 1 + i % 2)
            for i in range(12)]
    ts = tms.schedule([tms.ModuleInfo(*m) for m in mods], 9.0)
    js = jms.schedule([jms.ModuleInfo(*m) for m in mods], 9.0)
    assert (ts.resident, ts.offloaded, ts.used_bytes, ts.time_saved) == \
        (js.resident, js.offloaded, js.used_bytes, js.time_saved)


def test_h100_host_spec():
    h = thw.H100_HOST
    assert (h.accel_mem_bw, h.accel_mem_bytes, h.accel_flops) == \
        (3.35e12, 80e9, 67e12)
    assert thw.HARDWARE["h100"] is h
    # the decode plan streams a real share to the card
    res = tpol.build_policy(t_enum(tget("opt-6.7b")), h, batch=4)
    assert 0.0 < res.alpha < 1.0


def test_tracer_and_metrics():
    tr = Tracer()
    with tr.span("blk0.wq", track="cpu_gemm", bytes=16):
        pass
    tr.event("admit", track="sched", rid=1)
    assert [s.name for s in tr.spans()] == ["blk0.wq"]
    assert tr.events_list()[0].attrs == {"rid": 1}
    assert not NULL_TRACER and NULL_TRACER.span("x").__enter__() is not None
    m = MetricsRegistry()
    m.counter("serve.steps").inc()
    m.histogram("serve.step_s").observe(0.02)
    m.absorb({"kv": {"free_pages": 3}, "policy": "fcfs"})
    snap = m.snapshot()
    assert snap["serve.steps"] == 1.0 and snap["kv.free_pages"] == 3.0
    assert snap["serve.step_s"]["count"] == 1
