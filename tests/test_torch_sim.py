"""The port's discrete-event simulator against the JAX package's: every
strategy and ``simulate_step`` over a grid of alphas, on ``PAPER_A10`` and
``TPU_V5E``, field by field within 1e-12 relative, and the JAX package's
own invariants (``test_sim.py``) on the port."""
import dataclasses

import pytest

from repro.core import hw as JH
from repro.core import sim as JS
from repro_torch.core import hw as TH
from repro_torch.core import sim as TS

STRATS = ["resident", "naive_offload", "sync_offload", "hetegen_basic",
          "hetegen_pinned", "hetegen"]
HW = ["PAPER_A10", "TPU_V5E"]


def _modules(S, layers=8, d=4096, f=16384, wire=False):
    mods = []
    for l in range(layers):
        w = (lambda n_in, n_out: n_in * n_out + 4 * n_out) if wire \
            else (lambda n_in, n_out: None)
        mods.append(S.SimModule(f"l{l}.qkv", "linear", d * 3 * d * 2, 3 * d,
                                "attn", 2 * d * 3 * d,
                                wire_bytes=w(d, 3 * d)))
        mods.append(S.SimModule(f"l{l}.attn", "attn_core", 0, 0, "attn",
                                4 * d * 512, cache_bytes=2 * d * 512 * 2))
        mods.append(S.SimModule(f"l{l}.o", "linear", d * d * 2, d, "attn",
                                2 * d * d, wire_bytes=w(d, d)))
        mods.append(S.SimModule(f"l{l}.up", "linear", d * f * 2, f, "mlp",
                                2 * d * f, wire_bytes=w(d, f)))
        mods.append(S.SimModule(f"l{l}.down", "linear", f * d * 2, d, "mlp",
                                2 * d * f, calls=2 if l == 0 else 1,
                                wire_bytes=w(f, d)))
    return mods


def _fields(r):
    out = {}
    for f in dataclasses.fields(r):
        v = getattr(r, f.name)
        if f.name == "timeline":
            out[f.name] = [tuple(e) for e in v]
        else:
            out[f.name] = v
    return out


def _equal(got, want, rel=1e-12):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k], rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b, rel)
    elif isinstance(want, float):
        assert abs(got - want) <= rel * max(abs(want), 1e-300), (got, want)
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("kw", [{}, {"batch": 4},
                                {"gpu_mem_budget": 2e9},
                                {"use_alpha_benchmark": False},
                                {"async_manager": False, "wire": True}],
                         ids=["default", "batch4", "budget", "nobench",
                              "sync_q8wire"])
def test_run_strategy_matches(hw, strategy, kw):
    kw = dict(kw)
    wire = kw.pop("wire", False)
    want = JS.run_strategy(_modules(JS, wire=wire), strategy,
                           getattr(JH, hw), **kw)
    got = TS.run_strategy(_modules(TS, wire=wire), strategy,
                          getattr(TH, hw), **kw)
    _equal(_fields(got), _fields(want))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("alpha", [0.0, 0.05, 0.2, 0.37, 0.5, 0.81, 1.0])
@pytest.mark.parametrize("pinned,hybrid", [(True, True), (False, True),
                                           (True, False)])
def test_simulate_step_matches(hw, alpha, pinned, hybrid):
    def placements(S, mods):
        return {m.name: S.Placement("hetegen", alpha) if m.kind == "linear"
                else S.Placement("resident") for m in mods}
    jm, tm = _modules(JS, 4), _modules(TS, 4)
    want = JS.simulate_step(jm, placements(JS, jm), getattr(JH, hw),
                            pinned=pinned, hybrid_comm=hybrid, batch=2)
    got = TS.simulate_step(tm, placements(TS, tm), getattr(TH, hw),
                           pinned=pinned, hybrid_comm=hybrid, batch=2)
    _equal(_fields(got), _fields(want))


# ---------------------------------------------------------------------------
# the JAX package's invariants, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATS)
def test_utilization_bounded(strategy):
    r = TS.run_strategy(_modules(TS), strategy, TH.PAPER_A10)
    for s, u in r.utilization.items():
        assert 0.0 <= u <= 1.0 + 1e-9, (s, u)
    assert r.step_time > 0


def test_strategy_ordering_matches_paper():
    t = {s: TS.run_strategy(_modules(TS), s, TH.PAPER_A10).step_time
         for s in STRATS}
    assert t["resident"] < t["hetegen"] < t["hetegen_pinned"]
    assert t["hetegen"] < t["hetegen_basic"]
    assert t["hetegen"] < t["sync_offload"] < t["naive_offload"]


def test_hetegen_streams_busy():
    r = TS.run_strategy(_modules(TS, 48, 7168, 28672), "hetegen",
                        TH.PAPER_A10)
    u = r.utilization
    assert u["cpu"] > 0.9 and u["trans"] > 0.9
    assert 0.4 < u["pin"] < u["trans"] + 1e-9
    assert u["dev"] < 0.2


def test_module_scheduler_monotone_in_budget():
    mods = _modules(TS)
    total = sum(m.nbytes for m in mods)
    times = [TS.run_strategy(mods, "hetegen", TH.PAPER_A10,
                             gpu_mem_budget=frac * total * 1.1).step_time
             for frac in (0.0, 0.25, 0.5, 0.75, 1.0)]
    assert all(a >= b - 1e-9 for a, b in zip(times, times[1:]))


def test_simulated_optimum_near_formula_alpha():
    from repro_torch.core import alpha as A
    mods = _modules(TS, 4)
    hw = TH.PAPER_A10
    a_star = A.alpha_analytic(hw.v_cpu(1), hw.v_gpu(1), hw.v_com())

    def time_at(a):
        pl = {m.name: TS.Placement("hetegen", a) if m.kind == "linear"
              else TS.Placement("resident") for m in mods}
        return TS.simulate_step(mods, pl, hw).step_time

    for alpha in (0.02, 0.1, 0.3, 0.6, 0.9):
        assert time_at(a_star) <= time_at(alpha) * 1.02 + 1e-9


def test_ablation_ordering():
    mods = _modules(TS, 16)
    full = TS.run_strategy(mods, "hetegen", TH.PAPER_A10).step_time
    for kw, strat in (({}, "hetegen_pinned"),
                      ({"async_manager": False}, "hetegen"),
                      ({"use_alpha_benchmark": False}, "hetegen")):
        assert full <= TS.run_strategy(mods, strat, TH.PAPER_A10,
                                       **kw).step_time + 1e-9


def test_h100_host_runs():
    r = TS.run_strategy(_modules(TS), "hetegen", TH.H100_HOST, batch=4)
    assert r.step_time > 0 and r.tokens_per_s == 1.0 / r.step_time
    assert all(0.0 <= u <= 1.0 + 1e-9 for u in r.utilization.values())
