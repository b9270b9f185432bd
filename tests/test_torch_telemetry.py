"""The port's trace export, overlap report and trace-driven recalibration
against the JAX package's, on the same spans: seeded synthetic spans built
as both packages' ``Span``, the reference's own cases, and the spans of a
traced port ``LLM`` run over ``tiny`` offloaded with a 16-column tile.
Tolerances: the Chrome documents and validator complaints equal; overlap
numbers within 1e-12; alphas within 1e-9."""
import ast
import dataclasses
import json
import os

import jax
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.telemetry import export as jexp
from repro.telemetry import overlap as jov
from repro.telemetry import recalibrate as jrec
from repro.telemetry.tracer import Event as JEvent
from repro.telemetry.tracer import Span as JSpan
from repro_torch.core.hw import PAPER_A10
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import HeteGenBackend
from repro_torch.telemetry import export as texp
from repro_torch.telemetry import overlap as tov
from repro_torch.telemetry import recalibrate as trec
from repro_torch.telemetry.tracer import Event as TEvent
from repro_torch.telemetry.tracer import Span as TSpan

ROOT = os.path.join(os.path.dirname(__file__), "..")
TRACKS = ("pin", "transfer", "cpu_gemm", "device", "step", "phase", "sample")


def _both(rows):
    """(name, track, t0, t1, attrs) rows as both packages' spans."""
    return ([JSpan(*r) for r in rows], [TSpan(*r) for r in rows])


def _synthetic(seed, q8=False):
    """Seeded spans: serial within each track, streams overlapping each
    other, steps tagged with a phase, byte-carrying stream spans (q8:
    wire bytes plus ``fp_bytes``)."""
    rng = np.random.default_rng(seed)
    rows = []
    t_step = 0.0
    for k in range(6):
        phase = "prefill" if k == 0 else "decode"
        step_t1 = t_step + float(rng.uniform(0.05, 0.1))
        rows.append((f"step{k + 1}", "step", t_step, step_t1,
                     {"phase": phase}))
        rows.append((phase, "phase", t_step + 1e-4, step_t1 - 1e-4, None))
        for track in ("pin", "transfer", "cpu_gemm", "device"):
            t = t_step + float(rng.uniform(0, 0.01))
            for m in range(4):
                t0 = t + float(rng.uniform(0, 0.004))
                t1 = t0 + float(rng.uniform(0.001, 0.01))
                attrs = {"module": f"m{m}", "phase": phase}
                if track != "device":
                    nbytes = int(rng.integers(1 << 16, 1 << 20))
                    attrs["bytes"] = nbytes
                    if q8 and track != "cpu_gemm":
                        attrs["bytes"] = nbytes // 4 + 64
                        attrs["fp_bytes"] = nbytes
                rows.append((f"m{m}", track, t0, t1, attrs))
                t = t1
        rows.append(("sample", "sample", step_t1 - 2e-3, step_t1 - 1e-3,
                     {"rows": 4}))
        t_step = step_t1
    rows.sort(key=lambda r: (r[2], r[3]))
    return rows


def _close(a, b, tol):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_documents_equal(seed, tmp_path):
    rows = _synthetic(seed)
    jsp, tsp = _both(rows)
    ev = [("admit", "sched", 0.01, {"rid": 1}), ("preempt", "sched", 0.2,
                                                 None)]
    jdoc = jexp.to_chrome_trace(jsp, [JEvent(*e) for e in ev])
    tdoc = texp.to_chrome_trace(tsp, [TEvent(*e) for e in ev])
    assert json.dumps(tdoc) == json.dumps(jdoc)
    assert texp.validate_chrome_trace(tdoc) == [] \
        == jexp.validate_chrome_trace(jdoc)
    names = [e["args"]["name"] for e in tdoc["traceEvents"]
             if e["ph"] == "M"]
    assert set(TRACKS) <= set(names)


@pytest.mark.parametrize("case", [
    "same-track overlap", "distinct tracks", "empty", "unknown ph",
    "non-monotone ts", "negative dur", "missing keys"])
def test_validator_complaints_equal(case):
    """The reference's violation cases, and two more it checks: the same
    complaints from both validators."""
    if case == "same-track overlap":
        rows = [("a", "t", 1.0, 2.0, None), ("b", "t", 1.5, 2.5, None)]
        jdoc, tdoc = (m.to_chrome_trace(s)
                      for m, s in zip((jexp, texp), _both(rows)))
        assert jdoc == tdoc
    elif case == "distinct tracks":
        rows = [("a", "t1", 1.0, 2.0, None), ("b", "t2", 1.5, 2.5, None)]
        tdoc = texp.to_chrome_trace(_both(rows)[1])
    elif case == "empty":
        tdoc = {}
    elif case == "unknown ph":
        tdoc = {"traceEvents": [{"ph": "Z", "pid": 0, "tid": 0,
                                 "name": "x"}]}
    elif case == "non-monotone ts":
        tdoc = {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "x",
                                 "ts": -1.0, "dur": 1.0}]}
    elif case == "negative dur":
        tdoc = {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "x",
                                 "ts": 1.0, "dur": -1.0}]}
    else:
        tdoc = {"traceEvents": [{"ph": "X", "ts": 1.0, "dur": 1.0}, 3]}
    want = jexp.validate_chrome_trace(tdoc)
    got = texp.validate_chrome_trace(tdoc)
    assert got == want
    assert (got == []) == (case == "distinct tracks")


OVERLAP_CASES = {
    # I/O entirely under compute -> fraction 1.0
    "perfectly hidden": [("t", "transfer", 1.0, 2.0, None),
                         ("p", "pin", 1.2, 1.8, None),
                         ("d", "device", 0.0, 4.0, None)],
    # streams back to back -> fraction 0
    "forced serial": [("p", "pin", 0.0, 1.0, None),
                      ("t", "transfer", 1.0, 2.0, None),
                      ("c", "cpu_gemm", 2.0, 3.0, None),
                      ("d", "device", 3.0, 4.0, None)],
    "no io": [("d", "device", 0.0, 1.0, None)],
    "empty": [],
    "per-step windows": [("step1", "step", 0.0, 2.0, {"phase": "decode"}),
                         ("step2", "step", 2.0, 4.0, {"phase": "verify"}),
                         ("t", "transfer", 0.0, 1.0, None),
                         ("d", "device", 0.5, 3.5, None)],
}


@pytest.mark.parametrize("case", [*OVERLAP_CASES, "seed 0", "seed 1",
                                  "seed 2"])
def test_overlap_report_equal(case):
    rows = OVERLAP_CASES[case] if case in OVERLAP_CASES \
        else _synthetic(int(case.split()[1]))
    jsp, tsp = _both(rows)
    want = jov.compute_overlap(jsp)
    got = tov.compute_overlap(tsp)
    _close(got.as_dict(), want.as_dict(), 1e-12)
    assert got.render() == want.render()
    expect = {"perfectly hidden": 1.0, "forced serial": 0.0, "no io": 1.0}
    if case in expect:
        assert got.io_hidden_frac == pytest.approx(expect[case])
    if case == "per-step windows":
        assert [w.phase for w in got.steps] == ["decode", "verify"]
        assert got.steps[0].io_hidden_frac == pytest.approx(0.5)


def test_interval_primitives_equal():
    ivs = [(0, 1), (0.5, 2), (3, 4), (4, 4)]
    assert tov.union_intervals(ivs) == jov.union_intervals(ivs)
    a, b = [(0, 2), (3, 5)], [(1, 4)]
    assert tov.intersect_unions(a, b) == jov.intersect_unions(a, b)
    assert tov.clip_union(a, 1, 4) == jov.clip_union(a, 1, 4)
    assert tov.total(a) == jov.total(a) == 4


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("phase", [None, "decode"])
def test_recalibration_equal(q8, phase):
    """measured_speeds and recalibrate_alpha on fp spans and on q8 spans
    that carry fp_bytes."""
    jsp, tsp = _both(_synthetic(3, q8=q8))
    want = jrec.measured_speeds(jsp, phase=phase)
    got = trec.measured_speeds(tsp, phase=phase)
    _close(got.as_dict(), want.as_dict(), 1e-9)
    assert got.wire_ratio == pytest.approx(want.wire_ratio, abs=1e-12)
    assert (got.wire_ratio < 0.5) == q8
    for alpha0 in (0.2, 0.5):
        fj = jrec.recalibrate_alpha(jsp, alpha0, phase=phase)
        ft = trec.recalibrate_alpha(tsp, alpha0, phase=phase)
        assert ft.alpha == pytest.approx(fj.alpha, abs=1e-9)
        assert ft.predicted_time == pytest.approx(fj.predicted_time,
                                                  rel=1e-9)
    with pytest.raises(ValueError, match="pin"):
        trec.measured_speeds([TSpan("m", "cpu_gemm", 0.0, 1.0,
                                    {"bytes": 1024})])


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in (8, 12, 8, 12)]
    return cfg, jp, tp, prompts


def _serve_offloaded(cfg, tp, prompts, trace=True, hw=PAPER_A10, **kw):
    hb = HeteGenBackend(cfg, tp, hw=hw, budget_bytes=0, batch=2, tile=16,
                        device="cpu", **kw)
    llm = LLM(cfg, backend=hb, own_backend=True, max_slots=2, max_len=32,
              paged=True, trace=trace)
    rids = [llm.submit(p, max_new=4) for p in prompts]
    outs = llm.drain()
    return llm, hb, [outs[r].tokens for r in rids]


def test_traced_llm_spans_refit_equal(tiny, tmp_path):
    """A traced offloaded run: a valid Chrome trace on disk, an overlap
    report whose stream busy seconds are the engine's, metrics() over
    stats(), and the same refit alpha through both packages."""
    cfg, _, tp, prompts = tiny
    llm, hb, _ = _serve_offloaded(cfg, tp, prompts)
    try:
        doc = llm.write_trace(str(tmp_path / "trace.json"))
        with open(tmp_path / "trace.json") as f:
            assert json.load(f) == json.loads(json.dumps(doc))
        assert texp.validate_chrome_trace(doc) == []
        rep = llm.overlap_report()
        st = llm.stats()
        # each span encloses the interval the engine's stream counter
        # times (on the card, at full width, chip_smoke.py holds the two
        # within 5%)
        for track, busy in (("cpu_gemm", st["stream"].cpu),
                            ("transfer", st["stream"].trans)):
            assert 0 < busy <= rep.overall.busy[track] + 1e-9
        snap = llm.metrics()
        assert snap["serve.tokens"] == 16.0
        assert snap["scheduler.preemptions"] == \
            float(st["scheduler"]["preemptions"])
        spans = llm.tracer.spans()
        alpha0 = hb.policies["decode"].alpha
    finally:
        llm.close()
    # each phase engine pins on its own thread, on its own track
    assert {"pin:decode", "pin:prefill", "transfer", "cpu_gemm", "device",
            "step", "phase", "sample"} <= {s.track for s in spans}
    # the reference has one pin track: merge the port's onto it
    merged = [dataclasses.replace(s, track=tov.stream_of(s.track))
              for s in spans]
    jspans = [JSpan(s.name, s.track, s.t0, s.t1, s.attrs) for s in merged]
    ft = trec.recalibrate_alpha(spans, alpha0, phase="decode")
    fj = jrec.recalibrate_alpha(jspans, alpha0, phase="decode")
    assert ft.alpha == pytest.approx(fj.alpha, abs=1e-9)
    _close(tov.compute_overlap(merged).as_dict(),
           jov.compute_overlap(jspans).as_dict(), 1e-12)
    own, one = tov.compute_overlap(spans), tov.compute_overlap(merged)
    for a, b in zip([own.overall, *own.steps], [one.overall, *one.steps]):
        assert a.io_busy == pytest.approx(b.io_busy, abs=1e-12)
        assert a.io_hidden == pytest.approx(b.io_hidden, abs=1e-12)
        assert a.compute_busy == pytest.approx(b.compute_busy, abs=1e-12)


def test_recalibration_replans_with_same_tokens(tiny):
    """A wrong hardware spec (the link 8x too fast) makes the first decode
    plan wrong; recalibration from the trace re-plans, and the greedy
    tokens stay those of the untraced run and of the JAX package."""
    cfg, jp, tp, prompts = tiny
    llm, _, plain = _serve_offloaded(cfg, tp, prompts, trace=False)
    llm.close()
    wrong = dataclasses.replace(PAPER_A10, link_bw=PAPER_A10.link_bw * 8)
    llm, hb, toks = _serve_offloaded(cfg, tp, prompts, hw=wrong,
                                     recalibrate=0.01, recalibrate_every=2)
    try:
        alpha = hb.policies["decode"].alpha
        fit = hb.last_fit
        assert hb.recalibrations >= 1
        assert fit is not None and alpha == pytest.approx(fit.alpha)
        busy = llm.overlap_report().overall.busy
        assert sum(v for k, v in busy.items()
                   if tov.stream_of(k) == "pin") > 0
    finally:
        llm.close()
    with JLLM(cfg, jp, max_slots=2, max_len=32, paged=True) as jllm:
        jr = [jllm.submit(p, max_new=4) for p in prompts]
        jout = jllm.drain()
    assert toks == plain == [jout[r].tokens for r in jr]


def test_pin_threads_of_two_phase_engines():
    """Two phase engines pin on two threads at once: their spans lie on
    ``pin:decode`` and ``pin:prefill``, the Chrome trace stays valid, the
    I/O set is the union of both, each thread is its own candidate for
    the critical path, and the speed fit sums both threads' spans."""
    rows = [("a", "pin:decode", 0.0, 1.0, {"bytes": 100, "phase": "decode"}),
            ("b", "pin:prefill", 0.5, 2.0,
             {"bytes": 300, "phase": "prefill"}),
            ("c", "transfer", 1.8, 2.2, {"bytes": 400}),
            ("d", "cpu_gemm", 0.0, 0.6, {"bytes": 50}),
            ("e", "cpu_gemm", 1.0, 1.2, {"bytes": 50})]
    spans = [TSpan(*r) for r in rows]
    assert texp.validate_chrome_trace(texp.to_chrome_trace(spans)) == []
    w = tov.compute_overlap(spans).overall
    assert w.io_busy == pytest.approx(2.2)
    assert w.io_hidden == pytest.approx(0.8)
    assert w.critical_path == "pin:prefill"
    assert "pin:decode" in tov.compute_overlap(spans).render()
    est = trec.measured_speeds(spans)
    assert (est.pin_bytes, est.pin_s) == (400, pytest.approx(2.5))
    assert trec.measured_speeds(spans, phase="decode").pin_bytes == 100
    # one track for both threads is what the validator refuses
    one = [dataclasses.replace(s, track=tov.stream_of(s.track))
           for s in spans]
    assert texp.validate_chrome_trace(texp.to_chrome_trace(one))


# ---------------------------------------------------------------------------
# the port's counterpart of the reference's telemetry-no-sync lint
# ---------------------------------------------------------------------------

SYNC_ATTRS = {"synchronize", "item", "cpu", "tolist"}


def _is_span(node):
    """``with <...>.span(...)``."""
    return (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "span")


def _sync_calls(tree):
    """Device syncs in a module: calls of ``.synchronize/.item/.cpu/
    .tolist`` and any use of ``torch.cuda.Event``, with whether each sits
    inside a tracer span."""
    found = []

    def visit(node, in_span):
        if isinstance(node, ast.With) and any(
                _is_span(it.context_expr) for it in node.items):
            in_span = True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in SYNC_ATTRS:
            found.append((node.lineno, node.func.attr, in_span))
        if isinstance(node, ast.Attribute) and node.attr == "Event" \
                and ast.unparse(node.value) == "torch.cuda":
            found.append((node.lineno, "torch.cuda.Event", in_span))
        for child in ast.iter_child_nodes(node):
            visit(child, in_span)

    visit(tree, False)
    return found


def test_lint_finds_planted_syncs():
    src = ("def f(tr, x):\n"
           "    with tr.span('a', track='device'):\n"
           "        y = x.item()\n"
           "    e = torch.cuda.Event()\n"
           "    return x.tolist()\n")
    assert _sync_calls(ast.parse(src)) == [
        (3, "item", True), (4, "torch.cuda.Event", False),
        (5, "tolist", False)]


@pytest.mark.parametrize("rel", [
    "telemetry/tracer.py", "telemetry/metrics.py", "telemetry/export.py",
    "telemetry/overlap.py", "telemetry/recalibrate.py",
    "telemetry/__init__.py", "serving/sampling.py"])
def test_telemetry_and_sampler_never_sync(rel):
    path = os.path.join(ROOT, "src", "repro_torch", rel)
    with open(path) as f:
        tree = ast.parse(f.read())
    assert _sync_calls(tree) == []
