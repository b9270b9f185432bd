"""The port's speculative decoding against the JAX package's.

The same params (carried across through numpy) and requests go through
``repro.serving`` and ``repro_torch.serving``.  Held equal: the drafters'
proposals, the ``AdaptiveK`` sequence and ``filtered_probs`` (bit for
bit, ties included), greedy ``accept_row`` and ``logprob_record`` (within
1e-6); greedy tokens and ``SpecStats`` of ``ContinuousBatcher(spec=)``
and ``LLM(spec=)`` runs — dense, paged, chunked admission, adaptive k,
preempt/resume, offloaded ``HeteGenBackend`` — and the verify plan's
alpha.  Greedy speculation also equals the port's own run without it.
The port draws its acceptance uniforms from the request's splitmix64
stream (the reference from threefry), so stochastic acceptance is held
to the filtered distribution by a chi-square test, and a draft-less
stochastic row to the port's own baseline draw, bit for bit.
"""
import dataclasses

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst
from scipy import stats as sstats

from repro.configs import get_config
from repro.core.hw import PAPER_A10 as J_A10
from repro.models import model as JM
from repro.serving import speculative as jspec
from repro.serving.api import LLM as JLLM
from repro.serving.backends import HeteGenBackend as JHB
from repro.serving.backends import ResidentBackend as JRB
from repro.serving.batcher import ContinuousBatcher as JCB
from repro.serving.sampling import SamplingParams as JSP
from repro_torch.core.hw import PAPER_A10
from repro_torch.models import model as TM
from repro_torch.serving import speculative as tspec
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import HeteGenBackend, ResidentBackend
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.sampling import (SamplingParams, pack_sampling,
                                          request_key, sample_rows, seed_key)
from repro_torch.serving.speculative import (AdaptiveK, ModelDrafter,
                                             NgramDrafter, SpecConfig,
                                             SpecStats, accept_row,
                                             filtered_probs, uniform)
from repro_torch.telemetry.overlap import stream_of


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("tiny")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _jsp(sp):
    """The reference's SamplingParams of a port one."""
    return JSP(**dataclasses.asdict(sp))


def _stats(st):
    return None if st is None else (st.steps, st.drafted, st.accepted,
                                    st.rolled_back)


def _run(cfg, params, submits, *, spec=None, max_slots=2, max_len=64,
         backend=None, **kw):
    """The port: run (rid, prompt, max_new, sampling) submits to
    completion; returns ({rid: tokens}, SpecStats or None, batcher)."""
    be = backend or ResidentBackend(cfg, params, device="cpu")
    b = ContinuousBatcher(cfg, backend=be, own_backend=True,
                          max_slots=max_slots, max_len=max_len, spec=spec,
                          **kw)
    for rid, p, n, sp in submits:
        b.submit(p, n, sampling=sp, rid=rid)
    out = {rid: list(t) for rid, t in b.run_until_done().items()}
    b.close()
    return out, (b.spec_stats if spec is not None else None), b


def _jrun(cfg, params, submits, *, spec=None, max_slots=2, max_len=64,
          backend=None, **kw):
    """The reference: the same run through the JAX package."""
    be = backend or JRB(cfg, params)
    b = JCB(cfg, backend=be, own_backend=True, max_slots=max_slots,
            max_len=max_len, spec=spec, **kw)
    for rid, p, n, sp in submits:
        b.submit(p, n, sampling=_jsp(sp), rid=rid)
    out = {rid: list(t) for rid, t in b.run_until_done().items()}
    b.close()
    return out, (b.spec_stats if spec is not None else None), b


def _repetitive(rng, vocab, length, period=4):
    motif = [int(t) for t in rng.integers(1, vocab, period)]
    return (motif * length)[:length]


def _greedy_submits(seed, cfg, n=3, plen=12, max_new=10):
    rng = np.random.default_rng(seed)
    return [(rid, _repetitive(rng, cfg.vocab_size, plen, 3 + rid), max_new,
             SamplingParams()) for rid in range(n)]


# ---------------------------------------------------------------------------
# drafters, controller and config as pure functions
# ---------------------------------------------------------------------------

def test_ngram_drafter_lookup():
    d = NgramDrafter(max_ngram=3)
    assert d.propose(0, [1, 2, 3, 4, 9, 1, 2, 3, 4], 3) == [9, 1, 2]
    assert d.propose(0, [1, 2, 3, 4, 9, 1, 2, 3, 4], 1) == [9]
    assert d.propose(0, [1, 2, 3, 4, 5, 6], 4) == []
    assert d.propose(0, [], 4) == []
    assert d.propose(0, [1, 2], 0) == []


def test_ngram_drafter_prefers_longest_then_most_recent():
    d = NgramDrafter(max_ngram=2)
    assert d.propose(0, [1, 2, 7, 1, 2, 8, 1, 2], 1) == [8]
    toks = [2, 5, 6, 5, 9, 2, 5]
    assert d.propose(0, toks, 1) == [6]
    assert NgramDrafter(max_ngram=1).propose(0, toks, 1) == [9]
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=0)


@settings(max_examples=200, deadline=None)
@given(hst.lists(hst.integers(0, 5), max_size=40), hst.integers(0, 6),
       hst.integers(1, 4), hst.integers(1, 4))
def test_ngram_proposals_equal_reference(toks, k, lo, span):
    """Over small alphabets (many repeats), every proposal is the
    reference's."""
    hi = lo + span - 1
    assert NgramDrafter(hi, lo).propose(0, toks, k) == \
        jspec.NgramDrafter(hi, lo).propose(0, toks, k)


def test_adaptive_k_controller():
    ak = AdaptiveK(4, k_min=2, k_max=6)
    assert ak.k_for(0) == 4
    ak.update(0, 4, 4)
    assert ak.k_for(0) == 5
    ak.update(0, 5, 5)
    ak.update(0, 6, 6)
    assert ak.k_for(0) == 6
    ak.update(0, 6, 2)
    assert ak.k_for(0) == 5
    ak.update(0, 5, 3)
    assert ak.k_for(0) == 5
    for _ in range(10):
        ak.update(0, 5, 0)
    assert ak.k_for(0) == 2
    ak.update(1, 0, 0)
    assert ak.k_for(1) == 4
    ak.release(0)
    assert ak.k_for(0) == 4


@settings(max_examples=100, deadline=None)
@given(hst.integers(0, 10), hst.integers(1, 4), hst.integers(0, 6),
       hst.lists(hst.tuples(hst.integers(0, 2), hst.integers(0, 9),
                            hst.integers(0, 9)), max_size=30))
def test_adaptive_k_sequence_equals_reference(k0, k_min, span, updates):
    k_max = k_min + span
    ours, theirs = AdaptiveK(k0, k_min, k_max), \
        jspec.AdaptiveK(k0, k_min, k_max)
    for rid, proposed, accepted in updates:
        ours.update(rid, proposed, min(accepted, proposed))
        theirs.update(rid, proposed, min(accepted, proposed))
        assert [ours.k_for(r) for r in range(3)] == \
            [theirs.k_for(r) for r in range(3)]


def test_spec_config_validation():
    with pytest.raises(ValueError):
        SpecConfig(drafter=NgramDrafter(), k=0)
    with pytest.raises(ValueError):
        SpecConfig(drafter=NgramDrafter(), k=2, k_min=3, k_max=2)
    st = SpecStats()
    st.record(4, 2)
    st.record(0, 0)
    assert st.as_dict() == {"steps": 1, "drafted": 4, "accepted": 2,
                            "rolled_back": 2, "acceptance_rate": 0.5}


# ---------------------------------------------------------------------------
# the host mirror of the sampler's filter; acceptance
# ---------------------------------------------------------------------------

FILTERS = [
    SamplingParams(kind="temperature", temperature=0.7),
    SamplingParams(kind="temperature", temperature=0.0),
    SamplingParams(kind="topk", top_k=1),
    SamplingParams(kind="topk", top_k=5, temperature=1.3),
    SamplingParams(kind="topp", top_p=0.5),
    SamplingParams(kind="topp", top_p=0.9, temperature=1.2),
    SamplingParams(kind="topp", top_p=1.0),
    SamplingParams(kind="topp", top_p=0.8, top_k=6, temperature=1.1),
]


@pytest.mark.parametrize("sp", FILTERS, ids=lambda p: f"{p.kind}"
                         f"-t{p.temperature}-k{p.top_k}-p{p.top_p}")
def test_filtered_probs_bit_equal(sp):
    """On equal logits (rounded to 0.25, so every row holds ties), the
    port's filter is the reference's bit for bit."""
    rng = np.random.default_rng(7)
    for v in (16, 257, 4096):
        for _ in range(4):
            x = (np.round(rng.standard_normal(v) * 8) / 4).astype(np.float32)
            ours = filtered_probs(x, sp)
            theirs = jspec.filtered_probs(x, _jsp(sp))
            assert ours.dtype == theirs.dtype == np.float32
            assert np.array_equal(ours, theirs)


@settings(max_examples=100, deadline=None)
@given(hst.lists(hst.integers(-6, 6), min_size=1, max_size=64),
       hst.floats(0.0, 3.0), hst.integers(0, 8), hst.floats(0.05, 1.0))
def test_filtered_probs_bit_equal_property(vals, t, k, p):
    x = np.asarray(vals, np.float32) / 2
    sp = SamplingParams(kind="topp", temperature=t, top_k=k, top_p=p)
    assert np.array_equal(filtered_probs(x, sp),
                          jspec.filtered_probs(x, _jsp(sp)))


def test_filtered_probs_supports_exactly_the_sampler():
    """The port's sample_rows emits only tokens in filtered_probs'
    support, and the support keeps more than the argmax."""
    rng = np.random.default_rng(3)
    logits = np.asarray(rng.standard_normal(64) * 2, np.float32)
    for sp in (SamplingParams(kind="topk", top_k=5, temperature=2.0),
               SamplingParams(kind="topp", top_p=0.7, temperature=2.0),
               SamplingParams(kind="temperature", temperature=3.0)):
        p = filtered_probs(logits, sp)
        assert abs(p.sum() - 1.0) < 1e-5 and (p > 0).sum() > 1
        n = 256
        draws = sample_rows(torch.from_numpy(logits)[None].repeat(n, 1),
                            [seed_key(10_000 + i) for i in range(n)],
                            pack_sampling([sp] * n)).tolist()
        assert set(draws) <= set(np.flatnonzero(p > 0).tolist())


def test_uniform_is_a_documented_function_of_the_key():
    """uniform(key) lies in [0, 1), depends on the key alone, and 2^14
    draws of consecutive keys pass a Kolmogorov-Smirnov test."""
    us = [uniform(seed_key(i)) for i in range(1 << 14)]
    assert all(0.0 <= u < 1.0 for u in us)
    assert us[:8] == [uniform(seed_key(i)) for i in range(8)]
    assert sstats.kstest(us, "uniform").pvalue > 1e-3


@pytest.mark.parametrize("which", ["mode", "tail"])
def test_accept_row_marginal_matches_filtered_probs(which):
    """The first token accept_row emits, over many request keys, is
    distributed as filtered_probs — the draft the mode (mostly accepted)
    or a tail token (mostly rejected and redrawn): chi-square, p > 1e-3."""
    rng = np.random.default_rng(5)
    logits = np.asarray(rng.standard_normal(16), np.float32)
    sp = SamplingParams(kind="temperature", temperature=3.0)
    p = filtered_probs(logits, sp)
    rows = np.stack([logits, logits])
    draft = int(np.argmax(p) if which == "mode" else np.argmin(p))
    n = 4000
    counts = np.zeros(16)
    base = seed_key(3)
    for i in range(n):
        out = accept_row(rows, [draft], sp, request_key(base, i, sp), 0)
        counts[out[0]] += 1
    want = p.astype(np.float64) / p.astype(np.float64).sum() * n
    assert sstats.chisquare(counts, want).pvalue > 1e-3


def test_accept_row_greedy_equals_reference():
    rng = np.random.default_rng(0)
    jkey = jax.random.PRNGKey(0)
    for _ in range(20):
        rows = np.asarray(rng.integers(-3, 4, (4, 32)), np.float32)
        arg = [int(np.argmax(r)) for r in rows]
        for drafts in (arg[:3], [arg[0], (arg[1] + 1) % 32, arg[2]],
                       [(arg[0] + 1) % 32], []):
            r = rows[:len(drafts) + 1]
            got = accept_row(r, drafts, SamplingParams(), 0, 0)
            assert got == jspec.accept_row(r, drafts, JSP(), jkey, 0)
    assert accept_row(rows, arg[:3], SamplingParams(), 0, 0) == arg


def test_logprob_record_equals_reference():
    rng = np.random.default_rng(2)
    for k in (0, 1, 5):
        row = (np.round(rng.standard_normal(300) * 8) / 4).astype(np.float32)
        tok = int(rng.integers(0, 300))
        a = tspec.logprob_record(row, tok, k)
        b = jspec.logprob_record(row, tok, k)
        assert a["token"] == b["token"]
        assert a["logprob"] == pytest.approx(b["logprob"], abs=1e-6)
        assert list(a["top"]) == list(b["top"])
        for t in a["top"]:
            assert a["top"][t] == pytest.approx(b["top"][t], abs=1e-6)


# ---------------------------------------------------------------------------
# greedy identity against the reference and the port's baseline
# ---------------------------------------------------------------------------

SPEC_RUNS = {
    "dense": dict(subs=dict(seed=11), kw={}),
    "paged": dict(subs=dict(seed=12), kw=dict(paged=True, page_size=8)),
    "adaptive": dict(subs=dict(seed=13, n=2), kw={},
                     spec=dict(k=2, adaptive=True, k_min=1, k_max=5)),
}


@pytest.mark.parametrize("case", sorted(SPEC_RUNS))
def test_spec_greedy_identical_to_reference_and_baseline(setup, case):
    cfg, jp, tp = setup
    c = SPEC_RUNS[case]
    subs = _greedy_submits(cfg=cfg, **c["subs"])
    skw = c.get("spec", dict(k=4))
    base, _, _ = _run(cfg, tp, subs)
    out, st, _ = _run(cfg, tp, subs, spec=SpecConfig(NgramDrafter(), **skw),
                      **c["kw"])
    jout, jst, _ = _jrun(cfg, jp, subs,
                         spec=jspec.SpecConfig(jspec.NgramDrafter(), **skw),
                         **c["kw"])
    assert out == jout == base
    assert _stats(st) == _stats(jst)
    assert st.drafted > 0 and st.accepted > 0


def test_spec_greedy_chunked_admission(setup):
    """A long prompt admitted in chunks, then speculated over."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(14)
    subs = [(0, _repetitive(rng, cfg.vocab_size, 30, 3), 10,
             SamplingParams()),
            (1, _repetitive(rng, cfg.vocab_size, 8, 4), 10,
             SamplingParams())]
    kw = dict(paged=True, page_size=8, chunk_tokens=8)
    base, _, _ = _run(cfg, tp, subs)
    out, st, b = _run(cfg, tp, subs, spec=SpecConfig(NgramDrafter(), k=4),
                      **kw)
    jout, jst, _ = _jrun(cfg, jp, subs,
                         spec=jspec.SpecConfig(jspec.NgramDrafter(), k=4),
                         **kw)
    assert out == jout == base
    assert _stats(st) == _stats(jst) and st.accepted > 0
    assert b.scheduler.chunks_planned > 2


def test_spec_preempt_resume_identical(setup):
    """A pool of 9 pages too small for three tenants forces preempt /
    resume in the middle of speculative runs; the tokens stay the
    unpressured baseline's and the reference's."""
    cfg, jp, tp = setup
    subs = _greedy_submits(15, cfg, n=3, plen=10, max_new=12)
    base, _, _ = _run(cfg, tp, subs, max_slots=3)
    kw = dict(max_slots=3, paged=True, page_size=8, n_pages=9)
    out, st, b = _run(cfg, tp, subs, spec=SpecConfig(NgramDrafter(), k=4),
                      **kw)
    jout, jst, jb = _jrun(cfg, jp, subs,
                          spec=jspec.SpecConfig(jspec.NgramDrafter(), k=4),
                          **kw)
    assert out == jout == base
    assert _stats(st) == _stats(jst)
    assert b.scheduler.preemptions == jb.scheduler.preemptions > 0


def test_spec_offloaded_hetegen_identical(setup):
    """Offloaded and paged: ``HeteGenBackend(tile=16)`` splits tiny's
    linears between host and device; speculation keeps the tokens of the
    port's plain run and of the reference's offloaded spec run, with the
    same SpecStats, and runs a verify engine of its own (``pin:verify``
    in the trace)."""
    cfg, jp, tp = setup
    subs = _greedy_submits(16, cfg, n=3)
    prompts = [p for _, p, _, _ in subs]

    def port(spec):
        hb = HeteGenBackend(cfg, tp, hw=PAPER_A10, budget_bytes=0, batch=2,
                            tile=16, device="cpu")
        with LLM(cfg, backend=hb, own_backend=True, max_slots=2,
                 max_len=64, paged=True, page_size=8, spec=spec,
                 trace=spec is not None) as llm:
            outs = llm.generate(prompts, max_new=10)
            st = llm.stats()
            tracks = {s.track for s in llm.tracer.spans()}
        return [o.tokens for o in outs], st, tracks

    base, _, _ = port(None)
    out, st, tracks = port(SpecConfig(NgramDrafter(), k=4))
    jhb = JHB(cfg, jp, hw=J_A10, budget_bytes=0, batch=2)
    with JLLM(cfg, backend=jhb, own_backend=True, max_slots=2, max_len=64,
              paged=True, page_size=8,
              spec=jspec.SpecConfig(jspec.NgramDrafter(), k=4)) as jllm:
        jouts = jllm.generate(prompts, max_new=10)
        jst = jllm.stats()
    assert out == [o.tokens for o in jouts] == base
    keys = ("steps", "drafted", "accepted", "rolled_back")
    assert [st["spec"][k] for k in keys] == [jst["spec"][k] for k in keys]
    assert st["spec"]["accepted"] > 0
    assert "verify" in st["phase_alpha"]
    assert {"pin:verify", "pin:decode", "cpu_gemm", "transfer"} <= tracks


def test_verify_plan_alpha_equals_reference(setup):
    """The same spec run on both packages' HeteGenBackend (the A10 spec,
    no budget, the default 128-column tile of both) plans every phase —
    verify included — at the same alpha, batch and tokens per row."""
    cfg, jp, tp = setup
    subs = _greedy_submits(17, cfg, n=2)
    prompts = [p for _, p, _, _ in subs]
    hb = HeteGenBackend(cfg, tp, hw=PAPER_A10, budget_bytes=0, batch=2,
                        device="cpu")
    with LLM(cfg, backend=hb, own_backend=True, max_slots=2, max_len=64,
             paged=True, page_size=8,
             spec=SpecConfig(NgramDrafter(), k=4)) as llm:
        llm.generate(prompts, max_new=8)
        st = llm.stats()
    jhb = JHB(cfg, jp, hw=J_A10, budget_bytes=0, batch=2)
    with JLLM(cfg, backend=jhb, own_backend=True, max_slots=2, max_len=64,
              paged=True, page_size=8,
              spec=jspec.SpecConfig(jspec.NgramDrafter(), k=4)) as jllm:
        jllm.generate(prompts, max_new=8)
        jst = jllm.stats()
    assert st["phase_alpha"] == jst["phase_alpha"]
    assert st["phase_batch"] == jst["phase_batch"]
    assert st["phase_batch"]["verify"][1] > 1
    # and directly, at a few verify shapes
    for b, s in ((1, 2), (4, 5), (3, 9)):
        ours = HeteGenBackend(cfg, tp, hw=PAPER_A10, budget_bytes=0,
                              device="cpu")
        theirs = JHB(cfg, jp, hw=J_A10, budget_bytes=0)
        ours._ensure_verify_plan(b, s)
        theirs._ensure_verify_plan(b, s)
        assert ours.policies["verify"].alpha == \
            theirs.policies["verify"].alpha
        ours.close()
        theirs.close()


def test_spec_recalibration_replans_verify(setup):
    """A link 8x too fast makes the verify plan wrong; the traced
    offloaded spec run with ``recalibrate=`` fits the verify phase from
    its own spans, re-plans it (a ``replan`` span with phase verify) and
    keeps the untraced baseline's greedy tokens."""
    cfg, jp, tp = setup
    subs = _greedy_submits(18, cfg, n=2, max_new=16)
    prompts = [p for _, p, _, _ in subs]
    base, _, _ = _run(cfg, tp, subs)
    wrong = dataclasses.replace(PAPER_A10, link_bw=PAPER_A10.link_bw * 8)
    hb = HeteGenBackend(cfg, tp, hw=wrong, budget_bytes=0, batch=2, tile=16,
                        device="cpu", recalibrate=1e-3, recalibrate_every=2)
    with LLM(cfg, backend=hb, own_backend=True, max_slots=2, max_len=64,
             paged=True, page_size=8, trace=True,
             spec=SpecConfig(NgramDrafter(), k=4)) as llm:
        outs = llm.generate(prompts, max_new=16)
        spans = llm.tracer.spans()
    replans = [s.attrs["phase"] for s in spans if s.track == "replan"]
    assert "verify" in replans
    assert [o.tokens for o in outs] == [base[r] for r, *_ in subs]
    assert any(s.track == "pin:verify" for s in spans)
    assert all(stream_of(s.track) == "pin" for s in spans
               if s.track.startswith("pin"))


# ---------------------------------------------------------------------------
# port only: draft-less rows, rollback, the model drafter, eos, the facade
# ---------------------------------------------------------------------------

class _OnlyRid:
    """Only one request gets drafts: the other rides the verify batch as
    a draft-less row."""

    def __init__(self, inner, rid):
        self.inner, self.rid = inner, rid

    def propose(self, rid, tokens, k):
        return self.inner.propose(rid, tokens, k) if rid == self.rid else []

    def release(self, rid):
        self.inner.release(rid)

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_draftless_row_bitwise_stochastic(setup, paged):
    """A stochastic tenant that never drafts shares verify steps with a
    speculating neighbour; its bonus draw goes through sample_rows with
    the plain step key, so its tokens are the baseline's bit for bit."""
    cfg, _, tp = setup
    rng = np.random.default_rng(19)
    sto = SamplingParams(kind="temperature", temperature=40.0)
    subs = [(0, _repetitive(rng, cfg.vocab_size, 12, 3), 10,
             SamplingParams()),
            (1, [int(t) for t in rng.integers(1, cfg.vocab_size, 9)], 10,
             sto)]
    kw = dict(paged=True, page_size=8) if paged else {}
    base, _, _ = _run(cfg, tp, subs)
    out, st, _ = _run(cfg, tp, subs,
                      spec=SpecConfig(_OnlyRid(NgramDrafter(), 0), k=4),
                      **kw)
    assert out[1] == base[1]
    assert out[0] == base[0]
    assert len(set(base[1])) > 1            # the tenant really draws
    assert st.accepted > 0


class _ConstDrafter:
    """Always proposes the same run: the test targets rejection and
    rollback, not drafting."""

    def __init__(self, run):
        self.run = list(run)

    def propose(self, rid, tokens, k):
        return self.run[:k]

    def release(self, rid):
        pass

    def close(self):
        pass


def test_spec_rollback_truncates_and_frees_pages(setup):
    """At a temperature hot enough to reject most drafts, rollback runs
    (dense length reset, paged truncate) under the allocator's self-check:
    every request finishes with its budget and every page returns."""
    cfg, _, tp = setup
    rng = np.random.default_rng(20)
    hot = SamplingParams(kind="temperature", temperature=40.0)
    subs = [(rid, _repetitive(rng, cfg.vocab_size, 12, 3), 8, hot)
            for rid in range(2)]
    spec = SpecConfig(_ConstDrafter([1, 2, 3]), k=3)
    for kw in ({}, dict(paged=True, page_size=4, selfcheck=True)):
        out, st, b = _run(cfg, tp, subs, spec=spec, **kw)
        assert all(len(t) == 8 for t in out.values())
        assert st.rolled_back > 0
        assert st.drafted == st.accepted + st.rolled_back
        if b.kv is not None:
            assert b.kv.free_pages == b.kv.usable_pages
            assert b.kv.stats()["pages_leaked"] == 0


def test_model_drafter_self_draft_identity(setup):
    """Drafting with the target model itself: every greedy draft is the
    target's argmax, so all are accepted and the tokens are the
    baseline's and the reference's."""
    cfg, jp, tp = setup
    subs = _greedy_submits(21, cfg, n=2, plen=8, max_new=8)
    base, _, _ = _run(cfg, tp, subs)
    drafter = ModelDrafter(cfg, tp, max_len=64, device="cpu")
    assert drafter.backend.device == torch.device("cpu")
    out, st, _ = _run(cfg, tp, subs, spec=SpecConfig(drafter, k=3),
                      paged=True, page_size=8)
    jout, jst, _ = _jrun(cfg, jp, subs, spec=jspec.SpecConfig(
        jspec.ModelDrafter(cfg, jp, max_len=64), k=3), paged=True,
        page_size=8)
    assert out == jout == base
    assert _stats(st) == _stats(jst)
    assert st.drafted > 0 and st.acceptance_rate == 1.0


def test_model_drafter_reconciles_after_rejection(setup):
    """Rejected speculation leaves the drafter's cache ahead of the
    request's history; the longest-common-prefix reconciliation re-feeds
    the divergent tail and keeps proposing what a fresh drafter would."""
    cfg, _, tp = setup
    rng = np.random.default_rng(22)
    hot = SamplingParams(kind="temperature", temperature=40.0)
    subs = [(0, _repetitive(rng, cfg.vocab_size, 10, 3), 8, hot)]
    drafter = ModelDrafter(cfg, tp, max_len=64, device="cpu")
    fresh = ModelDrafter(cfg, tp, max_len=64, device="cpu")
    calls = []
    inner = drafter.propose

    def propose(rid, tokens, k):
        d = inner(rid, tokens, k)
        calls.append((list(tokens), k, d))
        return d

    drafter.propose = propose
    out, st, _ = _run(cfg, tp, subs, spec=SpecConfig(drafter, k=3))
    assert len(out[0]) == 8
    assert st.rolled_back > 0
    assert not drafter._fed and not drafter._cache     # released
    assert len(calls) > 1
    for i, (toks, k, d) in enumerate(calls):
        assert d == fresh.propose(100 + i, toks, k)


def test_facade_spec_stats_and_eos_mid_draft(setup):
    """stats()["spec"] through the facade (spec never runs one-shot), and
    an eos emitted inside an accepted draft run cuts the output there,
    as in the reference."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(23)
    prompts = [_repetitive(rng, cfg.vocab_size, 12, 3) for _ in range(2)]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=64, paged=True,
             page_size=8, spec=SpecConfig(NgramDrafter(), k=4)) as llm:
        outs = llm.generate(prompts, max_new=10)
        assert llm.last_executor == "batcher"
        st = llm.stats()["spec"]
    assert st["drafted"] > 0 and st["accepted"] > 0
    assert st["drafted"] == st["accepted"] + st["rolled_back"]
    assert set(st["per_request"]) == {o.rid for o in outs}
    assert all(o.finish_reason == "length" for o in outs)
    prompt = prompts[0]
    with LLM(cfg, tp, device="cpu", max_slots=1, max_len=64) as llm:
        base = llm.generate([prompt], max_new=10)[0].tokens
    eos = base[5]
    with LLM(cfg, tp, device="cpu", max_slots=1, max_len=64,
             spec=SpecConfig(NgramDrafter(), k=4)) as llm:
        out = llm.generate([prompt], max_new=10, eos=eos)[0]
        spec_st = llm.stats()["spec"]
    with JLLM(cfg, jp, max_slots=1, max_len=64,
              spec=jspec.SpecConfig(jspec.NgramDrafter(), k=4)) as jllm:
        jout = jllm.generate([prompt], max_new=10, eos=eos)[0]
        jspec_st = jllm.stats()["spec"]
    assert out.finish_reason == jout.finish_reason == "eos"
    assert out.tokens == jout.tokens == base[:base.index(eos) + 1]
    assert spec_st["accepted"] == jspec_st["accepted"]


class _ProductSpy:
    """Stands in for a host share: records the shape of each left operand
    it is multiplied by (``__array_ufunc__ = None`` makes numpy hand the
    product to ``__rmatmul__``)."""

    __array_ufunc__ = None

    def __init__(self, w):
        self.w, self.seen = w, []
        self.nbytes, self.shape = w.nbytes, w.shape

    def __rmatmul__(self, x):
        self.seen.append(x.shape)
        return x @ self.w


def test_verify_host_share_is_one_product(setup):
    """A verify step's (B, S, K) activations meet each host share in one
    (B * S, K) product (numpy would run a 3-D product as B products, each
    reading the whole share); one-token rows keep their 3-D call; the
    values are the per-row products either way."""
    cfg, _, tp = setup
    hb = HeteGenBackend(cfg, tp, hw=PAPER_A10, budget_bytes=0, batch=4,
                        tile=16, alpha_override=0.5, device="cpu")
    try:
        eng = hb.engines["decode"]
        name = next(iter(eng._host_part))
        w = eng._host_part[name]
        spy = eng._host_part[name] = _ProductSpy(w)
        rng = np.random.default_rng(24)
        for s in (1, 2, 5):
            x = rng.standard_normal((4, s, w.shape[0])).astype(np.float32)
            y = eng._host_matmul(x, name)
            want = np.stack([x[i] @ w for i in range(4)])
            assert y.shape == want.shape
            np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        assert spy.seen == [(4, 1, w.shape[0]), (8, w.shape[0]),
                            (20, w.shape[0])]
    finally:
        hb.close()
