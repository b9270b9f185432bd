"""The port's request-level sampler against the JAX package's.

The random streams differ (torch's generators against JAX's threefry), so
the port is held to the reference's *filtered distribution*
(``repro.serving.speculative.filtered_probs``): the kept set equal and the
probabilities within 1e-6, except at tokens where the mass before them
lies within ``crossing_tol(V)`` of ``p``: the reference sums in fp32 in
order, the port in another order, and an fp32 sum of V nonnegative terms
of total 1 may be off by (V - 1) 2^-24 in any order; greedy rows and every draw-free row bit-equal; logprobs within
1e-5 on the same logits (through the whole model, 1e-5 of the value: the
two forwards' own fp32 distance); 2^15 seeded draws a row passing a
chi-square test against the filtered distribution at p > 1e-3.  Within the port a request's tokens
depend only on its own stream: not on its batch row, its neighbours,
preemption with recompute, or one-shot against batched execution.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_config
from repro.models import model as JM
from repro.serving import sampling as jsam
from repro.serving.api import LLM as JLLM
from repro.serving.speculative import filtered_probs
from repro_torch.models import model as TM
from repro_torch.serving import sampling as tsam
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import ResidentBackend
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.sampling import SamplingParams

SP = SamplingParams
ROW_PARAMS = [
    SP(),
    SP(kind="temperature", temperature=0.7),
    SP(kind="temperature", temperature=1.5),
    SP(kind="temperature", temperature=0.0),        # the 1e-4 floor
    SP(kind="topk", top_k=1),
    SP(kind="topk", top_k=5, temperature=1.3),
    SP(kind="topk", top_k=40, temperature=0.8),
    SP(kind="topp", top_p=0.5),
    SP(kind="topp", top_p=0.9, temperature=1.2),
    SP(kind="topp", top_p=0.99, temperature=2.0),
    SP(kind="topp", top_p=1.0),
    SP(kind="topp", top_p=0.8, top_k=6, temperature=1.1),
]


def crossing_tol(n_vocab):
    """How far an fp32 prefix sum of ``n_vocab`` probabilities may lie
    from the exact one, in any summation order (first order)."""
    return (n_vocab - 1) * 2.0 ** -24


def _logits(seed, b, v, ties=True):
    x = np.random.default_rng(seed).standard_normal((b, v)) * 2.0
    # rounding to 0.25 puts many equal logits in every row
    return (np.round(x * 4) / 4 if ties else x).astype(np.float32)


def _port_filtered(logits, params):
    """The port's filter in vocab order: (kept mask, renormalized probs)."""
    packed = tsam.pack_sampling(params)
    order, sorted_scaled, keep = tsam.filter_sorted(torch.from_numpy(logits),
                                                    packed)
    probs = torch.softmax(sorted_scaled, dim=-1) * keep
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.zeros_like(probs).scatter_(-1, order, probs)
    kept = torch.zeros_like(keep).scatter_(-1, order, keep)
    return kept.numpy(), out.numpy()


def _crossing_margin(row, p):
    """|mass before each sorted position - top_p| in float64."""
    x = row.astype(np.float64) / max(p.temperature, 1e-4)
    order = np.argsort(row, kind="stable")[::-1]
    e = np.exp(x[order] - x.max())
    pr = e / e.sum()
    return order, np.abs(np.cumsum(pr) - pr - p.top_p)


@pytest.mark.parametrize("seed,v", [(0, 64), (1, 64), (2, 64), (0, 4096),
                                    (5, 4096)])
def test_filtered_distribution_equals_reference(seed, v):
    logits = _logits(seed, len(ROW_PARAMS), v)
    kept, probs = _port_filtered(logits, ROW_PARAMS)
    for i, p in enumerate(ROW_PARAMS):
        want = filtered_probs(logits[i], p)
        diff = np.flatnonzero(kept[i] != (want > 0))
        if diff.size:
            # only tokens at a top-p crossing, and only within rounding
            # (with top_p = 1 every token after the sum rounds to 1 is one)
            order, margin = _crossing_margin(logits[i], p)
            pos = [int(np.flatnonzero(order == t)[0]) for t in diff]
            assert margin[pos].max() <= crossing_tol(v), (i, diff)
            continue
        np.testing.assert_allclose(probs[i], want, rtol=0, atol=1e-6)


def test_descending_order_breaks_ties_like_reference():
    x = _logits(3, 4, 64)
    want = np.asarray(jnp.argsort(jnp.asarray(x), axis=-1)[:, ::-1])
    got = tsam.descending_order(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_rows(logits, params, keys_seed=0, top_logprobs=None):
    keys = jnp.stack([jax.random.PRNGKey(keys_seed + i)
                      for i in range(len(params))])
    return jsam.sample_rows(jnp.asarray(logits), keys,
                            jsam.pack_sampling(params),
                            top_logprobs=top_logprobs)


def _port_rows(logits, params, top_logprobs=None, seed=0):
    keys = [tsam.fold_in(tsam.seed_key(seed), i) for i in range(len(params))]
    return tsam.sample_rows(torch.from_numpy(logits), keys,
                            tsam.pack_sampling(params),
                            top_logprobs=top_logprobs)


DETERMINISTIC = [i for i, p in enumerate(ROW_PARAMS)
                 if p.kind == "greedy" or p.top_k == 1
                 or p.temperature == 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_free_rows_bit_equal(seed):
    """Greedy rows, top-1 rows (the first sorted position: the *higher*
    index among tied maxima) and the temperature floor's rows."""
    logits = _logits(seed, len(ROW_PARAMS), 64)
    want = np.asarray(_jax_rows(logits, ROW_PARAMS))
    got = _port_rows(logits, ROW_PARAMS).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[DETERMINISTIC], want[DETERMINISTIC])
    allg = [SP()] * 6
    x = _logits(seed + 10, 6, 128)
    np.testing.assert_array_equal(_port_rows(x, allg).numpy(),
                                  np.asarray(_jax_rows(x, allg)))
    np.testing.assert_array_equal(tsam.greedy(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsam.greedy(jnp.asarray(x))))


@pytest.mark.parametrize("k", [0, 3, 8])
def test_logprobs_equal_reference(k):
    logits = _logits(4, len(ROW_PARAMS), 64)
    jt, jinfo = _jax_rows(logits, ROW_PARAMS, top_logprobs=k)
    tt, tinfo = _port_rows(logits, ROW_PARAMS, top_logprobs=k)
    np.testing.assert_array_equal(tinfo["top_tokens"].numpy(),
                                  np.asarray(jinfo["top_tokens"]))
    np.testing.assert_allclose(tinfo["top_logprobs"].numpy(),
                               np.asarray(jinfo["top_logprobs"]),
                               rtol=0, atol=1e-5)
    jt, tt = np.asarray(jt), tt.numpy()
    np.testing.assert_array_equal(tt[DETERMINISTIC], jt[DETERMINISTIC])
    np.testing.assert_allclose(tinfo["logprob"].numpy()[DETERMINISTIC],
                               np.asarray(jinfo["logprob"])[DETERMINISTIC],
                               rtol=0, atol=1e-5)
    # every row's logprob is its own token's under the raw distribution
    x = logits.astype(np.float64)
    logz = np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) \
        + x.max(-1)
    own = x[np.arange(len(tt)), tt] - logz
    np.testing.assert_allclose(tinfo["logprob"].numpy(), own, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("p", [
    SP(kind="temperature", temperature=0.8),
    SP(kind="topk", top_k=5, temperature=1.5),
    SP(kind="topp", top_p=0.9, temperature=1.2),
    SP(kind="topp", top_p=0.7, top_k=8, temperature=2.0)],
    ids=["temperature", "topk", "topp", "topp+topk"])
def test_draws_follow_filtered_distribution(p):
    """2^15 draws of one row (each its own key) against the reference's
    filtered distribution: chi-square, bins of expected count < 5 merged."""
    n = 1 << 15
    row = _logits(5, 1, 32, ties=False)
    keys = [tsam.fold_in(tsam.seed_key(1234), j) for j in range(n)]
    toks = tsam.sample_rows(torch.from_numpy(row).expand(n, -1), keys,
                            tsam.pack_sampling([p] * n)).numpy()
    want = filtered_probs(row[0], p).astype(np.float64)
    assert set(np.unique(toks)) <= set(np.flatnonzero(want > 0))
    counts = np.bincount(toks, minlength=want.size).astype(np.float64)
    exp = want * n
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue > 1e-3


def test_row_independent_and_key_only():
    """A row's draw depends only on its logits and key: moved to another
    batch row beside other rows, it draws the same token; another key
    draws from the same stream family, not the same token every time."""
    logits = _logits(6, 4, 32, ties=False)
    sp = [SP(kind="topp", top_p=0.9, temperature=1.5)] * 4
    keys = [tsam.seed_key(s) for s in (9, 1, 2, 3)]
    a = tsam.sample_rows(torch.from_numpy(logits), keys,
                         tsam.pack_sampling(sp))
    moved = np.concatenate([logits[3:], logits[:1]])
    b = tsam.sample_rows(torch.from_numpy(moved), [keys[3], keys[0]],
                         tsam.pack_sampling(sp[:2]))
    assert int(a[0]) == int(b[1]) and int(a[3]) == int(b[0])
    many = tsam.sample_rows(
        torch.from_numpy(logits[:1]).expand(64, -1),
        [tsam.seed_key(s) for s in range(64)], tsam.pack_sampling(sp[:1] * 64))
    assert len(set(many.tolist())) > 1


def test_gumbel_noise_is_the_keys_splitmix64_stream():
    """The noise of row ``i`` at position ``j`` comes from the ``j``-th
    output of the splitmix64 stream seeded with the row's key, computed
    in int64 tensor arithmetic equal to the host's 64-bit integers; a key
    tensor and the same keys as integers draw the same tokens."""
    import math
    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.integers(0, 1 << 63, 64, dtype=np.int64)]
    keys += [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    kt = tsam.key_tensor(keys)
    assert kt.dtype == torch.int64
    assert tsam._mix64_t(kt).tolist() == [
        tsam._signed(tsam._mix64(k)) for k in keys]
    g = tsam.gumbel_noise(kt, 7)
    want = [[-math.log(-math.log(
        ((tsam._mix64((k + j * tsam._GAMMA) & tsam._MASK64) >> 11) + 0.5)
        * 2.0 ** -53)) for j in range(7)] for k in keys]
    np.testing.assert_allclose(g.numpy(), np.float32(want), rtol=0, atol=0)
    logits = torch.from_numpy(_logits(8, 4, 32, ties=False))
    sp = tsam.pack_sampling([SP(kind="temperature", temperature=2.0)] * 4)
    assert torch.equal(tsam.sample_rows(logits, keys[:4], sp),
                       tsam.sample_rows(logits, kt[:4], sp))


def test_whole_batch_samplers():
    logits = torch.from_numpy(_logits(7, 3, 32, ties=False))
    greedy = tsam.make_sampler(tsam.SamplerConfig())(logits, 0)
    assert greedy.tolist() == logits.argmax(-1).tolist()
    for kind in ("temperature", "topk", "topp"):
        fn = tsam.make_sampler(tsam.SamplerConfig(kind=kind, top_k=3))
        a, b = fn(logits, 5), fn(logits, 5)
        assert a.dtype == torch.int32 and a.tolist() == b.tolist()
        if kind == "topk":
            top3 = logits.topk(3).indices
            assert all(int(t) in top3[i] for i, t in enumerate(a))
    with pytest.raises(ValueError):
        tsam.make_sampler(tsam.SamplerConfig(kind="beam"))
    assert SP.from_config(tsam.SamplerConfig(kind="topk", top_k=7),
                          seed=3) == SP(kind="topk", top_k=7, seed=3)


# ---------------------------------------------------------------------------
# request streams through the port's serving paths (tiny)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


# tiny's random logits lead by ~25 nats: a hot temperature makes the
# stochastic requests actually explore
HOT = [SP(kind="topp", top_p=0.95, temperature=40.0, seed=3),
       SP(),
       SP(kind="temperature", temperature=40.0),            # unseeded
       SP(kind="topk", top_k=8, temperature=40.0, seed=4)]


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, cfg.vocab_size, n)) for n in lens]


def _batcher(cfg, tp, reqs, **kw):
    if kw.get("paged"):        # paged serving over the per-layer backend,
        kw.update(backend=ResidentBackend(cfg, tp, device="cpu"),
                  own_backend=True)            # as LLM(paged=True) builds
    b = ContinuousBatcher(cfg, tp, max_len=48, device="cpu",
                          **{"max_slots": 2, **kw})
    rids = [b.submit(p, n, sampling=sp, rid=rid) for rid, p, n, sp in reqs]
    out = b.run_until_done()
    b.close()
    return [out[r] for r in rids]


@pytest.mark.parametrize("conf", [dict(), dict(kind="topk", top_k=1)])
def test_batcher_takes_reference_sampler(tiny, conf):
    """``ContinuousBatcher(cfg, params, sampler=SamplerConfig(...))``, the
    reference's call, lifts the config through ``from_config`` and gives
    the reference's greedy tokens (top-k of 1 keeps only the argmax)."""
    from repro.serving.batcher import ContinuousBatcher as JBatcher
    cfg, jp, tp = tiny
    prompts = _prompts(cfg, (5, 9, 3))
    tb = ContinuousBatcher(cfg, tp, max_slots=2, max_len=48, device="cpu",
                           sampler=tsam.SamplerConfig(**conf))
    assert tb.default_sampling == SP.from_config(tsam.SamplerConfig(**conf))
    jb = JBatcher(cfg, jp, max_slots=2, max_len=48,
                  sampler=jsam.SamplerConfig(**conf))
    got, want = [], []
    for b, out in ((tb, got), (jb, want)):
        rids = [b.submit(p, 6) for p in prompts]
        res = b.run_until_done()
        b.close()
        out.extend(list(map(int, res[r])) for r in rids)
    assert got == want


def test_tokens_independent_of_row_neighbours_and_paging(tiny):
    cfg, _, tp = tiny
    prompts = _prompts(cfg, (5, 9, 3, 7))
    reqs = [(rid, p, 6, sp) for rid, (p, sp) in enumerate(zip(prompts, HOT))]
    dense = _batcher(cfg, tp, reqs)
    paged = _batcher(cfg, tp, reqs, paged=True, page_size=8)
    rev = _batcher(cfg, tp, reqs[::-1], max_slots=4, paged=True,
                   page_size=8)[::-1]
    alone = [_batcher(cfg, tp, [r])[0] for r in reqs]
    assert dense == paged == rev == alone
    # the hot requests explored: not every token is the greedy one
    greedy = _batcher(cfg, tp, [(rid, p, n, SP()) for rid, p, n, _ in reqs])
    assert dense[0] != greedy[0] and dense[3] != greedy[3]


def test_tokens_survive_preemption_with_recompute(tiny):
    cfg, _, tp = tiny
    prompts = _prompts(cfg, (6, 7, 5), seed=2)
    sps = [HOT[0], HOT[2], HOT[3]]

    def serve(**kw):
        with LLM(cfg, tp, device="cpu", paged=True, page_size=8,
                 max_slots=3, max_len=64, seed=5, **kw) as llm:
            outs = llm.generate(prompts, max_new=10, sampling=sps)
            pre = llm.stats()["scheduler"]["preemptions"]
        return [o.tokens for o in outs], pre

    free, n0 = serve()
    pressed, n1 = serve(n_pages=5, preempt_mode="recompute")
    assert n0 == 0 and n1 > 0
    assert pressed == free


def test_one_shot_equals_batched(tiny):
    cfg, _, tp = tiny
    prompts = _prompts(cfg, (8, 8, 8), seed=3)
    sps = [HOT[0], HOT[1], HOT[2]]
    with LLM(cfg, tp, device="cpu", max_slots=3, max_len=32,
             seed=11) as llm:
        one = llm.generate(prompts, max_new=4, sampling=sps)
        assert llm.last_executor == "generator"
    with LLM(cfg, tp, device="cpu", max_slots=3, max_len=32,
             seed=11) as llm:
        rids = [llm.submit(p, 4, sampling=sp) for p, sp in zip(prompts, sps)]
        outs = llm.drain()
        assert llm.last_executor == "batcher"
    assert [o.tokens for o in one] == [outs[r].tokens for r in rids]
    with LLM(cfg, tp, device="cpu", max_slots=3, max_len=32,
             seed=12) as llm:
        other = llm.generate(prompts, max_new=4, sampling=sps)
    # the seeded request keeps its stream; the unseeded one follows the
    # facade's seed
    assert other[0].tokens == one[0].tokens
    assert other[2].tokens != one[2].tokens


# through the whole model the two packages' fp32 forwards differ before
# the sampler does (tiny's logprobs reach -30, where the logits of the two
# forwards lie about 1.5e-5 apart): 1e-5 of the value, or 1e-5
LP_TOL = dict(rel=1e-5, abs=1e-5)


def test_llm_logprobs_layout_and_values_equal_reference(tiny):
    cfg, jp, tp = tiny
    prompts = _prompts(cfg, (8, 8), seed=4)
    sp = SP(logprobs=3)
    with JLLM(cfg, jp, max_slots=2, max_len=32) as jllm:
        want = jllm.generate(prompts, max_new=4,
                             sampling=jsam.SamplingParams(logprobs=3))
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32) as llm:
        got = llm.generate(prompts, max_new=4, sampling=sp)
        assert llm.last_executor == "batcher"
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert len(g.logprobs) == len(w.logprobs) == 4
        for a, b in zip(g.logprobs, w.logprobs):
            assert a.keys() == b.keys() == {"token", "logprob", "top"}
            assert a["token"] == b["token"]
            assert a["logprob"] == pytest.approx(b["logprob"], **LP_TOL)
            assert list(a["top"]) == list(b["top"])
            for t in a["top"]:
                assert a["top"][t] == pytest.approx(b["top"][t], **LP_TOL)
