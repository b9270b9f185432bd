"""The port's text and streaming front ends against the JAX package's:
the byte tokenizer and the streaming UTF-8 decoder, ``LLM.stream``,
per-token callbacks, ``drain`` beside live streams, text prompts and
``stream_text``, and the event-loop ``AsyncLLM``.  The same params
(carried across through numpy) and requests give the reference's tokens
and text on ``tiny``."""
import threading

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

from repro.configs import get_config
from repro.models import model as JM
from repro.serving import tokenizer as jtok
from repro.serving.api import LLM as JLLM
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM, AsyncLLM, GenRequest
from repro_torch.serving.speculative import NgramDrafter, SpecConfig
from repro_torch.serving.tokenizer import ByteTokenizer, StreamDecoder


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("tiny")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]


def _llm(tp, cfg, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 32)
    return LLM(cfg, tp, device="cpu", **kw)


def _ref_tokens(cfg, jp, prompts, max_new, **kw):
    """The reference's tokens for ``prompts`` submitted together."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 32)
    with JLLM(cfg, jp, seed=0, **kw) as jllm:
        rids = [jllm.submit(p, max_new) for p in prompts]
        out = jllm.drain()
    return [out[r].tokens for r in rids]


# ---------------------------------------------------------------------------
# the byte tokenizer and the streaming decoder
# ---------------------------------------------------------------------------

TEXTS = ["hello", "héllo wörld", "καλημέρα", "🙂 ok", "a€b", ""]


def test_byte_tokenizer_roundtrip():
    tok, ref = ByteTokenizer(), jtok.ByteTokenizer()
    for s in TEXTS:
        ids = tok.encode(s)
        assert ids == ref.encode(s)
        assert all(0 <= t <= 255 for t in ids)
        assert tok.decode(ids) == s
    # ids outside a byte decode as the reference decodes them
    for ids in ([104, 105, 400], [-3, 65], [0xE2, 0x82]):
        assert tok.decode(ids) == ref.decode(ids)
    assert tok.decode([104, 105, 400]) == "hi" + tok.decode([255])
    assert tok.eos_id == 0 and ByteTokenizer(eos_id=None).eos_id is None


def test_stream_decoder_holds_split_characters():
    tok = ByteTokenizer()
    dec = StreamDecoder(tok)
    pushed = [dec.push(b) for b in tok.encode("a€b")]     # € is 3 bytes
    assert pushed == ["a", "", "", "€", "b"]
    assert dec.flush() == ""
    dec2 = StreamDecoder(tok)
    assert [dec2.push(b) for b in tok.encode("€")[:2]] == ["", ""]
    assert dec2.flush() != ""


@settings(max_examples=200, deadline=None)
@given(hst.lists(hst.integers(0, 300), max_size=24))
def test_stream_decoder_equals_reference(ids):
    """Over arbitrary id runs (split characters, stray continuation bytes,
    ids past a byte) every push and the flush give the reference's
    text."""
    ours = StreamDecoder(ByteTokenizer())
    theirs = jtok.StreamDecoder(jtok.ByteTokenizer())
    assert [ours.push(t) for t in ids] == [theirs.push(t) for t in ids]
    assert ours.flush() == theirs.flush()


# ---------------------------------------------------------------------------
# the synchronous facade: streams, callbacks, text
# ---------------------------------------------------------------------------

def test_stream_iterator_and_callback(setup):
    cfg, jp, tp = setup
    p = _prompts(1, cfg.vocab_size, (6,))[0]
    want = _ref_tokens(cfg, jp, [p], 5)[0]
    with _llm(tp, cfg) as llm:
        ref = llm.generate([p], max_new=5)[0]
        streamed = list(llm.stream(p, max_new=5))
        got = []
        llm.submit(p, 5, on_token=got.append)
        via_req = []
        llm.submit(GenRequest(p, 5, stream=via_req.append))
        llm.drain()
        assert llm._callbacks == {}          # released on finish
    assert streamed == ref.tokens == got == via_req == want


def test_callback_forces_the_batcher(setup):
    """A rectangular batch with a per-token callback runs through the
    batcher (the one-shot generator has no per-token delivery)."""
    cfg, _, tp = setup
    p = _prompts(2, cfg.vocab_size, (5, 5))
    with _llm(tp, cfg) as llm:
        seen = []
        outs = llm.generate([GenRequest(p[0], 4, stream=seen.append),
                             GenRequest(p[1], 4)])
        assert llm.last_executor == "batcher"
        assert seen == outs[0].tokens


def test_drain_leaves_live_streams_alone(setup):
    """A drain() beside a suspended stream() iterator neither evicts nor
    reports the stream's request: the iterator owns it."""
    cfg, jp, tp = setup
    p = _prompts(3, cfg.vocab_size, (5,))[0]
    want = _ref_tokens(cfg, jp, [p], 4)[0]
    with _llm(tp, cfg) as llm:
        it = llm.stream(p, max_new=4)
        first = next(it)
        assert llm.drain() == {}
        assert [first] + list(it) == want
        assert llm._batcher.requests == {}
        it2 = llm.stream(p, max_new=4)
        assert llm.drain() == {}
        assert list(it2) == want


def test_text_io_and_stream_text(setup):
    """Text in, text out, blocking and streaming; the text is the
    reference's on the same request."""
    cfg, jp, tp = setup
    tok = ByteTokenizer(eos_id=None)
    with JLLM(cfg, jp, max_slots=2, max_len=64,
              tokenizer=jtok.ByteTokenizer(eos_id=None)) as jllm:
        jout = jllm.generate("abcabcabc", max_new=8)[0]
        jchunks = list(jllm.stream_text("héllo", max_new=8))
    with _llm(tp, cfg, max_len=64, tokenizer=tok) as llm:
        out = llm.generate("abcabcabc", max_new=8)[0]
        assert out.prompt == tok.encode("abcabcabc")
        assert out.text == tok.decode(out.tokens)
        assert out.finish_reason == "length"
        assert (out.tokens, out.text) == (jout.tokens, jout.text)
        chunks = list(llm.stream_text("abcabcabc", max_new=8))
        assert "".join(chunks) == out.text
        assert list(llm.stream_text("héllo", max_new=8)) == jchunks
        rid = llm.submit("xyz", 3)
        sub = llm.drain()[rid]
        assert sub.prompt == tok.encode("xyz")
        assert sub.text == tok.decode(sub.tokens)
    with _llm(tp, cfg, max_slots=1, max_len=64) as llm:
        with pytest.raises(ValueError, match="tokenizer"):
            llm.generate("abc", max_new=4)
        with pytest.raises(ValueError, match="tokenizer"):
            list(llm.stream_text([1, 2, 3], max_new=2))
        assert llm.generate([[1, 2, 3]], max_new=4)[0].text is None


def test_tokenizer_eos_threads_into_requests(setup):
    """A tokenizer's eos id stops requests that pass no eos, one-shot and
    batched alike, as in the reference."""
    cfg, jp, tp = setup
    p = _prompts(4, cfg.vocab_size, (6,))[0]
    with _llm(tp, cfg) as llm:
        free = llm.generate([p], max_new=6)[0].tokens
    eos = free[2]
    with _llm(tp, cfg, tokenizer=ByteTokenizer(eos_id=eos)) as llm:
        one = llm.generate([p], max_new=6)[0]
        rid = llm.submit(p, 6)
        batched = llm.drain()[rid]
    with JLLM(cfg, jp, max_slots=2, max_len=32,
              tokenizer=jtok.ByteTokenizer(eos_id=eos)) as jllm:
        jone = jllm.generate([p], max_new=6)[0]
    assert one.tokens == batched.tokens == jone.tokens \
        == free[:free.index(eos) + 1]
    assert one.finish_reason == batched.finish_reason == "eos"


# ---------------------------------------------------------------------------
# AsyncLLM
# ---------------------------------------------------------------------------

def test_async_llm_streams_without_step(setup):
    """stream() yields every token with no caller-driven step(), the
    reference's tokens; the loop thread serves on the facade's device."""
    cfg, jp, tp = setup
    p = _prompts(5, cfg.vocab_size, (6, 4))
    want = _ref_tokens(cfg, jp, p, 5)
    with AsyncLLM(cfg, tp, device="cpu", max_slots=2, max_len=32,
                  seed=0) as allm:
        assert allm.llm.device.type == "cpu"
        h = allm.submit(p[0], 5)
        got = list(allm.stream(p[1], 5))
        assert got == want[1]
        assert h.result(60).tokens == want[0]
        assert h.done
        assert allm.stats()["executor"] == "batcher(async)"


def test_async_llm_honours_gen_request_stream(setup):
    cfg, _, tp = setup
    p = _prompts(6, cfg.vocab_size, (5,))[0]
    got = []
    with AsyncLLM(cfg, tp, device="cpu", max_slots=2, max_len=32,
                  seed=0) as allm:
        h = allm.submit(GenRequest(p, 4, stream=got.append))
        out = h.result(60)
    assert got == out.tokens and len(got) == 4


def test_async_llm_concurrent_submitters(setup):
    """Many threads share one loop; every handle resolves to the tokens
    the reference gives that prompt."""
    cfg, jp, tp = setup
    p = _prompts(7, cfg.vocab_size, (3, 4, 5, 6))
    want = _ref_tokens(cfg, jp, p, 4)
    results = {}
    with AsyncLLM(cfg, tp, device="cpu", max_slots=2, max_len=32,
                  seed=0) as allm:
        def worker(i):
            results[i] = allm.submit(p[i], 4).result(120).tokens
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    # greedy tokens depend on the prompt alone
    assert [results[i] for i in range(4)] == want


def test_async_llm_close_semantics(setup):
    """close() drains by default; close(drain=False) fails in-flight
    handles, refuses new submits, and iteration ends instead of
    hanging."""
    cfg, _, tp = setup
    p = _prompts(8, cfg.vocab_size, (5,))[0]
    allm = AsyncLLM(cfg, tp, device="cpu", max_slots=1, max_len=64, seed=0)
    h = allm.submit(p, 6)
    allm.close()
    assert h.done and len(h.result().tokens) == 6
    allm.close()
    allm = AsyncLLM(cfg, tp, device="cpu", max_slots=1, max_len=64, seed=0)
    h2 = allm.submit(p, 50)
    it = iter(h2)
    allm.close(drain=False)
    with pytest.raises(RuntimeError, match="in flight"):
        h2.result()
    with pytest.raises(RuntimeError, match="in flight"):
        list(it)
    with pytest.raises(RuntimeError, match="closed"):
        allm.submit(p, 2)


def test_async_llm_surfaces_scheduler_stall(setup):
    cfg, _, tp = setup
    p = _prompts(9, cfg.vocab_size, (9,))[0]
    with AsyncLLM(cfg, tp, device="cpu", paged=True, page_size=8,
                  n_pages=3, max_slots=2, max_len=64, seed=0) as allm:
        h = allm.submit(p, 30)
        with pytest.raises(RuntimeError, match="stalled"):
            h.result(120)
        with pytest.raises(RuntimeError, match="loop failed"):
            allm.submit([1, 2, 3], 2)


def test_async_llm_priority_jumps_queue(setup):
    """A high-priority request submitted after two long ones runs first.
    The three are queued while the test holds the loop's lock, so the
    loop cannot step before all three wait: the priority policy admits
    the high one first into the single slot, and its tokens are all
    delivered before any low-priority token (no race with the loop)."""
    cfg, _, tp = setup
    p = _prompts(10, cfg.vocab_size, (5, 5, 5))
    order = []
    with AsyncLLM(cfg, tp, device="cpu", max_slots=1, max_len=64, seed=0,
                  policy="priority") as allm:
        with allm._work:
            lows = [allm.submit(GenRequest(
                p[i], 20, stream=lambda t, i=i: order.append(i)))
                for i in range(2)]
            hi = allm.submit(GenRequest(
                p[2], 3, priority=9, stream=lambda t: order.append(2)))
        out = hi.result(300)
        for h in lows:
            assert len(h.result(300).tokens) == 20
    assert len(out.tokens) == 3
    assert order[:3] == [2, 2, 2] and order.count(2) == 3
    assert len(order) == 43


def test_async_llm_speculative_tokens(setup):
    """AsyncLLM over a speculative facade (``llm=``): the loop thread
    runs the verify steps and the tokens are the plain run's."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(11)
    motifs = [[int(t) for t in rng.integers(1, cfg.vocab_size, 3)]
              for _ in range(2)]
    p = [(m * 4)[:12] for m in motifs]
    want = _ref_tokens(cfg, jp, p, 8, max_len=64)
    llm = _llm(tp, cfg, max_len=64, paged=True, page_size=8,
               spec=SpecConfig(NgramDrafter(), k=4))
    with AsyncLLM(llm=llm) as allm:
        its = [allm.stream(q, 8) for q in p]
        got = [list(it) for it in its]
    st = llm.stats()["spec"]
    llm.close()
    assert got == want
    assert st["accepted"] > 0
