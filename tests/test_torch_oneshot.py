"""One-shot generation over the dense KV cache, the port against the JAX
package on the same weights (JAX ``init_params`` through
``params_from_numpy``) and the same prompts:

* the resident whole model (``prefill`` / ``decode_step`` over the stacked
  cache, fp32 and int8) on ``tiny`` (GQA 4/2) and a reduced Mistral-NeMo
  (MHA after the cut): logits within 1e-4 (fp32 arithmetic on both sides,
  different summation orders; 1e-3 for int8 caches, where one cache value
  may round to the neighbouring int8 step) and identical greedy tokens;
* ``Generator`` over the params and over a ``HeteGenBackend`` (the paper's
  A10 spec with ``alpha_override=1.0``, so the 128-wide linears stream to
  the device share): identical tokens;
* ``OffloadGenerator`` on a reduced OPT-6.7B: identical tokens and the
  same planned decode and prefill alphas;
* ``LLM.generate``: a rectangular batch runs one-shot and gives the
  batcher's tokens; the dense batcher (``paged=False``) equals JAX.

On the CPU the attention route runs the kernels' plain versions; the
route itself (decode / prefill from 0 / plain) is the one the card takes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.hw import PAPER_A10 as J_A10
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.serving.backends import HeteGenBackend as JHB
from repro.serving.engine import Generator as JGen
from repro.serving.offload_runtime import OffloadGenerator as JOG
from repro_torch.core.hw import PAPER_A10 as T_A10
from repro_torch.kernels import ops as K
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import (HeteGenBackend, ResidentBackend,
                                          ScanResidentBackend)
from repro_torch.serving.engine import Generator
from repro_torch.serving.offload_runtime import OffloadGenerator

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_Q8 = dict(rtol=1e-3, atol=1e-3)


def _cfg(name, **kw):
    cfg = get_config(name)
    if name != "tiny":
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **kw)


def _params(cfg):
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return jp, TM.params_from_numpy(jtu.tree_map(np.asarray, jp),
                                    device="cpu")


@pytest.fixture(scope="module", params=["tiny", "mistral-nemo-12b"])
def setup(request):
    cfg = _cfg(request.param)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    return cfg, jp, tp, prompts


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_whole_model_logits_match(setup, kv_dtype):
    cfg, jp, tp, _ = setup
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    tol = TOL_Q8 if kv_dtype else TOL
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, 16)
    tc = TM.init_cache(cfg, 2, 16, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jc,
                        all_logits=True)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, tc,
                        all_logits=True)
    assert tl.shape == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)
    for _ in range(3):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jc, jl = JM.decode_step(cfg, jp, jtok, jc)
        tc, tl = TM.decode_step(cfg, tp, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    assert int(tc["len"]) == int(jc["len"]) == 12
    if kv_dtype:
        np.testing.assert_allclose(tc["ks0"].numpy(), np.asarray(jc["ks0"]),
                                   rtol=1e-5, atol=0)


def test_generator_over_params_matches_jax(setup):
    cfg, jp, tp, prompts = setup
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 5)
    got = Generator(cfg, tp).generate({"tokens": prompts}, 5)
    assert got.tokens == want.tokens
    assert len(got.tokens) == 3 and all(len(r) == 5 for r in got.tokens)


def test_generator_over_backends_matches_jax(setup):
    cfg, jp, tp, prompts = setup
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 5)
    jhb = JHB(cfg, jp, hw=J_A10, budget_bytes=0, alpha_override=1.0)
    thb = HeteGenBackend(cfg, tp, hw=T_A10, budget_bytes=0,
                         alpha_override=1.0, device="cpu")
    try:
        jgot = JGen(cfg, backend=jhb).generate(
            {"tokens": jnp.asarray(prompts)}, 5)
        got = Generator(cfg, backend=thb).generate({"tokens": prompts}, 5)
        assert thb.batch == jhb.batch == 3          # retuned to the batch
        assert thb.policy.alpha == jhb.policy.alpha
        assert thb.finish_stats().trans > 0
    finally:
        jhb.close()
        thb.close()
    assert got.tokens == jgot.tokens == want.tokens
    res = Generator(cfg, backend=ResidentBackend(cfg, tp, device="cpu")) \
        .generate({"tokens": prompts}, 5)
    assert res.tokens == want.tokens


def test_offload_generator_matches_jax():
    cfg = _cfg("opt-6.7b")
    jp, tp = _params(cfg)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jog = JOG(cfg, jp, hw=J_A10, budget_bytes=0, alpha_override=1.0)
    tog = OffloadGenerator(cfg, tp, hw=T_A10, budget_bytes=0,
                           alpha_override=1.0, device="cpu")
    try:
        want = jog.generate(prompts, 4)
        got = tog.generate(prompts, 4)
    finally:
        jog.close()
        tog.close()
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["tokens"].shape == (2, 4)
    assert got["alpha"] == want["alpha"]
    assert got["prefill_alpha"] == want["prefill_alpha"]
    assert got["batch"] == want["batch"] == 2
    assert got["stream_stats"].trans > 0 and got["stream_stats"].cpu > 0
    for key in ("prefill_s", "decode_s", "tokens_per_s", "resident_bytes",
                "pinned_overhead_bytes"):
        assert key in got


def test_llm_generate_oneshot_equals_batcher_and_jax(setup):
    cfg, jp, tp, prompts = setup
    p = [list(r) for r in prompts]
    with JLLM(cfg, jp, max_slots=2, max_len=32) as jllm:
        want = [o.tokens for o in jllm.generate(p, max_new=5)]
        assert jllm.last_executor == "generator"
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32) as llm:
        one = llm.generate(p, max_new=5)
        assert llm.last_executor == "generator"
        assert set(llm.last_metrics) == {"prefill_s", "decode_s",
                                         "tokens_per_s"}
        rids = [llm.submit(pi, 5) for pi in p]
        outs = llm.drain()
        assert llm.last_executor == "batcher"
    assert [o.tokens for o in one] == [outs[r].tokens for r in rids] == want
    # an eos inside the row truncates the one-shot output after it
    eos = want[0][2]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32) as llm:
        cut = llm.generate([p[0]], max_new=5, eos=eos)[0]
    assert cut.tokens == want[0][:want[0].index(eos) + 1]
    assert cut.finish_reason == "eos"


def test_dense_batcher_matches_jax():
    """``paged=False``: ragged admissions prefill from 0 (the flash route),
    chunked ones continue at an offset (the plain route), decode runs the
    flash-decode route at per-slot lengths."""
    cfg = _cfg("tiny")
    jp, tp = _params(cfg)
    rng = np.random.default_rng(3)
    p = [list(rng.integers(0, cfg.vocab_size, n)) for n in (5, 11, 8, 11)]

    def serve(llm_cls, params, **kw):
        with llm_cls(cfg, params, max_slots=2, max_len=32, chunk_tokens=6,
                     **kw) as llm:
            rids = [llm.submit(pi, 4) for pi in p]
            outs = llm.drain()
        return [outs[r].tokens for r in rids]

    K.reset_launch_counts()
    assert serve(LLM, tp, device="cpu") == serve(JLLM, jp)
    assert K.launch_counts()["plain_dense_attention"] == 0   # CPU


def test_attention_route_rule():
    z = torch.zeros((), dtype=torch.int32)
    assert TM.attention_route(z, 1) == "decode"
    assert TM.attention_route(z + 5, 1) == "decode"
    assert TM.attention_route(z, 7) == "prefill"
    assert TM.attention_route(torch.zeros(3, dtype=torch.int32), 7) \
        == "prefill"
    assert TM.attention_route(z + 4, 7) == "plain"
    assert TM.attention_route(torch.tensor([0, 3], dtype=torch.int32), 2) \
        == "plain"


def test_bf16_params_convert_exactly_and_serve():
    """JAX bf16 leaves come out of numpy as the ml_dtypes bfloat16 type;
    they convert exactly, and a bf16 config runs the whole model and the
    resident backend to the same greedy tokens."""
    cfg = _cfg("mistral-nemo-12b", dtype="bfloat16")
    jp, tp = _params(cfg)
    for (_, a), (_, b) in zip(jtu.tree_flatten_with_path(jp)[0],
                              jtu.tree_flatten_with_path(
                                  jtu.tree_map(lambda t: t, tp))[0]):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a).astype(np.float32))
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    whole = Generator(cfg, tp).generate({"tokens": prompts}, 4)
    be = Generator(cfg, backend=ResidentBackend(cfg, tp, device="cpu")) \
        .generate({"tokens": prompts}, 4)
    assert whole.tokens == be.tokens


@pytest.fixture
def bf16_dots(monkeypatch):
    """This CPU's XLA has no bf16 x bf16 -> fp32 dot, which the JAX
    package's attention asks for (``preferred_element_type=float32``).
    Widen such operands to fp32 first: bf16 products are exact in fp32 and
    the sum is fp32 either way, so the arithmetic is the same."""
    einsum = jnp.einsum

    def widened(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return einsum(spec, *ops,
                      preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", widened)


def test_int8_cache_dequantizes_in_model_dtype(bf16_dots):
    """A bf16 model over an int8 stacked cache dequantizes it in bf16, as
    the JAX package does (``k.astype(dt) * ks.astype(dt)``): the plain int8
    decode equals, element for element, the plain bf16 decode over the
    buffer JAX dequantizes; the whole model's decode logits stay within
    2e-2 of the largest |logit| of the JAX package's (a few bf16 steps:
    the frameworks round activations at other places)."""
    from repro_torch.kernels import ref as R
    rng = np.random.default_rng(8)
    k8 = rng.integers(-127, 128, (2, 2, 12, 16)).astype(np.int8)
    v8 = rng.integers(-127, 128, (2, 2, 12, 16)).astype(np.int8)
    ks = (rng.random((2, 2, 12)) * 0.02).astype(np.float32)
    vs = (rng.random((2, 2, 12)) * 0.02).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32)) \
        .bfloat16()
    lens = torch.tensor([5, 12], dtype=torch.int32)

    def jax_dequant(v, s):
        return torch.from_numpy(np.array(
            (jnp.asarray(v).astype(jnp.bfloat16)
             * jnp.asarray(s)[..., None].astype(jnp.bfloat16))
            .astype(jnp.float32))).bfloat16()

    int8 = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    got = R.decode_attention(q, torch.from_numpy(k8), torch.from_numpy(v8),
                             lens, **int8)
    want = R.decode_attention(q, jax_dequant(k8, ks), jax_dequant(v8, vs),
                              lens)
    assert torch.equal(got, want)
    # the rule is what matters: dequantized in fp32 (under an fp32 q),
    # the result is another one
    fp32 = R.decode_attention(q.float(), torch.from_numpy(k8),
                              torch.from_numpy(v8), lens, **int8)
    assert not torch.equal(fp32.bfloat16(), want)

    cfg = _cfg("mistral-nemo-12b", dtype="bfloat16", kv_dtype="int8")
    jp, tp = _params(cfg)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, 2, 16))
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        TM.init_cache(cfg, 2, 16, device="cpu"))
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        want = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_llm_builds_its_backend_lazily(setup):
    """``LLM(cfg, params)`` builds its batcher, and the batcher its
    ScanResidentBackend, when the batcher is first needed (as the JAX
    facade does), or a ResidentBackend at once for ``paged=True``;
    one-shot generation needs none."""
    cfg, _, tp, prompts = setup
    p = [list(r) for r in prompts]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32) as llm:
        llm.generate(p, max_new=3)
        assert llm.backend is None
        llm.generate([p[0], p[1][:5]], max_new=3)
        assert isinstance(llm.backend, ScanResidentBackend)
    with LLM(cfg, tp, device="cpu", paged=True, max_slots=2,
             max_len=32) as llm:
        assert isinstance(llm.backend, ResidentBackend)
