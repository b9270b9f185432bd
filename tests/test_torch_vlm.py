"""LLaVA-NeXT-Mistral-7B's patch-embedding prefill in the port against the
JAX package, on the same weights (JAX ``init_params`` through
``params_from_numpy``) and the same seeded numpy embeddings and tokens, at
``reduced()`` size:

* a prefill from ``embeds`` (B, S, d) in place of token embeddings, then
  decode steps on tokens: logits within 1e-4 of the largest |logit| in
  fp32 and 2e-2 in bf16, through the whole model, ``ScanResidentBackend``,
  ``ResidentBackend`` and ``HeteGenBackend`` (every weight on the device,
  ``alpha_override=1.0``, and split between host and device at
  ``tile=16``), each against the JAX package's whole model;
* ``Generator.generate`` from ``embeds``: greedy tokens identical to the
  JAX package's ``Generator``;
* the dense batcher on tokens (ragged prompts, as for Mistral): tokens
  identical to the JAX package's batcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.serving.engine import Generator as JGen
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import (HeteGenBackend, ResidentBackend,
                                          ScanResidentBackend)
from repro_torch.serving.engine import Generator

NAME = "llava-next-mistral-7b"
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT = 12


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced(get_config(NAME)), dtype=dtype)


def _params(cfg, seed=0):
    tree = jtu.tree_map(np.asarray,
                        JM.init_params(cfg, jax.random.PRNGKey(seed)))
    return (jtu.tree_map(jnp.asarray, tree),
            TM.params_from_numpy(tree, device="cpu"))


def _embeds(cfg, b=2, s=PROMPT, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.fixture
def bf16_dots(monkeypatch):
    """This CPU's XLA has no bf16 x bf16 -> fp32 dot; widen such operands
    to fp32 first (bf16 products are exact in fp32, the sum is fp32)."""
    einsum = jnp.einsum

    def widened(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return einsum(spec, *ops,
                      preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", widened)


def _close(got, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _jax_run(cfg, jp, emb, steps=3):
    """The JAX package's prefill from ``emb`` and ``steps`` greedy decode
    steps: (prefill logits, [decode logits], [tokens fed])."""
    jc = JM.init_cache(cfg, emb.shape[0], emb.shape[1] + steps + 1)
    jc, jl = JM.prefill(cfg, jp, {"embeds": jnp.asarray(emb)}, jc)
    first, outs, fed = jl, [], []
    for _ in range(steps):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        fed.append(tok)
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        outs.append(jl)
    return first, outs, fed


def _port_run(prefill, decode, cache, emb, fed):
    cache, first = prefill({"embeds": torch.from_numpy(emb)}, cache)
    outs = []
    for tok in fed:
        cache, lg = decode(torch.from_numpy(tok), cache)
        outs.append(lg)
    return first, outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_prefill_from_embeds(dtype, bf16_dots):
    cfg = _cfg(dtype)
    jp, tp = _params(cfg)
    rel = REL_TOL[dtype]
    emb = _embeds(cfg)
    want, want_dec, fed = _jax_run(cfg, jp, emb)
    got, got_dec = _port_run(
        lambda b, c: TM.prefill(cfg, tp, b, c),
        lambda t, c: TM.decode_step(cfg, tp, t, c),
        TM.init_cache(cfg, 2, PROMPT + 4, device="cpu"), emb, fed)
    _close(got, want, rel)
    for g, w in zip(got_dec, want_dec):
        _close(g, w, rel)
    # the embeddings, not a token lookup, feed the trunk
    _, other = TM.prefill(cfg, tp, {"embeds": torch.from_numpy(2 * emb)},
                          TM.init_cache(cfg, 2, PROMPT, device="cpu"))
    assert float((other - got).abs().max()) > 1e-2 * float(got.abs().max())


def _backend(kind, cfg, tp):
    if kind == "scan":
        return ScanResidentBackend(cfg, tp, device="cpu")
    if kind == "resident":
        return ResidentBackend(cfg, tp, device="cpu")
    if kind == "hetegen":
        return HeteGenBackend(cfg, tp, alpha_override=1.0, device="cpu")
    return HeteGenBackend(cfg, tp, budget_bytes=0, alpha_override=0.5,
                          tile=16, device="cpu")


@pytest.mark.parametrize("kind", ["scan", "resident", "hetegen",
                                  "hetegen_split"])
def test_backends_prefill_from_embeds(kind):
    """Each serving backend's ``prefill`` takes the patch embeddings and
    its ``decode`` tokens, against the JAX package's whole model; the
    HeteGen split's prefill plan is sized from the embeddings' (B, S)."""
    cfg = _cfg()
    jp, tp = _params(cfg)
    emb = _embeds(cfg, seed=2)
    want, want_dec, fed = _jax_run(cfg, jp, emb)
    be = _backend(kind, cfg, tp)
    try:
        got, got_dec = _port_run(be.prefill, be.decode,
                                 be.init_cache(2, PROMPT + 4), emb, fed)
        if kind.startswith("hetegen"):
            pol = be.policies["prefill"]
            assert (pol.batch, pol.tokens_per_seq) == (2, PROMPT)
            alphas = {p.alpha for p in pol.plan if p.mode == "hetegen"}
            if kind == "hetegen_split":
                assert alphas == {0.5}
    finally:
        be.close()
    _close(got, want, REL_TOL["float32"])
    for g, w in zip(got_dec, want_dec):
        _close(g, w, REL_TOL["float32"])


def test_greedy_tokens_from_embeds_match():
    cfg = _cfg()
    jp, tp = _params(cfg)
    emb = _embeds(cfg, b=3, seed=3)
    want = JGen(cfg, jp).generate({"embeds": jnp.asarray(emb)}, 6)
    got = Generator(cfg, tp).generate({"embeds": emb}, 6)
    assert got.tokens == want.tokens
    be = ResidentBackend(cfg, tp, device="cpu")
    assert Generator(cfg, backend=be).generate({"embeds": emb}, 6).tokens \
        == want.tokens


def test_dense_batcher_on_tokens_matches_jax():
    """Served on tokens, the VLM backbone goes through the dense batcher's
    ``ScanResidentBackend`` as Mistral does."""
    cfg = _cfg()
    jp, tp = _params(cfg)
    rng = np.random.default_rng(7)
    p = [list(rng.integers(0, cfg.vocab_size, n)) for n in (5, 11, 8, 11)]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=40) as llm:
        outs = llm.generate(p, max_new=5)
        assert llm.last_executor == "batcher"
        assert isinstance(llm.backend, ScanResidentBackend)
    with JLLM(cfg, jp, max_slots=2, max_len=40) as jllm:
        jout = jllm.generate(p, max_new=5)
    assert [o.tokens for o in outs] == [o.tokens for o in jout]
