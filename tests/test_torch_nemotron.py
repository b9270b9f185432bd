"""Nemotron-4-340B in the port against the JAX package, on the same
weights and seeded prompts: its reduced config (GQA, squared-ReLU MLP,
LayerNorm) and the same reduced config at Nemotron's head dim of 192 with
its GQA group of 12 query heads a kv-head (the shape the bf16 attention
kernels were widened to): prefill and decode logits within 1e-4 of the
largest |logit| in fp32 and 2e-2 in bf16, greedy tokens identical from
``Generator``, and the paged batcher over ``ResidentBackend`` giving the
JAX package's tokens.
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
from repro_torch.serving.engine import Generator

NAME = "nemotron-4-340b"
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT = 10
SHAPES = {"reduced": {}, "hd192": dict(head_dim=192, n_heads=24,
                                       n_kv_heads=2)}


def _cfg(shape, dtype="float32"):
    return dataclasses.replace(reduced(get_config(NAME)), dtype=dtype,
                               **SHAPES[shape])


def _params(cfg, seed=0):
    tree = jtu.tree_map(np.asarray,
                        JM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(t):                     # LayerNorm biases drawn at random
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if t.any():
            return t
        return (0.05 * rng.standard_normal(t.shape)).astype(t.dtype)
    tree = walk(tree)
    return (jtu.tree_map(jnp.asarray, tree),
            TM.params_from_numpy(tree, device="cpu"))


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


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match(shape, dtype, bf16_dots):
    cfg = _cfg(shape, dtype)
    assert cfg.mlp_kind == "relu2" and cfg.norm_kind == "layernorm"
    jp, tp = _params(cfg)
    rel = REL_TOL[dtype]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, PROMPT + 4)
    tc = TM.init_cache(cfg, 2, PROMPT + 4, device="cpu")
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, rel)
    for _ in range(3):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        _close(tl, jl, rel)
    for k in jc:
        if k != "len":
            _close(tc[k], jc[k], rel)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_greedy_tokens_match(shape):
    cfg = _cfg(shape)
    jp, tp = _params(cfg)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 6)
    got = Generator(cfg, tp).generate({"tokens": prompts}, 6)
    assert got.tokens == want.tokens


def test_paged_batcher_at_head_dim_192_matches_jax():
    cfg = _cfg("hd192")
    jp, tp = _params(cfg)
    rng = np.random.default_rng(3)
    p = [list(rng.integers(0, cfg.vocab_size, n)) for n in (5, 11, 8)]
    kw = dict(max_slots=2, max_len=32, paged=True, page_size=8)
    with LLM(cfg, tp, device="cpu", **kw) as llm:
        got = [o.tokens for o in llm.generate(p, max_new=5)]
    with JLLM(cfg, jp, **kw) as jllm:
        want = [o.tokens for o in jllm.generate(p, max_new=5)]
    assert got == want
