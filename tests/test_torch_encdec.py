"""Whisper-small's encoder-decoder in the port against the JAX package, on
the same weights (JAX ``init_params`` through ``params_from_numpy``, every
bias, zero at init, drawn at random on both sides) and the same seeded
numpy frames and tokens, at ``reduced()`` size (2 + 2 layers, 24 frames):

* the ``init_params`` tree (``enc_blocks``, ``enc_pos``,
  ``enc_final_norm``, ``cross``) and the cache tree (``cross_k`` /
  ``cross_v``) equal to the JAX package's;
* a prefill with frames, then decode steps: logits within 1e-4 of the
  largest |logit| in fp32 and 2e-2 in bf16, and every cache leaf (the
  cross K/V the prefill computed once among them) within the same;
* ``Generator.generate`` with ``enc_embeds`` beside the tokens: greedy
  tokens identical to the JAX package's ``Generator``;
* decode equal to teacher forcing (``forward_train`` over the whole
  sequence), as the JAX package's own model tests check;
* on the CPU the wrappers' plain routes run, and the counts of the
  calls that would launch on the card follow the route rule.
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
from repro.serving.engine import Generator as JGen
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops as K
from repro_torch.models import model as TM
from repro_torch.serving.engine import Generator

NAME = "whisper-small"
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT = 6


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced(get_config(NAME)), dtype=dtype)


def _perturb(tree, rng):
    """Draw every leaf that starts at zero (the biases) at random."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        a = np.asarray(t)
        if a.any():
            return a
        r = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return r.astype(a.dtype)
    return walk(tree)


def _params(cfg, seed=0):
    tree = _perturb(jtu.tree_map(np.asarray,
                                 JM.init_params(cfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed))
    return (jtu.tree_map(jnp.asarray, tree),
            TM.params_from_numpy(tree, device="cpu"))


def _inputs(cfg, b=2, s=PROMPT, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


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


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_config_is_the_jax_packages():
    assert dataclasses.asdict(t_get_config(NAME)) \
        == dataclasses.asdict(get_config(NAME))
    assert dataclasses.asdict(t_reduced(t_get_config(NAME))) \
        == dataclasses.asdict(reduced(get_config(NAME)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_trees_match(dtype):
    cfg = _cfg(dtype)
    mine = TM.init_params(cfg, 0, device="cpu")
    want = jtu.tree_map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert shapes(mine) == shapes(want)
    for k in ("enc_blocks", "enc_pos", "enc_final_norm", "cross"):
        assert k in mine
    jc = JM.init_cache(cfg, 3, 10)
    tc = TM.init_cache(cfg, 3, 10, device="cpu")
    assert shapes(tc) == shapes(jtu.tree_map(np.asarray, jc))
    assert tuple(tc["cross_k"].shape) == (cfg.n_layers, 3, cfg.encoder_seq,
                                          cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_frames_then_decode_match(dtype, bf16_dots):
    cfg = _cfg(dtype)
    jp, tp = _params(cfg)
    rel = REL_TOL[dtype]
    toks, frames = _inputs(cfg)
    jc = JM.init_cache(cfg, 2, PROMPT + 4)
    tc = TM.init_cache(cfg, 2, PROMPT + 4, device="cpu")
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks),
                                  "enc_embeds": jnp.asarray(frames)}, jc)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks),
                                  "enc_embeds": torch.from_numpy(frames)}, tc)
    _close(tl, jl, rel)
    for k in ("cross_k", "cross_v"):         # computed once, at the prefill
        assert bool(tc[k].abs().sum() > 0)
        _close(tc[k], jc[k], rel)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        _close(tl, jl, rel)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert int(tc["len"]) == int(jc["len"]) == PROMPT + 3
    for k in jc:
        if k != "len":
            _close(tc[k], jc[k], rel)


def test_greedy_tokens_match():
    cfg = _cfg()
    jp, tp = _params(cfg)
    toks, frames = _inputs(cfg, b=3, seed=2)
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(toks),
                                   "enc_embeds": jnp.asarray(frames)}, 6)
    got = Generator(cfg, tp).generate({"tokens": toks, "enc_embeds": frames},
                                      6)
    assert got.tokens == want.tokens
    # the frames reach the logits: other frames, other logits
    logits = []
    for f in (frames, frames[::-1].copy()):
        _, lg = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks),
                                     "enc_embeds": torch.from_numpy(f)},
                           TM.init_cache(cfg, 3, PROMPT, device="cpu"))
        logits.append(lg)
    assert float((logits[0] - logits[1]).abs().max()) \
        > 1e-2 * float(logits[0].abs().max())


def test_decode_matches_teacher_forcing():
    """Prefill 16 tokens with the frames, then decode steps over the cached
    cross K/V: the logits equal ``forward_train``'s over the whole
    sequence at every position (within 3e-5 of the largest, as the JAX
    package's model tests hold)."""
    cfg = reduced(get_config(NAME))
    tp = TM.init_params(cfg, 1, device="cpu")
    b, s, s0 = 2, 24, 16
    toks, frames = _inputs(cfg, b=b, s=s, seed=3)
    batch = {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(frames)}
    full = TM.forward_train(cfg, tp, batch)
    cache = TM.init_cache(cfg, b, s, device="cpu")
    cache, logits = TM.prefill(cfg, tp, {"tokens": batch["tokens"][:, :s0],
                                         "enc_embeds": batch["enc_embeds"]},
                               cache)
    scale = float(full.abs().max()) + 1e-6
    assert float((logits - full[:, s0 - 1]).abs().max()) / scale < 3e-5
    for t in range(s0, s):
        cache, logits = TM.decode_step(cfg, tp, batch["tokens"][:, t], cache)
        assert float((logits - full[:, t]).abs().max()) / scale < 3e-5, t


def test_routes_count_what_the_card_would_launch(monkeypatch):
    """On CPU tensors every wrapper takes its plain version; recording the
    calls shows the route rule: the prefill runs flash attention with
    ``causal=False`` for each encoder layer (S = encoder_seq) and each
    decoder layer's cross attention (Sq = the prompt), causal flash for
    the decoder's self-attention; a decode step runs flash-decode twice a
    layer, the cross attention's over all ``encoder_seq`` keys; every
    layer's MLP first stage is ``matmul`` with GELU and its bias."""
    cfg = _cfg()
    tp = TM.init_params(cfg, 0, device="cpu")
    toks, frames = _inputs(cfg)
    calls = []
    for name in ("flash_attention", "decode_attention", "matmul"):
        fn = getattr(K, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, a, kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, rec)
    cache = TM.init_cache(cfg, 2, PROMPT + 2, device="cpu")
    cache, logits = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks),
                                         "enc_embeds": torch.from_numpy(frames)},
                               cache)
    flash = [(a[0].shape[2], a[1].shape[2], kw["causal"])
             for n, a, kw in calls if n == "flash_attention"]
    enc, dec = cfg.encoder_layers, cfg.n_layers
    assert flash == [(cfg.encoder_seq, cfg.encoder_seq, False)] * enc + \
        [(PROMPT, PROMPT, True), (PROMPT, cfg.encoder_seq, False)] * dec
    mm = [(a[0].shape, kw["activation"], a[2] is not None)
          for n, a, kw in calls if n == "matmul"]
    assert mm == [((2 * cfg.encoder_seq, cfg.d_model), "gelu", True)] * enc \
        + [((2 * PROMPT, cfg.d_model), "gelu", True)] * dec
    calls.clear()
    TM.decode_step(cfg, tp, torch.argmax(logits, -1).to(torch.int32), cache)
    dec_calls = [(a[1].shape[2], a[3].tolist()) for n, a, _ in calls
                 if n == "decode_attention"]
    assert dec_calls == [(PROMPT + 2, [PROMPT + 1] * 2),
                         (cfg.encoder_seq, [cfg.encoder_seq] * 2)] * dec
    assert [n for n, *_ in calls].count("matmul") == dec
    assert not [n for n, *_ in calls if n == "flash_attention"]


def test_scan_resident_backend_serves_frames():
    """``ScanResidentBackend`` runs the encoder-decoder as the whole model
    does: a prefill with frames, then decode steps over the cached cross
    K/V, against the JAX package's."""
    from repro_torch.serving.backends import ScanResidentBackend
    cfg = _cfg()
    jp, tp = _params(cfg)
    toks, frames = _inputs(cfg, seed=4)
    be = ScanResidentBackend(cfg, tp, device="cpu")
    tc, tl = be.prefill({"tokens": torch.from_numpy(toks),
                         "enc_embeds": torch.from_numpy(frames)},
                        be.init_cache(2, PROMPT + 3))
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks),
                                  "enc_embeds": jnp.asarray(frames)},
                        JM.init_cache(cfg, 2, PROMPT + 3))
    _close(tl, jl, REL_TOL["float32"])
    for _ in range(2):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = be.decode(torch.from_numpy(tok), tc)
        _close(tl, jl, REL_TOL["float32"])
