"""Mamba2 in the port against the JAX package, on the same seeded inputs:

* the intra-chunk kernel's plain version against the Pallas kernel run in
  interpret mode (chunk 16, one and four chunks, B/C broadcast from one
  and from two groups): fp32 within 1e-5 of the largest |value|; in bf16
  the Pallas kernel rounds y_intra to bf16 and the port keeps it fp32, so
  y is held to one bf16 rounding (2^-8 relative) and the fp32 outputs to
  1e-5; the kernel's per-element limits admit the Pallas kernel's order
  and reject, in every row of a chunk, a y rounded to bf16 or a y over a
  bf16 G;
* the SSD pieces (chunked with a carried state, the scan, the decode step,
  a block's prefill then decode): 1e-4 (fp32 on both sides, other
  summation orders);
* the whole model on ``reduced(mamba2-2.7b)`` (2 layers, fp32): prefill and
  decode logits within 1e-4 for a chunked (48) and a scanned (20) prompt,
  identical greedy tokens through ``Generator`` and ``LLM.generate``, and
  the same ``NotImplementedError`` for a ragged batch and ``paged=True``;
  in bf16, logits within 2e-2 of the largest |logit| (a few bf16 steps:
  the frameworks round activations at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import ssd_chunk as jssd
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving.api import LLM as JLLM
from repro.serving.engine import Generator as JGen
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serving.api import LLM
from repro_torch.serving.engine import Generator

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS = 2e-2


def _inputs(seed, b=2, l=64, h=4, p=8, n=16, g=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((b, l, h, p)).astype(f),
                dt=np.abs(rng.standard_normal((b, l, h))).astype(f),
                a=-np.abs(rng.standard_normal(h)).astype(f),
                b=rng.standard_normal((b, l, g, n)).astype(f),
                c=rng.standard_normal((b, l, g, n)).astype(f),
                d=rng.standard_normal(h).astype(f))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, rtol, scale_tol):
    """|got - want| <= rtol |want| + scale_tol max|want|."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_tol * float(np.abs(want).max()))


def _heads(a, h):
    return np.repeat(a, h // a.shape[2], axis=2)


@pytest.mark.parametrize("l", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_matches_pallas(l, g):
    i = _inputs(0, l=l, g=g)
    h = i["x"].shape[2]
    want = jssd.ssd_chunk(*(jnp.asarray(v) for v in (
        i["x"], i["dt"], i["a"], _heads(i["b"], h), _heads(i["c"], h))),
        chunk=16, interpret=True)
    got = K.ssd_chunk(_t(i["x"]), _t(i["dt"]), _t(i["a"]),
                      TS.heads_of_groups(_t(i["b"]), h),
                      TS.heads_of_groups(_t(i["c"]), h), chunk=16)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32
        _close(gt, wt, 1e-5, 1e-5)


def test_ssd_chunk_bf16_keeps_y_in_fp32():
    i = _inputs(1, l=32)
    h = 4
    x, bm, cm = (_t(a, torch.bfloat16) for a in
                 (i["x"], _heads(i["b"], h), _heads(i["c"], h)))
    jy, js, jc = jssd.ssd_chunk(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.dim() == 4
          else jnp.asarray(t.numpy()) for t in
          (x, _t(i["dt"]), _t(i["a"]), bm, cm)), chunk=16, interpret=True)
    assert jy.dtype == jnp.bfloat16
    y, s, c = K.ssd_chunk(x, _t(i["dt"]), _t(i["a"]), bm, cm, chunk=16)
    assert y.dtype == torch.float32
    _close(y, np.asarray(jy, np.float32), 2.0 ** -8, 1e-5)
    _close(s, js, 1e-5, 1e-5)
    _close(c, jc, 1e-5, 1e-5)


def test_ssd_chunk_limit_admits_another_order_and_rejects_off_by_one():
    """The per-element limits the card holds the kernel to: the Pallas
    kernel (another fp32 order) lies within them, and a y_intra that drops
    each row's own (diagonal) term does not."""
    i = _inputs(2, l=64, h=4, p=8, n=16)
    h = 4
    args = [_t(i[k]) for k in ("x", "dt", "a")] + \
        [TS.heads_of_groups(_t(i[k]), h) for k in ("b", "c")]
    want = R.ssd_chunk(*args, chunk=16)
    other = jssd.ssd_chunk(*(jnp.asarray(v) for v in (
        i["x"], i["dt"], i["a"], _heads(i["b"], h), _heads(i["c"], h))),
        chunk=16, interpret=True)
    limits = R.ssd_chunk_limit(*args, _t(np.asarray(other[2])), chunk=16)
    for w, o, lim in zip(want, other, limits):
        assert bool(((w - _t(np.asarray(o))).abs() <= lim).all())
    x, dt, _, b, c = args
    diag = torch.einsum("blhn,blhn->blh", c, b)[..., None] * x * dt[..., None]
    bad = want[0] - diag
    assert bool(((bad - want[0]).abs() > limits[0]).any())


def test_ssd_chunk_limit_rejects_bf16_y_and_bf16_g_in_every_row():
    """y_intra rounded to bf16, and y_intra over a decay-masked G rounded
    to bf16 (a tensor-core product's operand), each lie beyond the y limit
    somewhere in every row position of a chunk, its last rows included."""
    i = _inputs(5, l=64, h=4, p=8, n=16)
    args = [_t(i[k]) for k in ("x", "dt", "a")] + \
        [TS.heads_of_groups(_t(i[k]), 4) for k in ("b", "c")]
    want = R.ssd_chunk(*args, chunk=16)
    limit = R.ssd_chunk_limit(*args, want[2], chunk=16)[0]
    x, dt, a, b, c = (t.reshape(2, 4, 16, *t.shape[2:]) if t.dim() > 1
                      else t for t in args)
    cum = torch.cumsum(dt * a, dim=2)
    seg = cum[:, :, :, None] - cum[:, :, None]
    decay = torch.exp(seg) * torch.ones(16, 16).tril()[..., None]
    g = torch.einsum("bnkhs,bnlhs->bnklh", c, b) * decay
    over_g = torch.einsum("bnklh,bnlhp->bnkhp",
                          g.bfloat16().float(), x * dt[..., None])
    for bad in (want[0].bfloat16().float(), over_g.reshape(want[0].shape)):
        out = ((bad - want[0]).abs() > limit).reshape(2, 4, 16, 4, 8)
        assert bool(out.any(dim=(0, 1, 3, 4)).all())


def test_ssd_pieces_match_jax():
    i = _inputs(3, l=32, h=4, p=8, n=8, g=2)
    j = {k: jnp.asarray(v) for k, v in i.items()}
    t = {k: _t(v) for k, v in i.items()}
    order = ("x", "dt", "a", "b", "c", "d")
    h0 = np.random.default_rng(4).standard_normal((2, 4, 8, 8)) \
        .astype(np.float32)
    jy, jh = JS.ssd_chunked(*(j[k] for k in order), chunk=8,
                            h0=jnp.asarray(h0))
    ty, th = TS.ssd_chunked(*(t[k] for k in order), chunk=8, h0=_t(h0))
    _close(ty, jy, *TOL.values())
    _close(th, jh, *TOL.values())
    jy, jh = JS.ssd_recurrent(*(j[k] for k in order), h0=jnp.asarray(h0))
    ty, th = TS.ssd_recurrent(*(t[k] for k in order), h0=_t(h0))
    _close(ty, jy, *TOL.values())
    _close(th, jh, *TOL.values())
    jh, jy = JS.ssd_decode_step(jnp.asarray(h0), j["x"][:, 0], j["dt"][:, 0],
                                j["a"], j["b"][:, 0], j["c"][:, 0], j["d"])
    th, ty = TS.ssd_decode_step(_t(h0), t["x"][:, 0], t["dt"][:, 0], t["a"],
                                t["b"][:, 0], t["c"][:, 0], t["d"])
    _close(ty, jy, *TOL.values())
    _close(th, jh, *TOL.values())


@pytest.fixture(scope="module")
def mamba():
    cfg = reduced(get_config("mamba2-2.7b"))
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def test_mamba_block_prefill_then_decode_matches_jax(mamba):
    cfg, jp, tp = mamba
    jblk = jax.tree.map(lambda a: a[0][0], jp["blocks"])
    tblk = jtu.tree_map(lambda a: a[0][0], tp["blocks"])
    x = np.random.default_rng(5).standard_normal((2, 36, cfg.d_model)) \
        .astype(np.float32)
    jy, js, jc = JS.mamba_block(cfg, jblk, jnp.asarray(x[:, :32]))
    ty, ts, tc = TS.mamba_block(cfg, tblk, _t(x[:, :32]))
    ys = [(ty, jy)]
    for t in range(32, 36):
        jy, js, jc = JS.mamba_block(cfg, jblk, jnp.asarray(x[:, t:t + 1]),
                                    ssm_state=js, conv_state=jc)
        ty, ts, tc = TS.mamba_block(cfg, tblk, _t(x[:, t:t + 1]),
                                    ssm_state=ts, conv_state=tc)
        ys.append((ty, jy))
    for ty, jy in ys:
        _close(ty, jy, *TOL.values())
    _close(ts, js, *TOL.values())
    for a, b in zip(tc, jc):
        _close(a, b, *TOL.values())


@pytest.mark.parametrize("s", [48, 20])          # chunked, scanned
def test_whole_model_logits_match(mamba, s):
    cfg, jp, tp = mamba
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s)) \
        .astype(np.int32)
    jc = JM.init_cache(cfg, 2, s + 4)
    tc = TM.init_cache(cfg, 2, s + 4, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
    K.reset_launch_counts()
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, *TOL.values())
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        _close(tl, jl, *TOL.values())
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert int(tc["len"]) == int(jc["len"]) == s + 3
    _close(tc["ssm"], jc["ssm"], *TOL.values())
    assert not any(K.launch_counts().values())           # CPU: plain


def test_generator_and_llm_match_jax(mamba):
    cfg, jp, tp = mamba
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 32)).astype(np.int32)
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 5)
    got = Generator(cfg, tp).generate({"tokens": prompts}, 5)
    assert got.tokens == want.tokens
    p = [list(r) for r in prompts]
    with JLLM(cfg, jp) as jllm:
        jout = [o.tokens for o in jllm.generate(p, max_new=5)]
        assert jllm.last_executor == "generator"
        with pytest.raises(NotImplementedError):
            jllm.generate([p[0], p[1][:20]], max_new=5)
    with LLM(cfg, tp, device="cpu") as llm:
        out = llm.generate(p, max_new=5)
        assert llm.last_executor == "generator"
        assert set(llm.last_metrics) == {"prefill_s", "decode_s",
                                         "tokens_per_s"}
        assert llm.backend is None          # the batcher was never needed
        with pytest.raises(NotImplementedError):
            llm.generate([p[0], p[1][:20]], max_new=5)
    assert [o.tokens for o in out] == jout == want.tokens
    with pytest.raises(NotImplementedError):
        JLLM(cfg, jp, paged=True)
    with pytest.raises(NotImplementedError):
        LLM(cfg, tp, device="cpu", paged=True)


def test_bf16_logits_within_limit():
    cfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")),
                              dtype="bfloat16")
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 32)) \
        .astype(np.int32)
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, 2, 34))
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        TM.init_cache(cfg, 2, 34, device="cpu"))
    assert tc["conv_x"].dtype == torch.bfloat16
    _close(tl, jl, 0, BF16_LOGITS)
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    _, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
    _, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
    _close(tl, jl, 0, BF16_LOGITS)
