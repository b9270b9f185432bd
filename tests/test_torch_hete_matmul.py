"""The dense matmul kernels' slice: ``kernels/hete_matmul`` and the resident
MLP that runs on it, the port against the JAX package.

* The plain versions (``ref.matmul``, ``ref.gated_matmul``) against the
  Pallas kernels in interpret mode, called directly (blocked 128-wide K
  sums in fp32): fp32 within 2e-4 for ``matmul`` (as the JAX package's own
  kernel test) and 2e-3 for ``gated_matmul`` (silu amplifies the blocked-K
  differences at large |gate|, ``tests/test_kernels.py``), and element by
  element within ``ref.matmul_limit`` / ``ref.gated_matmul_limit``; bf16
  within one bf16 step (2^-7 of |y|) plus that limit.
* The limits reject a sum missing its last K block, a result without its
  bias, the activation applied to the up product instead of the gate, and
  fp32 products of operands rounded to TF32.
* The whole resident path on the CPU: reduced OPT-6.7B (fp32, fc1 with
  bias and ReLU) and reduced Mistral-NeMo-12B (gated SiLU) give the JAX
  package's logits within 1e-4 (fp32, different summation orders) and
  identical greedy tokens through ``Generator``, ``LLM.generate`` and
  ``LLM(paged=True)`` over ``ResidentBackend``; the stacked model and
  ``ResidentBackend`` reach ``ops.matmul`` / ``ops.gated_matmul`` once per
  layer and forward, ``HeteGenBackend`` never.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import hete_matmul as JH
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.serving.engine import Generator as JGen
from repro_torch.core.hw import PAPER_A10 as T_A10
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import HeteGenBackend, ResidentBackend
from repro_torch.serving.engine import Generator

ACTS = [None, "relu", "relu2", "gelu", "silu"]
SHAPES = [(128, 256, 256), (256, 384, 128)]       # (M, K, N): n_k = 2, 3
BF16_STEP = 2.0 ** -7


def _arrays(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _tf32(t):
    """t with the low 13 bits of each fp32 mantissa cleared: TF32's 10."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _within(got, want, limit):
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_matches_pallas(m, k, n, act, bias):
    x, w, _, b = _arrays(0, m, k, n)
    b = b if bias else None
    want = np.asarray(JH.matmul(jnp.asarray(x), jnp.asarray(w),
                                None if b is None else jnp.asarray(b),
                                activation=act, interpret=True))
    tb = None if b is None else _t(b)
    got = R.matmul(_t(x), _t(w), tb, activation=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    _within(torch.from_numpy(np.array(want)), got,
            R.matmul_limit(_t(x), _t(w), got, tb, activation=act))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gated_matmul_matches_pallas(m, k, n, act):
    x, wg, wu, _ = _arrays(1, m, k, n)
    want = np.asarray(JH.gated_matmul(jnp.asarray(x), jnp.asarray(wg),
                                      jnp.asarray(wu), activation=act,
                                      interpret=True))
    got = R.gated_matmul(_t(x), _t(wg), _t(wu), activation=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    _within(torch.from_numpy(np.array(want)), got,
            R.gated_matmul_limit(_t(x), _t(wg), _t(wu), got, activation=act))


@pytest.mark.parametrize("gated", [False, True])
def test_bf16_matches_pallas_within_a_step(gated):
    """bf16 operands: both sum their exact fp32 products in fp32 and round
    once, so they differ by at most one bf16 step of the result plus the
    two summation orders' distance (the limit covers both)."""
    m, k, n = SHAPES[1]
    x, w, wu, b = _arrays(2, m, k, n)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, wu, b)]
    tb = [_t(a, torch.bfloat16) for a in (x, w, wu, b)]
    if gated:
        want = JH.gated_matmul(jb[0], jb[1], jb[2], interpret=True)
        got = R.gated_matmul(tb[0], tb[1], tb[2])
        limit = R.gated_matmul_limit(tb[0], tb[1], tb[2], got)
    else:
        want = JH.matmul(jb[0], jb[1], jb[3], activation="gelu",
                         interpret=True)
        got = R.matmul(tb[0], tb[1], tb[3], activation="gelu")
        limit = R.matmul_limit(tb[0], tb[1], got, tb[3], activation="gelu")
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    err = (got.float() - want).abs()
    assert bool((err <= BF16_STEP * want.abs() + 1e-6).all())
    _within(got, want, limit)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_limits_reject_the_controls(m, k, n):
    """Each limit must fail a plain version with a known fault, so a
    kernel with that fault could not pass it: the sum missing its last
    128-wide K block, the result without its bias, the activation on the
    up product instead of the gate, and (the fp32 kernels must not use
    TF32) the products of operands rounded to TF32."""
    x, w, wu, b = (_t(a) for a in _arrays(3, m, k, n))
    want = R.matmul(x, w, b, activation="relu")
    limit = R.matmul_limit(x, w, want, b, activation="relu")
    short = R.matmul(x[:, :-128], w[:-128], b, activation="relu")
    no_bias = R.matmul(x, w, activation="relu")
    g_want = R.gated_matmul(x, w, wu)
    g_limit = R.gated_matmul_limit(x, w, wu, g_want)
    g_short = R.gated_matmul(x[:, :-128], w[:-128], wu[:-128])
    swapped = R.gated_matmul(x, wu, w)
    tf32 = R.matmul(_tf32(x), _tf32(w), b, activation="relu")
    g_tf32 = R.gated_matmul(_tf32(x), _tf32(w), _tf32(wu))
    for bad, good, lim in ((short, want, limit), (no_bias, want, limit),
                           (tf32, want, limit),
                           (g_short, g_want, g_limit),
                           (swapped, g_want, g_limit),
                           (g_tf32, g_want, g_limit)):
        beyond = ((bad - good).abs() > lim).float().mean()
        assert float(beyond) > 0.25
    _within(R.matmul(x, w, b, activation="relu"), want, limit)


def test_ops_route_cpu_tensors_to_the_plain_versions():
    x, w, wu, b = (_t(a) for a in _arrays(4, 8, 32, 24))
    K.reset_launch_counts()
    assert torch.equal(K.matmul(x, w, b, activation="relu2"),
                       R.matmul(x, w, b, activation="relu2"))
    assert torch.equal(K.gated_matmul(x, w, wu, activation="gelu"),
                       R.gated_matmul(x, w, wu, activation="gelu"))
    counts = K.launch_counts()
    assert counts["matmul"] == counts["gated_matmul"] == 0
    with pytest.raises(ValueError):
        K.matmul(x, w, activation="tanh")


def test_cuda_wrappers_reject_cpu_tensors():
    """The wrappers never fall back: handed CPU tensors they raise."""
    from repro_torch.kernels import hete_matmul
    x, w = torch.zeros((2, 4)), torch.zeros((4, 3))
    with pytest.raises(ValueError):
        hete_matmul.matmul(x, w)
    with pytest.raises(ValueError):
        hete_matmul.gated_matmul(x, w, w)


# ---------------------------------------------------------------------------
# the resident path on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["opt-6.7b", "mistral-nemo-12b"])
def setup(request):
    cfg = reduced(get_config(request.param))
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    if cfg.attn_bias:
        # the init's zero biases would hide a bias the route drops
        rng = np.random.default_rng(5)
        jp = jtu.tree_map_with_path(
            lambda p, a: jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                     a.dtype)
            if jtu.keystr(p).endswith("['b_in']") else a, jp)
        tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 7)).astype(np.int32)
    return cfg, jp, tp, prompts


@pytest.fixture
def mlp_calls(monkeypatch):
    """Tally the calls of ``ops.matmul`` / ``ops.gated_matmul`` (on the CPU
    they launch nothing, so the launch counters stay 0)."""
    calls = {"matmul": 0, "gated_matmul": 0}
    for name in calls:
        inner = getattr(K, name)

        def counted(*a, _name=name, _inner=inner, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    return calls


def _fused(cfg):
    return "gated_matmul" if cfg.mlp_kind.startswith("gated") else "matmul"


def test_whole_model_matches_jax_through_the_kernels(setup, mlp_calls):
    cfg, jp, tp, _ = setup
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, 2, 16), all_logits=True)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        TM.init_cache(cfg, 2, 16, device="cpu"),
                        all_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    for _ in range(3):
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert mlp_calls == {"matmul": 0, "gated_matmul": 0,
                         _fused(cfg): 4 * cfg.n_layers}


def test_generators_match_jax_through_the_kernels(setup, mlp_calls):
    """Greedy tokens identical to JAX's through ``Generator`` and
    ``LLM.generate`` (one-shot, the stacked model), and through
    ``LLM(paged=True)`` over ``ResidentBackend`` on a ragged batch (the
    paged batcher); every forward reaches the fused MLP once a layer."""
    cfg, jp, tp, prompts = setup
    p = [list(r) for r in prompts]
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 5).tokens
    assert Generator(cfg, tp).generate({"tokens": prompts}, 5).tokens == want
    assert mlp_calls[_fused(cfg)] == 5 * cfg.n_layers
    with LLM(cfg, tp, device="cpu", max_slots=3, max_len=32) as llm:
        assert [o.tokens for o in llm.generate(p, max_new=5)] == want
        assert llm.last_executor == "generator"
    ragged = [p[0], p[1][:5], p[2][:6]]
    with JLLM(cfg, jp, paged=True, max_slots=3, max_len=32) as jllm:
        want = [o.tokens for o in jllm.generate(ragged, max_new=5)]
    with LLM(cfg, tp, device="cpu", paged=True, max_slots=3,
             max_len=32) as llm:
        assert isinstance(llm.backend, ResidentBackend)
        before = mlp_calls[_fused(cfg)]
        assert [o.tokens for o in llm.generate(ragged, max_new=5)] == want
        assert llm.last_executor == "batcher"
        assert mlp_calls[_fused(cfg)] > before
    assert mlp_calls["matmul" if _fused(cfg) == "gated_matmul"
                     else "gated_matmul"] == 0


def test_hetegen_route_stays_off_the_kernels(setup, mlp_calls):
    """HeteGenBackend splits every weight between host and device, so its
    MLP is its linears and the activation, never the fused kernels; its
    prefill logits equal ResidentBackend's within 1e-4."""
    cfg, _, tp, prompts = setup
    toks = torch.from_numpy(prompts)
    b, s = toks.shape
    res = ResidentBackend(cfg, tp, device="cpu")
    _, want = res.prefill({"tokens": toks}, res.init_cache(b, s))
    resident_calls = dict(mlp_calls)
    assert resident_calls[_fused(cfg)] == cfg.n_layers
    hb = HeteGenBackend(cfg, tp, hw=T_A10, budget_bytes=0,
                        alpha_override=1.0, device="cpu")
    try:
        _, got = hb.prefill({"tokens": toks}, hb.init_cache(b, s))
    finally:
        hb.close()
    assert mlp_calls == resident_calls
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
