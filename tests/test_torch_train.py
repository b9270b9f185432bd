"""The port's training forward and gradients against the JAX package's, on
the same weights (JAX ``init_params`` through ``params_from_numpy``, the
zero-initialised norm scales and LoRA ``b`` drawn at random on both sides)
and the same seeded numpy batch, for every family the port trains at
``reduced()`` size (``tiny`` as it is), in fp32:

* ``forward_train`` logits within 1e-4 of the largest |logit| (the
  tolerance of the prefill logits in ``test_torch_families.py``);
* ``loss_fn``'s loss, nll and aux within 1e-5 relative, with Scout's
  load-balancing term and a z-loss case;
* gradients of ``loss_fn`` equal to ``jax.grad``'s leaf by leaf within
  1e-4 of each leaf's largest |g|, a leaf that is exactly zero in the
  reference (an expert no token reached) exactly zero here;
* ``remat=True`` gradients equal to ``remat=False``'s within 1e-6;
* the training path reaches no ``kernels/ops`` wrapper, and a wrapper on
  the CUDA route refuses an input that requires grad under grad mode.
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
from repro.train import loop as JT
from repro_torch.kernels import ops as K
from repro_torch.models import model as TM
from repro_torch.train import loop as TT

FAMILIES = ["tiny", "opt-125m", "gemma2-2b", "mistral-nemo-12b",
            "minicpm3-4b", "llama4-scout-17b-16e", "mamba2-2.7b",
            "zamba2-1.2b"]
SEQ = 48          # past the reduced window (32); three SSD chunks of 16
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def family_cfg(name, **kw):
    cfg = get_config(name)
    if name != "tiny":
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **kw)


def _perturb(tree, rng):
    """Draw the leaves that start at zero and would hide a mechanism."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        a = np.asarray(t)
        norm = path[-1] == "scale" and not a.any()          # (1+w) norms
        lora_b = path[-2:] == ("shared_lora", "b")
        if norm or lora_b:
            r = rng.standard_normal(a.shape).astype(np.float32)
            return (0.2 * r if norm else 0.05 * r).astype(a.dtype)
        return a
    return walk(tree, ())


def family_params(cfg, seed=0):
    """(JAX params, the same as the port's CPU tensors)."""
    tree = _perturb(jtu.tree_map(np.asarray,
                                 JM.init_params(cfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed))
    return (jtu.tree_map(jnp.asarray, tree),
            TM.params_from_numpy(tree, device="cpu"))


def lm_batch(vocab, b=2, s=SEQ, seed=1):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg = family_cfg(request.param)
    jp, tp = family_params(cfg)
    return cfg, jp, tp, lm_batch(cfg.vocab_size)


def _jax_grads(cfg, jp, batch, z=0.0):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, p, b, aux_weight=0.01, z_weight=z),
        has_aux=True))
    (loss, metrics), grads = fn(jp, _jbatch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _close_rel(got, want, tol):
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


def test_forward_train_logits(family):
    cfg, jp, tp, batch = family
    want = np.asarray(jax.jit(
        lambda p, b: JM.forward_train(cfg, p, b))(jp, _jbatch(batch)))
    got = TM.forward_train(cfg, tp, _tbatch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_loss_and_grads_match_jax(family):
    cfg, jp, tp, batch = family
    loss_j, met_j, grads_j = _jax_grads(cfg, jp, batch)
    loss, met, grads = TT.loss_and_grads(cfg, tp, _tbatch(batch))
    _close_rel(float(loss), loss_j, LOSS_TOL)
    _close_rel(float(met["nll"]), met_j["nll"], LOSS_TOL)
    if cfg.n_experts:
        assert met_j["aux"] > 0
        _close_rel(float(met["aux"]), met_j["aux"], LOSS_TOL)
    else:
        assert float(met["aux"]) == met_j["aux"] == 0.0
    want_paths = _paths(jtu.tree_map(np.asarray, grads_j))
    got_paths = _paths(grads)
    assert [p for p, _ in got_paths] == [p for p, _ in want_paths]
    top = max(np.abs(w).max() for _, w in want_paths)
    for (path, want), (_, g) in zip(want_paths, got_paths):
        assert g is not None, path
        g = g.numpy()
        assert g.shape == want.shape and np.isfinite(g).all(), path
        if path[-1] == "bk":
            # the key bias adds q . bk to every score of a row, which the
            # softmax cancels: its exact gradient is 0 and both sides hold
            # rounding noise, far below every other leaf's
            assert np.abs(g).max() <= 1e-5 * top, path
            assert np.abs(want).max() <= 1e-5 * top, path
            continue
        # a leaf that is all zero in the reference must be exactly zero
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=str(path))


def test_unrouted_experts_have_zero_grads():
    """Top-1 routing over a few tokens leaves some experts without any:
    their slices of the expert stacks get exactly zero gradient, in the
    reference and here."""
    cfg = family_cfg("llama4-scout-17b-16e")
    jp, tp = family_params(cfg, seed=3)
    batch = lm_batch(cfg.vocab_size, b=1, s=3, seed=4)
    _, _, grads_j = _jax_grads(cfg, jp, batch)
    _, _, grads = TT.loss_and_grads(cfg, tp, _tbatch(batch))
    found = 0
    for name in ("we_gate", "we_up", "we_down"):
        want = np.asarray(grads_j["blocks"]["pos0"]["moe"][name])
        got = grads["blocks"]["pos0"]["moe"][name].numpy()
        for idx in np.ndindex(*want.shape[:2]):       # (layer, expert)
            if not want[idx].any():
                found += 1
                assert not got[idx].any(), (name, idx)
            else:
                np.testing.assert_allclose(
                    got[idx], want[idx], rtol=0,
                    atol=GRAD_TOL * np.abs(want).max())
    assert found > 0


def test_z_loss_and_aux_weight():
    cfg = family_cfg("llama4-scout-17b-16e")
    jp, tp = family_params(cfg)
    batch = lm_batch(cfg.vocab_size)
    loss_j, met_j, _ = _jax_grads(cfg, jp, batch, z=1e-3)
    loss, met = TT.loss_fn(cfg, tp, _tbatch(batch), aux_weight=0.01,
                           z_weight=1e-3)
    _close_rel(float(loss), loss_j, LOSS_TOL)
    _close_rel(float(met["aux"]), met_j["aux"], LOSS_TOL)
    assert float(loss) > float(met["nll"]) + 0.01 * float(met["aux"])


@pytest.mark.parametrize("name", ["gemma2-2b", "zamba2-1.2b"])
def test_remat_gradients_equal(name):
    cfg = family_cfg(name)
    _, tp = family_params(cfg)
    batch = _tbatch(lm_batch(cfg.vocab_size))
    _, _, g0 = TT.loss_and_grads(cfg, tp, batch)
    _, _, g1 = TT.loss_and_grads(dataclasses.replace(cfg, remat=True), tp,
                                 batch)
    for (path, a), (_, b) in zip(_paths(g0), _paths(g1)):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * max(scale, 1e-30), path


@pytest.mark.parametrize("family_name", ["encdec", "vlm"])
def test_unported_families_raise(family_name):
    cfg = dataclasses.replace(get_config("tiny"), family=family_name)
    _, tp = family_params(get_config("tiny"))
    with pytest.raises(NotImplementedError):
        TM.forward_train(cfg, tp, _tbatch(lm_batch(cfg.vocab_size)))


KERNEL_WRAPPERS = ["paged_decode_attention", "paged_prefill_attention",
                   "q8_matmul", "decode_attention", "flash_attention",
                   "rmsnorm", "ssd_chunk", "matmul", "gated_matmul",
                   "count_plain"]


@pytest.mark.parametrize("name", ["gemma2-2b", "minicpm3-4b",
                                  "llama4-scout-17b-16e", "zamba2-1.2b"])
def test_training_reaches_no_kernel_wrapper(name, monkeypatch):
    """Every ``kernels/ops`` wrapper (and the plain-branch counter) raises:
    the forward and its backward still run, under remat too."""
    def refuse(*a, **kw):
        raise AssertionError("the training path reached kernels/ops")
    for w in KERNEL_WRAPPERS:
        monkeypatch.setattr(K, w, refuse)
    cfg = dataclasses.replace(family_cfg(name), remat=True)
    _, tp = family_params(cfg)
    loss, _, grads = TT.loss_and_grads(cfg, tp,
                                       _tbatch(lm_batch(cfg.vocab_size)))
    assert np.isfinite(float(loss))
    assert all(g is not None for _, g in _paths(grads))


def test_guard_fires_under_grad_mode(monkeypatch):
    """On the CUDA route a wrapper refuses an input that requires grad
    while grad mode is on, naming the kernel; under ``no_grad`` or with
    no such input it goes on to the kernel (a stub here)."""
    monkeypatch.setattr(K, "_route", lambda t: "cuda")
    launched = []
    monkeypatch.setattr(K._rms, "rmsnorm",
                        lambda *a, **kw: launched.append(1) or a[0])
    monkeypatch.setattr(K._mm, "gated_matmul",
                        lambda *a, **kw: launched.append(1) or a[0])
    x = torch.randn(4, 8)
    w = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="rmsnorm: the kernel has no "
                                           "backward"):
        K.rmsnorm(x, w)
    wg = torch.randn(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="gated_matmul"):
        K.gated_matmul(x, wg, wg.detach())
    with torch.no_grad():
        K.rmsnorm(x, w)
    K.rmsnorm(x, w.detach())
    assert len(launched) == 2
