"""The port's train step against the JAX package's: three
``make_train_step`` steps from one state (the JAX package's, moved
  across with ``train_state_from_numpy``) and the same batches, with
  ``accum_steps`` 1 and 2: under SGD params within 1e-5 of the JAX
  package's after every step; under AdamW (and Scout's Adafactor) the
  per-step losses (Adam's first step moves an element with a near-zero
  gradient by lr times its sign, so a sign that differs in the last bit
  moves params by 2 lr: params are no fair comparison there); the
  accumulating step reports aux 0, as the JAX package's does; a bf16
  accumulation buffer sums as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.train import loop as JT
from repro.train import optimizer as JO
from repro_torch.models import model as TM
from repro_torch.train import loop as TT
from repro_torch.train import optimizer as TO


def _cfg(name):
    cfg = get_config(name)
    return cfg if name == "tiny" else reduced(cfg)


def _batches(vocab, n, b=4, s=32, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _run_both(cfg, opt_name, accum, lr, steps=3):
    """Per-step (jax metrics, port metrics) and the final states."""
    kw = dict(name=opt_name, lr=lr)
    jt = JT.TrainConfig(accum_steps=accum, optimizer=JO.OptimizerConfig(**kw),
                        warmup=2, total_steps=10)
    tt = TT.TrainConfig(accum_steps=accum, optimizer=TO.OptimizerConfig(**kw),
                        warmup=2, total_steps=10)
    jstep, jinit = JT.make_train_step(cfg, jt)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": jinit(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = TM.train_state_from_numpy(jtu.tree_map(np.asarray, jstate),
                                       device="cpu")
    tstep, _ = TT.make_train_step(cfg, tt)
    jstep = jax.jit(jstep)
    metrics = []
    for batch in _batches(cfg.vocab_size, steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    return metrics, jstate, tstate


@pytest.mark.parametrize("name", ["tiny", "gemma2-2b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_sgd_steps_match_params(name, accum):
    cfg = _cfg(name)
    metrics, jstate, tstate = _run_both(cfg, "sgd", accum, lr=0.5)
    for jm, tm in metrics:
        for k in ("loss", "nll", "lr"):
            assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert int(tstate["opt"]["count"]) == 3
    flat_j = jtu.tree_flatten_with_path(jstate["params"])[0]
    flat_t = TO.tree_leaves(tstate["params"])
    assert len(flat_j) == len(flat_t)
    for (path, want), got in zip(flat_j, flat_t):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=jtu.keystr(path))


@pytest.mark.parametrize("name,opt", [("tiny", "adamw"),
                                      ("gemma2-2b", "adamw"),
                                      ("llama4-scout-17b-16e", "adafactor")])
@pytest.mark.parametrize("accum", [1, 2])
def test_adaptive_steps_match_losses(name, opt, accum):
    cfg = _cfg(name)
    metrics, _, tstate = _run_both(cfg, opt, accum, lr=1e-2)
    for jm, tm in metrics:
        assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
        assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-6)
        if accum > 1:
            assert tm["aux"] == jm["aux"] == 0.0      # the JAX quirk
        elif cfg.n_experts:
            assert tm["aux"] == pytest.approx(jm["aux"], rel=1e-5)
    if opt == "adafactor":
        assert "s" in tstate["opt"] and "m" not in tstate["opt"]


def test_bf16_accumulation_dtype():
    """``accum_dtype`` bf16 sums the microbatch grads in bf16, as the JAX
    package does: the same SGD params after a step."""
    cfg = _cfg("tiny")
    kw = dict(name="sgd", lr=0.5)
    jt = JT.TrainConfig(accum_steps=2, accum_dtype="bfloat16",
                        optimizer=JO.OptimizerConfig(**kw), warmup=1)
    tt = TT.TrainConfig(accum_steps=2, accum_dtype="bfloat16",
                        optimizer=TO.OptimizerConfig(**kw), warmup=1)
    jstep, jinit = JT.make_train_step(cfg, jt)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    js = {"params": jp, "opt": jinit(jp), "step": jnp.zeros((), jnp.int32)}
    ts = TM.train_state_from_numpy(jtu.tree_map(np.asarray, js),
                                   device="cpu")
    batch = _batches(cfg.vocab_size, 1)[0]
    js, _ = jax.jit(jstep)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, _ = TT.make_train_step(cfg, tt)[0](ts, batch)
    for want, got in zip(jtu.tree_leaves(js["params"]),
                         TO.tree_leaves(ts["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
