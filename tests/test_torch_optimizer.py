"""The port's optimizers against the JAX package's, from the same params,
grads and state (seeded numpy), three updates in a row:

* AdamW, Adafactor (factored leaves of two and three dims, unfactored
  matrices and vectors) and SGD, with and without grad clipping and
  weight decay: params and every state leaf within 1e-6 relative in fp32;
* in bf16 (params, grads and moments) the cast params are bit-identical
  to the reference's, every element of every update (the fp32 updates may
  differ in their last bits — ``rsqrt``/``pow``, the reduction order of
  the means — but no such difference has crossed a bf16 rounding boundary
  on these inputs);
* ``clip_by_global_norm`` and ``lr_schedule`` over 0..total.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.models.model import params_from_numpy
from repro_torch.train import optimizer as TO

SHAPES = {"w": (200, 160), "stack": {"we": (2, 130, 140)},
          "small": (16, 8), "norm": {"scale": (24,)}}


def _tree(rng, scale=1.0):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return (scale * rng.standard_normal(t)).astype(np.float32)
    return walk(SHAPES)


def _cast(tree, dtype):
    return jtu.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)), tree)


def _torch(tree):
    return params_from_numpy(tree, device="cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _pairs(jtree, ttree):
    """(path, jax leaf, port leaf) in sorted-key order."""
    out = []

    def walk(j, t, path):
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), path
            for k in sorted(j):
                walk(j[k], t[k], path + (k,))
        else:
            out.append((path, j, t))
    walk(jtree, ttree, ())
    return out


def _check_fp32(jtree, ttree):
    for path, j, t in _pairs(jtree, ttree):
        want, got = _np(j), _np(t)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max() + 1e-30,
                                   err_msg=str(path))


def _check_bf16(jtree, ttree):
    """The same bf16 bits, leaf by leaf."""
    for path, j, t in _pairs(jtree, ttree):
        assert t.dtype == torch.bfloat16, path
        want = np.asarray(j).view(np.int16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), want,
                                      err_msg=str(path))


CONFIGS = [
    dict(name="adamw"),
    dict(name="adamw", grad_clip=0.0, weight_decay=0.0),
    dict(name="adafactor", min_dim_factored=128),
    dict(name="adafactor", grad_clip=0.0),
    dict(name="sgd"),
    dict(name="sgd", grad_clip=0.0),
]


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_match_jax(kw, dtype):
    rng = np.random.default_rng(0)
    jcfg = JO.OptimizerConfig(lr=1e-2, moment_dtype=dtype, **kw)
    tcfg = TO.OptimizerConfig(lr=1e-2, moment_dtype=dtype, **kw)
    jinit, jupd = JO.make_optimizer(jcfg)
    tinit, tupd = TO.make_optimizer(tcfg)
    jdt = jnp.dtype(dtype)
    p0 = _cast(_tree(rng), jdt)
    jp = jtu.tree_map(jnp.asarray, p0)
    tp = _torch(p0)
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _cast(_tree(rng, scale=0.5 ** step), jdt)
        lr = np.float32(1e-2 * (step + 1) / 3)
        jp, js = jupd(jtu.tree_map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts = tupd(_torch(g), ts, tp, torch.tensor(lr))
        assert int(ts["count"]) == int(js["count"]) == step + 1
        if dtype == "float32":
            _check_fp32(jp, tp)
            if kw["name"] == "adamw":
                _check_fp32(js["m"], ts["m"])
                _check_fp32(js["v"], ts["v"])
            elif kw["name"] == "adafactor":
                _check_fp32(js["s"], ts["s"])
        else:
            _check_bf16(jp, tp)


def test_adafactor_factors_like_jax():
    """The same leaves are factored (vr over rows, vc over columns)."""
    p = _torch(_tree(np.random.default_rng(1)))
    st = TO.make_adafactor(TO.OptimizerConfig(name="adafactor"))[0](p)["s"]
    assert set(st["w"]) == {"vr", "vc"}
    assert st["w"]["vr"].shape == (200,) and st["w"]["vc"].shape == (160,)
    assert st["stack"]["we"]["vr"].shape == (2, 130)
    assert st["stack"]["we"]["vc"].shape == (2, 140)
    assert set(st["small"]) == {"v"} and set(st["norm"]["scale"]) == {"v"}


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm(max_norm):
    g = _tree(np.random.default_rng(2))
    jg, jn = JO.clip_by_global_norm(jtu.tree_map(jnp.asarray, g), max_norm)
    tg, tn = TO.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(TO.global_norm(_torch(g))),
                               float(JO.global_norm(g)), rtol=1e-6)
    _check_fp32(jg, tg)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_lr_schedule(kind):
    total, warmup = 60, 10
    for s in range(total + 3):
        want = float(JO.lr_schedule(jnp.int32(s), base=3e-4, warmup=warmup,
                                    total=total, kind=kind))
        got = TO.lr_schedule(torch.tensor(s, dtype=torch.int32), base=3e-4,
                             warmup=warmup, total=total, kind=kind)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, s
        assert float(TO.lr_schedule(s, base=3e-4, warmup=warmup,
                                    total=total, kind=kind)) == float(got)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        TO.make_optimizer(TO.OptimizerConfig(name="lion"))
