"""The port's sharded path against the JAX package's and against itself.

* Spec trees (``param_specs`` serve and train, ``opt_state_specs``,
  ``cache_specs`` over bf16 and int8 caches, ``batch_specs``) equal to
  ``repro.distributed.specs``' entry for entry, for every assigned arch and
  ``tiny``, on the (16, 16) and (2, 16, 16) meshes, with and without
  sequence parallelism, both built from ``ShardingRules(mesh_axes=...,
  mesh_shape=...)`` (JAX shapes from ``jax.eval_shape``, the port's from
  meta tensors).
* The rules' divisibility guard and conflict resolution, on both packages.
* A world of 4 gloo ranks on a (2, 2) ("data", "model") mesh: reduced
  Mistral-NeMo in fp32 (heads-sharded cache, and with one kv head a
  sequence-sharded cache whose decode combines per-rank log-sum-exps)
  through ``make_prefill_step`` / ``make_serve_step`` under
  ``ShardingRules.for_mesh`` against the port's unsharded steps (logits
  within 1e-5 of max |logit|) and the JAX package's greedy tokens; one
  sharded ``loss_and_grads`` and an accumulating SGD ``make_train_step``
  against the unsharded ones (1e-5 relative); the sequence-sharded decode
  combine against the whole-cache kernel's plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.distributed import specs as TS
from repro_torch.distributed.shardings import ShardingRules as TR

MESHES = {"single": (("data", "model"), {"data": 16, "model": 16}),
          "multi": (("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})}
ARCHS = list(ASSIGNED_ARCHS) + ["tiny"]
LOGIT_TOL = 1e-5          # of max |logit|, fp32 sharded vs unsharded
GRAD_TOL = 1e-5           # of the tree's max |g|


# ---------------------------------------------------------------------------
# Spec trees against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(arch: str, kv_dtype: str):
    import jax
    from repro.configs import get_config
    from repro.configs.shapes import input_specs
    from repro.models import model as M
    from repro.train.optimizer import OptimizerConfig, make_optimizer
    cfg = dataclasses.replace(get_config(arch), kv_dtype=kv_dtype)
    p = jax.eval_shape(lambda k: M.init_params(cfg, k),
                       jax.random.PRNGKey(0))
    init, _ = make_optimizer(OptimizerConfig(name=cfg.optimizer))
    opt = jax.eval_shape(init, p)
    ins = input_specs(cfg, "decode_32k")
    return cfg, p, opt, ins["cache"], {"token": ins["token"]}


@functools.lru_cache(maxsize=None)
def _torch_shapes(arch: str, kv_dtype: str):
    from repro_torch.configs.shapes import input_specs
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    cfg = dataclasses.replace(tget(arch), kv_dtype=kv_dtype)
    p = TS.param_shapes(cfg)
    init, _ = make_optimizer(OptimizerConfig(name=cfg.optimizer))
    opt = init(p)
    ins = input_specs(cfg, "decode_32k")
    return cfg, p, opt, ins["cache"], {"token": ins["token"]}


def _jflat(tree):
    import jax
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(k): tuple(v) for k, v in flat}


def _tflat(tree):
    return {k: tuple(v) for k, v in TS.flatten_with_path(tree)}


def _kv_dtypes(arch: str):
    cfg = tget(arch)
    gqa_cache = cfg.family in ("dense", "moe", "vlm", "encdec") \
        and cfg.attn_kind == "gqa"
    return ("bfloat16", "int8") if gqa_cache else ("bfloat16",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference(arch, mesh):
    from repro.distributed import specs as JS
    from repro.distributed.shardings import ShardingRules as JR
    axes, shape = MESHES[mesh]
    for kv in _kv_dtypes(arch):
        jcfg, jp, jopt, jcache, jtok = _jax_shapes(arch, kv)
        tcfg, tp, topt, tcache, ttok = _torch_shapes(arch, kv)
        for sp in (False, True):
            table = dict(TR().table, **({"seq": ("model",)} if sp else {}))
            jr = JR(table=dict(table), mesh_axes=axes, mesh_shape=shape)
            tr = TR(table=dict(table), mesh_axes=axes, mesh_shape=shape)
            for serve in (False, True):
                jps = JS.param_specs(jcfg, jr, jp, serve=serve)
                tps = TS.param_specs(tcfg, tr, tp, serve=serve)
                assert _tflat(tps) == _jflat(jps), (kv, sp, serve)
            assert _tflat(TS.opt_state_specs(tcfg, tr, topt, tps)) \
                == _jflat(JS.opt_state_specs(jcfg, jr, jopt, jps))
            assert _tflat(TS.cache_specs(tcfg, tr, tcache)) \
                == _jflat(JS.cache_specs(jcfg, jr, jcache))
            assert _tflat(TS.batch_specs(tcfg, tr, ttok)) \
                == _jflat(JS.batch_specs(jcfg, jr, jtok))


def _rules_pkgs():
    from repro.distributed.shardings import ShardingRules as JR
    return {"repro": JR, "repro_torch": TR}


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_rules_divisibility_guard(pkg):
    SR = _rules_pkgs()[pkg]
    rules = SR(table=SR().table, mesh_axes=("data", "model"),
               mesh_shape={"data": 16, "model": 16})
    # 8 kv heads cannot shard 16 ways -> replicated
    spec = rules.spec_for_shape((2, 128, 8, 64),
                                "batch", None, "kv_heads", None)
    assert spec[2] is None
    # batch 2 can't take data 16 either
    assert spec[0] is None
    assert tuple(spec) == tuple(
        TR(mesh_axes=("data", "model"), mesh_shape={"data": 16, "model": 16})
        .spec_for_shape((2, 128, 8, 64), "batch", None, "kv_heads", None))


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_rules_conflict_resolution(pkg):
    SR = _rules_pkgs()[pkg]
    rules = SR(table={**SR().table, "seq": ("model",)},
               mesh_axes=("data", "model"),
               mesh_shape={"data": 16, "model": 16})
    spec = rules.spec_for_shape((32, 4096, 64, 128),
                                "batch", "seq", "heads", None)
    assert spec[2] == "model" and spec[1] is None  # heads win over seq


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    r = TR(mesh_axes=("pod", "data", "model"),
           mesh_shape={"pod": 2, "data": 16, "model": 16})
    assert r.placements(TS.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert r.placements(TS.P(None, None)) == (Replicate(),) * 3
    # disabled rules and plain tensors pass through act unchanged
    x = torch.ones(4, 4)
    assert r.act(x, "batch", "embed") is x
    assert TR.disabled().act(x, "batch", "embed") is x


# ---------------------------------------------------------------------------
# A world of 4 gloo ranks
# ---------------------------------------------------------------------------

B, S, T, DECODE = 4, 8, 32, 2


def _cfg(hkv: int):
    return dataclasses.replace(treduced(tget("mistral-nemo-12b")),
                               dtype="float32", n_kv_heads=hkv)


def _worker(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    try:
        out = _checks(rank, root)
        if rank == 0:
            with open(os.path.join(root, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _checks(rank: int, root: str) -> dict:
    from repro_torch.distributed import local as DL
    from repro_torch.distributed.shardings import ShardingRules
    from repro_torch.kernels import ref as R
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.train.loop import (TrainConfig, loss_and_grads,
                                        make_train_step)
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = ShardingRules.for_mesh(mesh)
    data = np.load(os.path.join(root, "inputs.npz"))
    toks = torch.from_numpy(data["tokens"])
    out: dict = {}
    for hkv in (4, 1):
        cfg = _cfg(hkv)
        params = M.params_from_numpy(_unflat(data, f"p{hkv}/"),
                                     device="cpu")
        pre, ser = make_prefill_step(cfg), make_serve_step(cfg)
        spre, sser = make_prefill_step(cfg, rules), make_serve_step(cfg, rules)
        cache = M.init_cache(cfg, B, T, device="cpu")
        dp = TS.distribute(params, mesh,
                           TS.param_specs(cfg, rules, serve=True))
        dc = TS.distribute(M.init_cache(cfg, B, T, device="cpu"), mesh,
                           TS.cache_specs(cfg, rules, cache))
        bt = TS.distribute({"tokens": toks}, mesh,
                           TS.batch_specs(cfg, rules, {"tokens": toks}))
        c0, t0 = pre(params, {"tokens": toks}, cache)
        c1, t1 = spre(dp, bt, dc)
        want, got = [t0.tolist()], [t1.full_tensor().tolist()]
        errs = []
        for _ in range(DECODE):
            c0, l0 = M.decode_step(cfg, params, t0, c0)
            c1, l1 = M.decode_step(cfg, dp, t1, c1, rules)
            errs.append(_rel(l1.full_tensor(), l0))
            t0 = torch.argmax(l0, -1).to(torch.int32)
            t1 = torch.argmax(l1.full_tensor(), -1).to(torch.int32)
            t1 = TS.distribute({"t": t1}, mesh, TS.batch_specs(
                cfg, rules, {"t": t1}))["t"]
            want.append(t0.tolist())
            got.append(t1.full_tensor().tolist())
        _, ts = sser(dp, t1, c1)
        out[f"serve{hkv}"] = dict(
            tokens=got, unsharded=want, logit_err=max(errs),
            k_placements=[p.dim if p.is_shard() else None
                          for p in c1["k0"].placements],
            serve_step_tokens=ts.full_tensor().tolist())

    # the sequence-sharded decode combine against the whole cache
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 8, 16, generator=g)
    k = torch.randn(4, 2, 64, 16, generator=g)
    v = torch.randn(4, 2, 64, 16, generator=g)
    lens = torch.tensor([64, 40, 17, 1], dtype=torch.int32)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dq = distribute_tensor(q, mesh, [Shard(0), Replicate()])
    dk = distribute_tensor(k, mesh, [Shard(0), Shard(2)])
    dv = distribute_tensor(v, mesh, [Shard(0), Shard(2)])
    o = DL.decode_attention(dq, dk, dv, lens).full_tensor()
    out["combine_err"] = _rel(o, R.decode_attention(q, k, v, lens))

    # training: loss and grads, and an accumulating SGD step
    cfg = _cfg(4)
    params = M.params_from_numpy(_unflat(data, "p4/"), device="cpu")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    l0, _, g0 = loss_and_grads(cfg, params, batch)
    tp = TS.distribute(params, mesh, TS.param_specs(cfg, rules))
    tb = TS.distribute(batch, mesh, TS.batch_specs(cfg, rules, batch))
    l1, _, g1 = loss_and_grads(cfg, tp, tb, rules)
    gmax = max(float(x.abs().max()) for x in tree_leaves(g0))
    out["loss"] = [float(l0), float(l1.full_tensor())]
    out["grad_err"] = max(float((a - b.full_tensor()).abs().max())
                          for a, b in zip(tree_leaves(g0), tree_leaves(g1))
                          ) / gmax
    tcfg = TrainConfig(accum_steps=2, optimizer=OptimizerConfig(
        name="sgd", lr=1e-2))
    step0, init0 = make_train_step(cfg, tcfg)
    step1, _ = make_train_step(cfg, tcfg, rules)
    s0 = {"params": params, "opt": init0(params),
          "step": torch.zeros((), dtype=torch.int32)}
    s1 = {"params": tp, "opt": {"count": TS.distribute(
        torch.zeros((), dtype=torch.int32), mesh, TS.P())},
        "step": TS.distribute(torch.zeros((), dtype=torch.int32), mesh,
                              TS.P())}
    s0, m0 = step0(s0, batch)
    s1, m1 = step1(s1, tb)
    out["step_loss"] = [float(m0["loss"]), float(m1["loss"].full_tensor())]
    out["step_param_err"] = max(
        _rel(b.full_tensor(), a) for a, b in
        zip(tree_leaves(s0["params"]), tree_leaves(s1["params"])))
    return out


def _unflat(data, prefix: str) -> dict:
    """The nested param tree saved flat as ``prefix`` + keystr paths."""
    import re
    tree: dict = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        *parents, leaf = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return tree


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Reference params and tokens saved, the 4-rank checks run, and the
    JAX package's greedy tokens on the same weights."""
    import jax
    import jax.tree_util as jtu
    from repro.configs import get_config, reduced
    from repro.models import model as JM
    from repro.serving.engine import make_prefill_step, make_serve_step

    root = str(tmp_path_factory.mktemp("gloo4"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, _cfg(4).vocab_size, (B, S)).astype(np.int32)
    saved = {"tokens": toks}
    ref_tokens = {}
    for hkv in (4, 1):
        jcfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")),
                                   dtype="float32", n_kv_heads=hkv)
        jp = jtu.tree_map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(hkv)))
        for path, leaf in TS.flatten_with_path(jp):
            saved[f"p{hkv}/{path}"] = leaf
        cache = JM.init_cache(jcfg, B, T)
        cache, t = make_prefill_step(jcfg)(jp, {"tokens": toks}, cache)
        seq = [np.asarray(t).tolist()]
        serve = make_serve_step(jcfg)
        for _ in range(DECODE):
            cache, t = serve(jp, t, cache)
            seq.append(np.asarray(t).tolist())
        ref_tokens[hkv] = seq
    np.savez(os.path.join(root, "inputs.npz"), **saved)
    mp.spawn(_worker, args=(4, root), nprocs=4, join=True)
    with open(os.path.join(root, "result.json")) as f:
        res = json.load(f)
    res["reference"] = ref_tokens
    return res


@pytest.mark.parametrize("hkv", [4, 1])
def test_sharded_steps_equal_unsharded(world, hkv):
    r = world[f"serve{hkv}"]
    assert r["logit_err"] < LOGIT_TOL
    assert r["tokens"] == r["unsharded"]
    # the cache shards kv heads over "model" where they divide it, else
    # its sequence
    assert r["k_placements"] == [1, 2 if hkv == 4 else 3]


@pytest.mark.parametrize("hkv", [4, 1])
def test_sharded_steps_equal_reference_tokens(world, hkv):
    assert world[f"serve{hkv}"]["tokens"] == world["reference"][hkv]


def test_sequence_sharded_decode_combine(world):
    assert world["combine_err"] < 1e-6


def test_sharded_train_step(world):
    l0, l1 = world["loss"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert world["grad_err"] < GRAD_TOL
    s0, s1 = world["step_loss"]
    assert abs(s1 - s0) <= 1e-5 * abs(s0)
    assert world["step_param_err"] < 1e-5
