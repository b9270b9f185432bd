"""The port's analysis against the JAX package's ``repro.analysis``:

* ``memory_model.estimate`` equal key for key (the fit flag, renamed
  ``fits_80GB`` against one H100, aside) for every assigned arch on the
  train, prefill and decode cells of the (16, 16) mesh, from each
  package's own param / optimizer / cache shapes and spec trees;
* ``roofline.model_flops`` equal for every arch x shape, and
  ``ideal_seconds`` equal once each term is scaled by the ratio of the two
  packages' constants (TPU v5e there, H100 here);
* the collective ring formulas equal to the reference HLO analyzer's on
  the same bytes and group sizes;
* the cost mode's per-device FLOPs of a known matmul chain on a fake
  (2, 2) mesh, exact.
"""

from __future__ import annotations

import functools

import pytest
import torch

from repro_torch.analysis import hlo_cost as TH
from repro_torch.analysis import memory_model as TMM
from repro_torch.analysis import roofline as TRL
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.shapes import SHAPES

AXES, MESH = ("data", "model"), {"data": 16, "model": 16}


def _accum(batch: int) -> int:
    for a in (16, 8, 4, 2, 1):
        if batch % a == 0 and batch // a >= MESH["data"]:
            return a
    return 1


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    import jax
    from repro.configs import get_config
    from repro.models import model as M
    return jax.eval_shape(lambda k: M.init_params(get_config(arch), k),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_estimate(arch: str, shape: str):
    import jax
    from repro.analysis import memory_model as MM
    from repro.configs import get_config
    from repro.configs.shapes import SHAPES as JSH, input_specs
    from repro.distributed import specs as SP
    from repro.distributed.shardings import SP_OVERLAY, ShardingRules
    from repro.train.optimizer import OptimizerConfig, make_optimizer
    cfg = get_config(arch)
    s = JSH[shape]
    table = dict(ShardingRules().table, **(SP_OVERLAY if cfg.fsdp else {}))
    rules = ShardingRules(table=table, mesh_axes=AXES, mesh_shape=MESH)
    p = _jax_params(arch)
    ps = SP.param_specs(cfg, rules, p, serve=s.kind != "train")
    kw = dict(kind=s.kind, batch=s.batch, seq=s.seq, rules=rules,
              param_shapes=p, param_spec=ps)
    if s.kind == "train":
        accum = _accum(s.batch)
        init, _ = make_optimizer(OptimizerConfig(
            name=cfg.optimizer, moment_dtype="bfloat16"
            if cfg.optimizer == "adamw" else "float32"))
        o = jax.eval_shape(init, p)
        kw.update(accum=accum, accum_dtype_bytes=2 if accum >= 8 else 4,
                  opt_shapes=o, opt_spec=SP.opt_state_specs(cfg, rules, o, ps))
    else:
        c = input_specs(cfg, shape)["cache"]
        kw.update(cache_shapes=c, cache_spec=SP.cache_specs(cfg, rules, c))
    return MM.estimate(cfg, **kw)


def _torch_estimate(arch: str, shape: str):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.distributed import specs as SP
    from repro_torch.distributed.shardings import SP_OVERLAY, ShardingRules
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    cfg = get_config(arch)
    s = SHAPES[shape]
    table = dict(ShardingRules().table, **(SP_OVERLAY if cfg.fsdp else {}))
    rules = ShardingRules(table=table, mesh_axes=AXES, mesh_shape=MESH)
    p = SP.param_shapes(cfg)
    ps = SP.param_specs(cfg, rules, p, serve=s.kind != "train")
    kw = dict(kind=s.kind, batch=s.batch, seq=s.seq, rules=rules,
              param_shapes=p, param_spec=ps)
    if s.kind == "train":
        accum = _accum(s.batch)
        init, _ = make_optimizer(OptimizerConfig(
            name=cfg.optimizer, moment_dtype="bfloat16"
            if cfg.optimizer == "adamw" else "float32"))
        o = init(p)
        kw.update(accum=accum, accum_dtype_bytes=2 if accum >= 8 else 4,
                  opt_shapes=o, opt_spec=SP.opt_state_specs(cfg, rules, o, ps))
    else:
        c = input_specs(cfg, shape)["cache"]
        kw.update(cache_shapes=c, cache_spec=SP.cache_specs(cfg, rules, c))
    return TMM.estimate(cfg, **kw)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_memory_model_equals_reference(arch, shape):
    want = dict(_jax_estimate(arch, shape))
    got = _torch_estimate(arch, shape)
    assert got.pop("fits_80GB") == (got["total"] <= TMM.H100_HBM_BYTES)
    want.pop("fits_16GB")
    assert got == want


def test_memory_model_issue_cells():
    """The per-device footprints quoted for the dry-run's card cells."""
    gib = 2 ** 30
    for arch, params, cache in (("mistral-nemo-12b", 1.43, 2.50),
                                ("nemotron-4-340b", 4.12, 9.00)):
        est = _torch_estimate(arch, "decode_32k")
        assert round(est["params"] / gib, 2) == params
        assert round(est["cache"] / gib, 2) == cache


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_roofline_model_flops_and_ideal(arch):
    from repro.analysis import roofline as JRL
    for shape in SHAPES:
        assert TRL.model_flops(arch, shape) == JRL.model_flops(arch, shape)
        j = JRL.ideal_seconds(arch, shape, 256)
        t = TRL.ideal_seconds(arch, shape, 256)
        assert t["compute"] == pytest.approx(
            j["compute"] * JRL.PEAK_FLOPS / TRL.PEAK_FLOPS, rel=1e-12)
        assert t["memory"] == pytest.approx(
            j["memory"] * JRL.HBM_BW / TRL.HBM_BW, rel=1e-12)
        assert t["floor"] == max(t["compute"], t["memory"])


_HLO = """HloModule m

ENTRY %main.1 (p: f32[4096]) -> f32[4096] {{
  %p = f32[4096]{{0}} parameter(0)
  %x = {out} {op}(f32[4096]{{0}} %p), replica_groups={{{{{group}}}}}{extra}
}}
"""


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all"])
def test_ring_formulas_equal_reference(kind, n):
    from repro.analysis.hlo_cost import HloCostAnalyzer
    size_in = 4096 * 4
    out = {"all-gather": f"f32[{4096 * n}]{{0}}",
           "reduce-scatter": f"f32[{4096 // n}]{{0}}"}.get(kind,
                                                          "f32[4096]{0}")
    text = _HLO.format(out=out, op=kind,
                       group=",".join(str(i) for i in range(n)),
                       extra=", dimensions={0}" if kind != "all-reduce"
                       else ", to_apply=%add")
    rep = HloCostAnalyzer(text).entry_cost()
    size = size_in * n if kind == "all-gather" else size_in
    assert TH.ring_wire_bytes(kind, size, n) == rep.collective_bytes[kind]


def test_cost_mode_matmul_chain_on_fake_mesh():
    """x (B, d) batch-sharded over data, w1 (d, f) column-parallel and w2
    (f, d) row-parallel over model: each device multiplies its (B/2, d)
    rows by its (d, f/2) and (f/2, d) shards, and reduces the partial sum
    (an all-reduce over model) when the result is placed whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import init_fake_world, make_mesh
    b, d, f = 32, 512, 1024
    init_fake_world(4)
    try:
        mesh = make_mesh((2, 2), AXES, device_type="cpu")
        x = distribute_tensor(torch.ones(b, d), mesh, [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.ones(d, f), mesh,
                               [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.ones(f, d), mesh,
                               [Replicate(), Shard(0)])
        with TH.CostMode() as cm:
            y = (x @ w1) @ w2
            y.redistribute(mesh, [Shard(0), Replicate()])
        rep = cm.report
        assert rep.flops == 2 * (b // 2) * d * (f // 2) * 2
        assert rep.collective_count == 1
        assert rep.collective_bytes == {
            "all-reduce": TH.ring_wire_bytes("all-reduce",
                                             (b // 2) * d * 4, 2)}
        # FlopCounterMode outside the DTensor dispatch counts global shapes
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as fc:
            (x @ w1) @ w2
        assert fc.get_total_flops() == 2 * b * d * f * 2
    finally:
        dist.destroy_process_group()
