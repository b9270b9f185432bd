"""The elastic topology against the JAX package's
``repro.distributed.fault_tolerance``, and ``reshard_state`` over a world of
4 gloo ranks: a state tree placed on a (4, 1) mesh, re-placed on the (2, 2)
mesh that ``ElasticTopology(model_parallel=2).make_mesh`` builds, and back,
bit for bit."""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.distributed import fault_tolerance as TF


def test_elastic_topology_choices_equal_reference():
    from repro.distributed import fault_tolerance as JF
    for mp_want in (16, 8, 6, 1):
        j, t = JF.ElasticTopology(mp_want), TF.ElasticTopology(mp_want)
        for n in range(1, 601):
            a, b = j.choose(n), t.choose(n)
            assert (tuple(b.shape), tuple(b.axes), b.devices_used) == \
                (tuple(a.shape), tuple(a.axes), a.devices_used), (mp_want, n)


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(8, 12, generator=g),
                       "b": torch.randn(12, generator=g)},
            "opt": {"m": torch.randn(8, 12, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _spec_fn(path, leaf):
    from repro_torch.distributed.shardings import PartitionSpec as P
    if leaf.dim() == 2:
        return P("data", "model")
    if leaf.dim() == 1:
        return P("model")
    return P()


def _worker(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.specs import flatten_with_path
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    try:
        state = _state()
        tall = DeviceMesh("cpu", torch.arange(4).reshape(4, 1),
                          mesh_dim_names=("data", "model"))
        square = TF.ElasticTopology(model_parallel=2).make_mesh(
            device_type="cpu")
        a = TF.reshard_state(state, tall, _spec_fn)
        b = TF.reshard_state(a, square, _spec_fn)
        c = TF.reshard_state(b, tall, _spec_fn)
        res = {"square": [int(x) for x in square.shape],
               "b_local": list(b["params"]["w"].to_local().shape),
               "equal": all(
                   torch.equal(x, y.full_tensor()) and
                   isinstance(y, DTensor)
                   for (_, x), (_, y) in zip(flatten_with_path(state),
                                             flatten_with_path(c)))}
        if rank == 0:
            with open(os.path.join(root, "res.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_reshard_state_round_trip(tmp_path):
    mp.spawn(_worker, args=(4, str(tmp_path)), nprocs=4, join=True)
    res = json.loads((tmp_path / "res.json").read_text())
    assert res["square"] == [2, 2]
    assert res["b_local"] == [4, 6]
    assert res["equal"]
