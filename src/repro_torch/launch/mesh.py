"""Production mesh construction on ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``: the same shapes and
axis names, built with ``init_device_mesh`` over the process group that
stands (``torch.distributed.init_process_group`` first).

Topology:
    single-pod:  (16, 16)    ("data", "model")         = 256 ranks
    multi-pod:   (2, 16, 16) ("pod", "data", "model")  = 512 ranks; the
                 leading "pod" axis carries only data parallelism.

:func:`init_fake_world` stands in for the JAX package's
``--xla_force_host_platform_device_count``: a world of 256 or 512 ranks in
one process, as rank 0, over torch's ``fake`` process group, whose
collectives return at once and move no data (values after a collective are
meaningless; shapes and the collectives issued are what such a world
shows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              *, device_type: str = "cuda"):
    """Any mesh over the world's ranks (e.g. (2, 2) on 4 gloo ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_fake_world(world_size: int, device: str = "cpu") -> None:
    """Start a process group of ``world_size`` ranks in this process, as
    rank 0, whose collectives move no data (torch's ``fake`` backend and
    its ``FakeStore``).  Tears down a group that stands first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
