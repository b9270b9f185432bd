"""Fault tolerance for long runs, ported from the JAX package's
``distributed/fault_tolerance.py``.

* :class:`StragglerDetector` — per-host EWMA of step times; a host whose
  smoothed step time exceeds ``factor`` x the fleet median is flagged.
* :func:`retry` — step-level retry with bounded attempts for transient
  failures.
* :class:`PreemptionHandler` — SIGTERM -> checkpoint-now flag.
* :class:`ElasticTopology` — the best ("data", "model") mesh for however
  many ranks are alive, built as a ``DeviceMesh`` over the first ones.
* :func:`reshard_state` — re-place a restored state tree on a new mesh.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class StragglerDetector:
    def __init__(self, alpha: float = 0.2, factor: float = 1.5,
                 warmup: int = 3):
        self.alpha = alpha
        self.factor = factor
        self.warmup = warmup
        self.ewma: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, host: str, step_time: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = step_time if prev is None else \
            (1 - self.alpha) * prev + self.alpha * step_time
        self.counts[host] = self.counts.get(host, 0) + 1

    def stragglers(self) -> List[str]:
        ready = {h: t for h, t in self.ewma.items()
                 if self.counts[h] >= self.warmup}
        if len(ready) < 2:
            return []
        med = float(np.median(list(ready.values())))
        return [h for h, t in ready.items() if t > self.factor * med]

    def fleet_summary(self) -> Dict[str, float]:
        if not self.ewma:
            return {}
        vals = list(self.ewma.values())
        return {"median": float(np.median(vals)),
                "max": max(vals), "min": min(vals),
                "stragglers": len(self.stragglers())}


def retry(fn: Callable, *, attempts: int = 3, backoff: float = 0.0,
          exceptions: Tuple = (RuntimeError, OSError)):
    """Run ``fn`` with bounded retries on transient failures."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except exceptions as e:          # pragma: no cover - timing path
            last = e
            if backoff:
                time.sleep(backoff * (2 ** i))
    raise last


class PreemptionHandler:
    """SIGTERM sets a flag the train loop polls (checkpoint + exit)."""

    def __init__(self, install: bool = True):
        self.triggered = False
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:           # not in main thread (tests)
                self._prev = None

    def _on_signal(self, signum, frame):
        self.triggered = True

    def trigger(self) -> None:           # test hook
        self.triggered = True

    def reset(self) -> None:
        self.triggered = False


@dataclasses.dataclass(frozen=True)
class TopologyChoice:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int


class ElasticTopology:
    """Pick the best mesh for however many ranks are currently alive.

    Preference: keep the model axis as requested, shrink/grow data
    parallelism — losing a host should cost throughput, not the run.
    """

    def __init__(self, model_parallel: int = 16,
                 axes: Tuple[str, ...] = ("data", "model")):
        self.model_parallel = model_parallel
        self.axes = axes

    def choose(self, n_devices: int) -> TopologyChoice:
        mp = self.model_parallel
        while mp > 1 and n_devices % mp:
            mp //= 2
        dp = n_devices // mp
        return TopologyChoice(shape=(dp, mp), axes=("data", "model"),
                              devices_used=dp * mp)

    def make_mesh(self, n_devices: Optional[int] = None,
                  device_type: str = "cuda"):
        """A ``DeviceMesh`` of :meth:`choose`'s shape over ranks
        0 .. devices_used - 1 of the world (all of it by default)."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        n = dist.get_world_size() if n_devices is None else n_devices
        choice = self.choose(n)
        ranks = torch.arange(choice.devices_used).reshape(choice.shape)
        return DeviceMesh(device_type, ranks, mesh_dim_names=choice.axes)


def reshard_state(state, mesh, spec_fn):
    """Re-place a state tree onto a new mesh.

    ``spec_fn(path, leaf) -> PartitionSpec`` supplies the target layout
    (path in keystr form); a ``DTensor`` leaf is redistributed to it, a
    plain tensor distributed from this rank's copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.shardings import ShardingRules
    from repro_torch.distributed.specs import map_with_path
    names = tuple(mesh.mesh_dim_names)
    rules = ShardingRules(mesh_axes=names,
                          mesh_shape=dict(zip(names, mesh.shape)), mesh=mesh)

    def one(path, leaf):
        pl = rules.placements(spec_fn(path, leaf))
        if isinstance(leaf, DTensor):
            if leaf.device_mesh == mesh:
                return leaf.redistribute(mesh, pl)
            # another mesh: through the whole value (every rank holds it)
            return distribute_tensor(leaf.full_tensor(), mesh, pl)
        return distribute_tensor(leaf, mesh, pl)

    return map_with_path(one, state)
