"""Logical-axis sharding rules (MaxText-style) on a torch ``DeviceMesh``.

The port of the JAX package's ``distributed/shardings.py``.  Model code
annotates tensors with *logical* axes ("batch", "embed", "ff", "experts",
...); a :class:`ShardingRules` table maps those to mesh axes.  Where the
JAX package's annotation is a ``with_sharding_constraint``, here
:meth:`ShardingRules.act` redistributes a ``DTensor`` to the placements of
its spec; a plain tensor, or any tensor under disabled rules, passes
unchanged, so the same model code runs on one device.

The default table implements:

  * data parallelism over ("pod", "data") on the batch axis
    (the "pod" axis only ever carries data parallelism);
  * Megatron tensor parallelism over "model" on heads / ff / vocab;
  * expert parallelism over "model" for MoE experts;
  * optional sequence parallelism ("sp") — activations between blocks are
    sharded over "model" on the sequence axis.

:class:`PartitionSpec` is JAX's: a tuple with one entry per tensor dim,
each None, a mesh axis name or a tuple of names.
:meth:`ShardingRules.placements` turns one into a ``Shard(d)`` /
``Replicate()`` per mesh dim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over them, the first one major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


# logical axis -> mesh axes (None = replicated)
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),          # fused qkv output dim
    "ff": ("model",),
    "experts": ("model",),
    "expert_group": ("pod", "data"),
    "vocab": ("model",),
    "kv_seq": None,             # decode KV cache sequence axis
    "ssm_heads": ("model",),
    "conv_ch": ("model",),
    "stage": None,
}

# sequence-parallel overlay: activations sharded over model on seq between
# blocks; KV-cache seq sharded when kv_heads cannot fill the model axis.
SP_OVERLAY = {
    "seq": ("model",),
}


def spec_axes(part) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclasses.dataclass
class ShardingRules:
    """Maps logical axes to mesh axes and applies activation constraints.

    All spec construction is *shape-guarded*: a mesh axis is only assigned
    to a tensor dim it divides (longest prefix of the mapped axes whose
    size product divides the dim), so unusual head counts / tiny batches
    degrade to replication.
    """

    table: Dict[str, Optional[Tuple[str, ...]]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    mesh_axes: Tuple[str, ...] = ()          # axes present in the mesh
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh: Optional[object] = None            # the DeviceMesh act() places on
    enabled: bool = True

    @classmethod
    def for_mesh(cls, mesh, *, sequence_parallel: bool = False,
                 overrides: Optional[Dict] = None) -> "ShardingRules":
        table = dict(DEFAULT_RULES)
        if sequence_parallel:
            table.update(SP_OVERLAY)
        if overrides:
            table.update(overrides)
        names = tuple(mesh.mesh_dim_names)
        return cls(table=table, mesh_axes=names,
                   mesh_shape={a: int(n) for a, n in zip(names, mesh.shape)},
                   mesh=mesh)

    @classmethod
    def disabled(cls) -> "ShardingRules":
        return cls(enabled=False)

    @property
    def active(self) -> bool:
        """Whether :meth:`act` can place anything: enabled, over a mesh."""
        return self.enabled and bool(self.mesh_axes) \
            and self.mesh is not None

    # ------------------------------------------------------------------
    def _axes_for(self, logical: Optional[str],
                  dim: Optional[int]) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        mesh_axes = self.table.get(logical)
        if mesh_axes is None:
            return None
        present = tuple(a for a in mesh_axes if a in self.mesh_axes)
        if not present:
            return None
        if dim is None:
            return present
        # longest prefix whose size product divides the dim
        out = []
        prod = 1
        for a in present:
            n = self.mesh_shape.get(a, 1)
            if dim % (prod * n) == 0:
                out.append(a)
                prod *= n
            else:
                break
        return tuple(out) or None

    def _mk_spec(self, logical, shape=None) -> PartitionSpec:
        cands = []
        for i, ax in enumerate(logical):
            dim = None if shape is None else shape[i]
            cands.append(self._axes_for(ax, dim) or ())
        # a mesh axis may appear at most once per spec: resolve conflicts
        # right-to-left so inner, more specific dims win (under sequence
        # parallelism the q/k/v head dim keeps "model" and the seq dim
        # drops it — Megatron-SP semantics)
        used: set = set()
        parts: list = [None] * len(cands)
        for i in range(len(cands) - 1, -1, -1):
            axes = tuple(a for a in cands[i] if a not in used)
            used.update(axes)
            parts[i] = None if not axes else (
                axes[0] if len(axes) == 1 else axes)
        return PartitionSpec(*parts)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry these logical axes."""
        return self._mk_spec(logical)

    def spec_for_shape(self, shape, *logical: Optional[str]
                       ) -> PartitionSpec:
        assert len(shape) == len(logical), (shape, logical)
        return self._mk_spec(logical, shape)

    def placements(self, spec: Sequence) -> tuple:
        """One ``Shard(d)`` / ``Replicate()`` per mesh dim for ``spec``: a
        mesh axis named in entry d shards tensor dim d.  A dim split over
        several axes takes them in mesh order (the spec tables list them
        so: ("pod", "data"))."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh_axes)
        for d, part in enumerate(spec):
            for a in spec_axes(part):
                out[self.mesh_axes.index(a)] = Shard(d)
        return tuple(out)

    def act(self, x, *logical: Optional[str]):
        """Place an activation on its spec; a no-op when the rules are
        disabled, have no mesh, or ``x`` is a plain tensor."""
        if not self.active or not is_dtensor(x):
            return x
        want = self.placements(self.spec_for_shape(x.shape, *logical))
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


NO_RULES = ShardingRules.disabled()
