"""Per-device cost of a traced step: FLOPs, memory traffic, collective bytes.

The JAX package's ``analysis/hlo_cost.py`` parses the partitioned HLO text
of a compiled step.  The port has no HLO: it counts the operations one
rank's step dispatches, under a ``TorchDispatchMode``
(:class:`CostMode`), with the same report (:class:`CostReport`):

  * FLOPs of the matmul class — products, convolutions and attention, by
    ``torch.utils.flop_counter``'s formulas on the LOCAL shapes (the mode
    declines every ``DTensor`` op, so the ``DTensor`` machinery runs it and
    the per-shard ops it issues come back to the mode as plain tensors).
    The reference counts ``dot`` and ``convolution``: the same class of
    work;
  * bytes: each op's operands plus results (views move nothing; an
    in-place row write bills 2x its rows, a gather 2x its result, as the
    reference's slice-aware billing does), each element capped at
    ``max_bytes_per_elem`` bytes where that is given;
  * collective wire bytes per device, by the reference's ring formulas on
    per-device shapes (:func:`ring_wire_bytes`):
        all-reduce        2 * S * (n-1)/n
        all-gather        S_out * (n-1)/n
        reduce-scatter    S_in  * (n-1)/n
        all-to-all        S * (n-1)/n
        collective-permute S

A hand-written kernel is opaque to the mode: each call of a
``repro_torch.kernels.ops`` wrapper is billed as one op (its operands and
result), and its FLOPs are those of the product its plain version computes
— on a CUDA tensor the plain version is run on meta copies of the
operands to count them — so the count does not depend on the route.
:attr:`CostMode.kernel_calls` tallies the calls by (name, route); the
route ``meta`` is a shape-only trace through the plain version.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.kernels import ops

def ring_wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes one member sends for a collective over ``n`` members; ``size``
    is the input's bytes (the output's for an all-gather)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return size * (n - 1) / n
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {kind}")


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def scaled(self, k: float) -> "CostReport":
        return CostReport(
            flops=self.flops * k, bytes=self.bytes * k,
            collective_bytes={kk: v * k
                              for kk, v in self.collective_bytes.items()},
            collective_count=int(self.collective_count * k))

    def add(self, other: "CostReport") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v
        self.collective_count += other.collective_count


def _collective_ops() -> Dict:
    """functional collective (op overload packet) -> its kind."""
    f = torch.ops._c10d_functional
    return {f.all_reduce: "all-reduce", f.all_reduce_: "all-reduce",
            f.all_gather_into_tensor: "all-gather",
            f.reduce_scatter_tensor: "reduce-scatter",
            f.all_to_all_single: "all-to-all"}


_SKIP = {"wait_tensor", "_wrap_tensor_autograd", "empty", "empty_like",
         "empty_strided", "new_empty", "zeros", "ones", "full", "arange",
         "scalar_tensor", "lift_fresh", "detach", "_local_scalar_dense",
         "new_empty_strided", "zeros_like", "ones_like", "full_like"}
_MOVEMENT = {"_to_copy", "clone", "copy_", "contiguous", "_unsafe_view"}
_ROW_WRITES = {"index_copy_", "index_put_", "index_copy", "index_put",
               "slice_scatter", "select_scatter"}
_GATHERS = {"index", "gather", "embedding", "index_select"}

def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class CostMode(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collective wire bytes (module
    docstring).  Use as a context manager around the step; read
    :attr:`report` and :attr:`kernel_calls` after."""

    def __init__(self, *, max_bytes_per_elem: Optional[int] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self._colls = _collective_ops()
        self.cap = max_bytes_per_elem
        self.report = CostReport()
        self.kernel_calls: Dict[Tuple[str, str], int] = \
            collections.Counter()
        self._in_kernel = 0

    def __enter__(self):
        self._prev_observer = ops.set_observer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.set_observer(self._prev_observer)
        return super().__exit__(*exc)

    # ------------------------------------------------------------------
    def _nbytes(self, t) -> int:
        """Bytes ``t`` spans in memory: a broadcast (stride-0) dim counts
        once."""
        if not isinstance(t, torch.Tensor):
            return 0
        by = t.element_size()
        if self.cap is not None and t.is_floating_point() and by > self.cap:
            by = self.cap
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride:
                n *= size
        return n * by

    def _tensors_bytes(self, tree) -> int:
        flat, _ = tree_flatten(tree)
        return sum(self._nbytes(t) for t in flat)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor issues the local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out       # DTensor's shape propagation on global shapes
        packet = func._overloadpacket
        name = packet.__name__
        rep = self.report
        if packet in self._flops:
            rep.flops += self._flops[packet](*args, **kwargs, out_val=out)
            if self._in_kernel:
                return out
        kind = self._colls.get(packet)
        if kind is not None:
            if kind == "all-gather":
                n, size = args[1], self._nbytes(out)
            elif kind == "reduce-scatter":
                n, size = args[2], self._nbytes(args[0])
            else:
                n, size = _group_size(args[-1]), self._nbytes(args[0])
            if n > 1:
                rep.collective_bytes[kind] = \
                    rep.collective_bytes.get(kind, 0.0) \
                    + ring_wire_bytes(kind, size, n)
                rep.collective_count += 1
            return out
        if self._in_kernel or name in _SKIP or _is_view(func):
            return out
        if self.cap is not None and name in _MOVEMENT:
            return out                     # a layout/dtype artifact
        if name in _ROW_WRITES:
            src = args[-1] if name != "index_put_" else args[2]
            rep.bytes += 2.0 * self._nbytes(src)
        elif name in _GATHERS:
            rep.bytes += 2.0 * self._tensors_bytes(out)
        else:
            rep.bytes += self._tensors_bytes((args, kwargs)) \
                + self._tensors_bytes(out)
        return out

    # ------------------------------------------------------------------
    def kernel_call(self, name: str, fn, ref_fn, route: str, args, kwargs):
        """Run one kernel wrapper's call (``fn``: the kernel on ``cuda``,
        the plain version elsewhere) billed as one op: its operands and
        result, and the FLOPs of its plain version (run on meta copies of
        the operands when the kernel ran)."""
        self.kernel_calls[(name, route)] += 1
        self._in_kernel += 1
        try:
            out = fn(*args, **kwargs)
            if route == "cuda":
                meta = lambda t: (torch.empty_strided(
                    t.shape, t.stride(), dtype=t.dtype, device="meta")
                    if isinstance(t, torch.Tensor) else t)
                ref_fn(*tree_map(meta, args), **tree_map(meta, kwargs))
        finally:
            self._in_kernel -= 1
        self.report.bytes += self._tensors_bytes((args, kwargs)) \
            + self._tensors_bytes(out)
        return out
