"""Asynchronous parameter manager (paper §4.3, Fig. 6).

Hybrid heterogeneous parallelism needs every streamed module's weights to
be *pinned* (staged into page-locked host memory the copy engine can read)
before its host-to-device copy starts.  The manager guarantees:

  * asynchrony — pinning of the *next* module in a size group overlaps the
    current module's compute/transfer;
  * bounded memory — at most one spare pinned parameter per group: each
    group owns a ring of two fixed slots (consume one while staging the
    other), sized to the group's largest member.

Slots are ``torch.empty(..., pin_memory=True)`` byte buffers; a staging
copy is one ``copy_`` from the host array into a typed view of the slot,
run by a dedicated pin thread.  The source may be a strided view (the
engine hands over column slices without copying them first).  When the
manager serves the CPU (``pinned=False``), slots are ordinary memory.

A module's entry may be a single array or a **tuple of arrays** (the
quantized wire format streams an int8 payload plus its fp32 per-column
scales): tuple parts are packed at 64-byte alignment into one slot and
come back as typed tensor views, so rings are sized to the *wire* bytes
actually staged.  Pin spans carry those wire bytes (plus ``fp_bytes``,
the uncompressed equivalent, when the owner supplies it) and a per-module
``seq`` counter that the engine re-stamps on the matching transfer/device
spans.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.telemetry.tracer import NULL_TRACER, Tracer

# one staged entry: a host array, or parts packed into one slot
Entry = Union[np.ndarray, Tuple[np.ndarray, ...]]
# what a staged slot hands back: typed views of the pinned buffer
Staged = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

_ALIGN = 64      # part offsets inside a slot (keeps typed views aligned)


def entry_parts(entry: Entry) -> Tuple[np.ndarray, ...]:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def entry_wire_bytes(entry: Entry) -> int:
    """Bytes this entry moves over pin/DMA — the sum of its parts."""
    return sum(p.nbytes for p in entry_parts(entry))


def entry_slot_bytes(entry: Entry) -> int:
    """Staging bytes the entry occupies (parts padded to alignment)."""
    off = 0
    for p in entry_parts(entry):
        off = -(-off // _ALIGN) * _ALIGN + p.nbytes
    return off


@dataclasses.dataclass
class PinSlot:
    buffer: torch.Tensor                  # preallocated staging bytes
    name: Optional[str] = None            # module currently staged
    ready: Optional[Future] = None        # resolves when staging completes
    in_use: bool = False                  # acquired and not yet released
    seq: int = -1                         # per-module pin sequence number


class GroupRing:
    """Two-slot staging ring for one size group."""

    def __init__(self, group: str, slot_bytes: int, pinned: bool):
        self.group = group
        self.slot_bytes = slot_bytes
        self.slots = [PinSlot(torch.empty(slot_bytes, dtype=torch.uint8,
                                          pin_memory=pinned))
                      for _ in range(2)]
        self.lock = threading.Condition()

    def slot_for(self, name: str) -> Optional[PinSlot]:
        for s in self.slots:
            if s.name == name:
                return s
        return None

    def free_slot(self) -> Optional[PinSlot]:
        for s in self.slots:
            if not s.in_use and s.ready is None:
                return s
        return None


def pin_track(phase: Optional[str]) -> str:
    """The trace track of a manager's pin thread: ``pin``, or
    ``pin:<phase>`` for a phase engine's manager.  Each phase engine pins
    on a thread of its own, so their spans may overlap in time and need a
    track each; the telemetry reads every ``pin:*`` track as the pin
    stream."""
    return "pin" if phase is None else f"pin:{phase}"


class AsyncParamManager:
    """Stages module weights into pinned rings ahead of use.

    Driving pattern (paper Fig. 6)::

        mgr.prefetch(first_module_of_each_group)
        for module in plan:
            mgr.prefetch(next_same_group_module(module))   # stage ahead
            buf = mgr.acquire(module)                      # wait if needed
            ... copy buf to the device, then ...
            mgr.release(module)
    """

    def __init__(self, weights: Dict[str, Entry],
                 groups: Dict[str, str], *,
                 pinned: bool = True,
                 tracer: Tracer = NULL_TRACER,
                 trace_phase: Optional[str] = None,
                 fp_bytes: Optional[Dict[str, int]] = None):
        """``weights``: host arrays (or part tuples) per module;
        ``groups``: module -> group; ``pinned``: page-lock the slots (the
        engine passes False when it serves the CPU)."""
        self.weights = weights
        self.groups = groups
        self.tracer = tracer
        self.trace_phase = trace_phase
        self.fp_bytes = fp_bytes or {}
        by_group: Dict[str, List[str]] = {}
        for name, g in groups.items():
            by_group.setdefault(g, []).append(name)
        self.rings: Dict[str, GroupRing] = {}
        for g, names in by_group.items():
            slot_bytes = max(entry_slot_bytes(weights[n]) for n in names)
            self.rings[g] = GroupRing(g, slot_bytes, pinned)
        self._seq: Dict[str, int] = {}    # per-module pin counter
        self._pinner = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="pin")
        self.events: List[tuple] = []     # (op, module, t) for tests/metrics
        self._events_lock = threading.Lock()
        self._pin_lock = threading.Lock()
        self._pin_seconds = 0.0

    # ------------------------------------------------------------------
    def _log(self, op: str, name: str) -> None:
        with self._events_lock:
            self.events.append((op, name, time.perf_counter()))

    def _do_pin(self, slot: PinSlot, name: str, seq: int) -> Staged:
        src = self.weights[name]
        parts = entry_parts(src)
        attrs = dict(bytes=entry_wire_bytes(src), module=name,
                     phase=self.trace_phase, seq=seq)
        fp = self.fp_bytes.get(name)
        if fp is not None:
            attrs["fp_bytes"] = int(fp)
        with self.tracer.span(name, track=pin_track(self.trace_phase),
                              **attrs):
            t0 = time.perf_counter()
            views: List[torch.Tensor] = []
            off = 0
            for p in parts:
                off = -(-off // _ALIGN) * _ALIGN
                src_t = torch.from_numpy(p)
                dst = slot.buffer[off: off + p.nbytes] \
                    .view(src_t.dtype).view(p.shape)
                dst.copy_(src_t)
                views.append(dst)
                off += p.nbytes
            dt = time.perf_counter() - t0
            with self._pin_lock:
                self._pin_seconds += dt
        self._log("pinned", name)
        return tuple(views) if isinstance(src, (tuple, list)) else views[0]

    def _submit_pin(self, slot: PinSlot, name: str) -> None:
        """Assign the next per-module seq and start the staging copy.
        Caller must hold the ring lock."""
        seq = self._seq.get(name, -1) + 1
        self._seq[name] = seq
        slot.name = name
        slot.seq = seq
        slot.ready = self._pinner.submit(self._do_pin, slot, name, seq)

    def seq_of(self, name: str) -> Optional[int]:
        """Pin sequence number of the currently staged copy of ``name``."""
        ring = self.rings[self.groups[name]]
        with ring.lock:
            slot = ring.slot_for(name)
            return None if slot is None else slot.seq

    @property
    def pin_seconds(self) -> float:
        with self._pin_lock:
            return self._pin_seconds

    def reset_pin_seconds(self) -> None:
        with self._pin_lock:
            self._pin_seconds = 0.0

    # ------------------------------------------------------------------
    def prefetch(self, name: Optional[str]) -> bool:
        """Begin staging ``name`` if a slot is free.  Non-blocking.
        Returns True if staging was started (or already staged/running)."""
        if name is None:
            return False
        ring = self.rings[self.groups[name]]
        with ring.lock:
            if ring.slot_for(name) is not None:
                return True
            slot = ring.free_slot()
            if slot is None:
                return False          # ring full: caller retries after release
            self._submit_pin(slot, name)
            self._log("pin_start", name)
            return True

    def acquire(self, name: str) -> Staged:
        """Return the staged weights for ``name``.

        Pins synchronously if the prefetch never happened.  If the ring is
        clogged by prefetched-but-unconsumed entries (out-of-order
        access), a staged slot not in use is evicted — ``acquire`` always
        makes progress unless both slots are simultaneously *in use*,
        which the engine's prompt ``release`` rules out.
        """
        ring = self.rings[self.groups[name]]
        with ring.lock:
            slot = ring.slot_for(name)
            if slot is None:
                slot = ring.free_slot()
                if slot is None:
                    deadline = time.monotonic() + 30.0
                    while slot is None:
                        for s in ring.slots:
                            if not s.in_use and s.name != name:
                                slot = s
                                break
                        if slot is None:
                            if not ring.lock.wait(timeout=0.5) and \
                                    time.monotonic() > deadline:
                                raise RuntimeError(
                                    f"pin ring wedged acquiring {name!r}: "
                                    f"both slots in use")
                    if slot.ready is not None:
                        slot.ready.result()   # drain in-flight pin first
                        self._log("evicted", slot.name or "?")
                self._submit_pin(slot, name)
                self._log("pin_start_sync", name)
            slot.in_use = True
        staged = slot.ready.result()
        self._log("acquired", name)
        return staged

    def release(self, name: str) -> None:
        """Mark ``name``'s slot reusable.  The caller must not release
        before the slot's host-to-device copy has completed."""
        ring = self.rings[self.groups[name]]
        with ring.lock:
            slot = ring.slot_for(name)
            if slot is not None:
                slot.name = None
                slot.ready = None
                slot.in_use = False
                ring.lock.notify_all()
        self._log("released", name)

    # ------------------------------------------------------------------
    def pinned_overhead_bytes(self) -> int:
        """Total staging memory — paper bound: <= 2 slots per group."""
        return sum(2 * r.slot_bytes for r in self.rings.values())

    def shutdown(self) -> None:
        self._pinner.shutdown(wait=True)


def plan_prefetch_order(plan: Sequence[str], groups: Dict[str, str]
                        ) -> Dict[str, Optional[str]]:
    """next-same-group module for each module, wrapping to the next step
    (Fig. 6: the last module of a layer stages the first of the next, and
    the last module of the step wraps to the first of the next step)."""
    nxt: Dict[str, Optional[str]] = {}
    by_group: Dict[str, List[str]] = {}
    for name in plan:
        by_group.setdefault(groups[name], []).append(name)
    for g, names in by_group.items():
        for i, name in enumerate(names):
            nxt[name] = names[(i + 1) % len(names)] if len(names) > 1 else None
    return nxt
