"""Zero-device-sync tracing for the heterogeneous streams (paper Fig. 5c).

HeteGen's throughput claim is an *overlap* claim: pin ‖ transfer ‖ host
GEMM ‖ device compute must run concurrently or the I/O bottleneck is not
hidden.  `StreamStats` can only say how busy each stream was in total;
this tracer records *when* each piece of work ran, so the overlap report
(:mod:`repro_torch.telemetry.overlap`) can compute the I/O-hidden fraction and
critical path per step, and the Chrome exporter
(:mod:`repro_torch.telemetry.export`) can render the timeline.

Design constraints, in order:

* **No device synchronization, ever.**  Timestamps are host
  ``time.perf_counter()`` only.  The tracer never touches a device tensor —
  a tracer that calls ``.item()`` or ``torch.cuda.synchronize`` would
  serialize the very streams it measures (enforced statically by the
  ``telemetry-no-sync`` lint rule, docs/ANALYSIS.md).
* **Thread-safe without a hot-path lock.**  Every thread appends to its
  own ring buffer (a bounded ``deque`` owned by that thread; the shared
  registry of buffers is locked only on a thread's *first* span).  The
  engine's pin / transfer / host-GEMM threads and the dispatch thread
  never contend.
* **Negligible overhead when disabled.**  A disabled tracer's ``span``
  returns a shared no-op context manager and ``event`` returns
  immediately — no allocation, no timestamp, no branch beyond one
  attribute check.  Serving code therefore instruments unconditionally
  and leaves the tracer off in production-critical paths.

Tracks are logical streams, not threads: a span lands on its explicit
``track=`` when given, else on the calling thread's default track
(:meth:`Tracer.set_track`), else on the thread's name.  The engine uses
explicit tracks (``pin`` / ``transfer`` / ``cpu_gemm`` / ``device``) so
the report's stream identities are stable regardless of which thread
pool executes the work.  Within one track spans never overlap as long as
the track's work is serial (single-worker pools here) — the property the
Chrome-trace validator checks.

Ring capacity bounds memory: when a thread's buffer is full the oldest
spans drop (counted — :meth:`Tracer.dropped`), never the newest; a
trace's tail is always intact.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed interval of work on a track.  Times are host
    ``perf_counter`` seconds (shared origin within one process)."""

    name: str
    track: str
    t0: float
    t1: float
    attrs: Optional[Dict[str, Any]] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class Event:
    """One instant marker (admission, preemption, prefetch, ...)."""

    name: str
    track: str
    t: float
    attrs: Optional[Dict[str, Any]] = None


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager that records one span on exit."""

    __slots__ = ("_buf", "name", "track", "attrs", "t0")

    def __init__(self, buf: "_ThreadBuf", name: str, track: str,
                 attrs: Optional[Dict[str, Any]]):
        self._buf = buf
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self) -> "_LiveSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._buf.add_span(self.name, self.track, self.t0,
                           time.perf_counter(), self.attrs)
        return False

    def set(self, **attrs) -> None:
        """Attach/override attrs before the span closes (e.g. a step
        span learning its phase only after the work ran)."""
        self.attrs = {**(self.attrs or {}), **attrs}


class _ThreadBuf:
    """One thread's ring of spans + events.  Appended to only by its
    owning thread; snapshots copy under the GIL (deque iteration is
    atomic enough for our read-mostly snapshot: the worst case is
    missing the very newest record, never corruption)."""

    __slots__ = ("spans", "events", "n_spans", "n_events", "track")

    def __init__(self, capacity: int, track: str):
        self.spans: deque = deque(maxlen=capacity)
        self.events: deque = deque(maxlen=capacity)
        self.n_spans = 0          # total appended (drops = n - len)
        self.n_events = 0
        self.track = track        # thread-default track

    def add_span(self, name, track, t0, t1, attrs) -> None:
        self.spans.append((name, track, t0, t1, attrs))
        self.n_spans += 1

    def add_event(self, name, track, t, attrs) -> None:
        self.events.append((name, track, t, attrs))
        self.n_events += 1


class Tracer:
    """Ring-buffered span/event recorder for the serving hot path.

    ::

        tr = Tracer()
        with tr.span("blk0.wq", track="cpu_gemm", bytes=1 << 20):
            y = x @ w_host
        tr.event("preempt", track="sched", rid=3)

    ``capacity`` bounds each *thread's* buffer (oldest spans drop first).
    A tracer constructed with ``enabled=False`` — or the module's
    :data:`NULL_TRACER` — is a no-op whose ``span`` returns a shared
    null context manager.
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.t_origin = time.perf_counter()
        # a list, not a dict keyed by thread ident: the OS recycles
        # idents, and a recycled key would silently drop a finished
        # thread's buffer (pool threads come and go across retunes)
        self._bufs: List[_ThreadBuf] = []
        self._lock = threading.Lock()       # guards the buffer registry
        self._local = threading.local()     # fast path: this thread's buf

    # -- recording ------------------------------------------------------
    def _buf(self) -> _ThreadBuf:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            th = threading.current_thread()
            buf = _ThreadBuf(self.capacity, th.name)
            with self._lock:
                self._bufs.append(buf)
            self._local.buf = buf
        return buf

    def span(self, name: str, track: Optional[str] = None, **attrs):
        """Context manager timing one interval.  ``track`` pins the span
        to a logical stream; default is the thread's track."""
        if not self.enabled:
            return _NULL_SPAN
        buf = self._buf()
        return _LiveSpan(buf, name, track or buf.track, attrs or None)

    def event(self, name: str, track: Optional[str] = None,
              **attrs) -> None:
        """Record one instant marker."""
        if not self.enabled:
            return
        buf = self._buf()
        buf.add_event(name, track or buf.track, time.perf_counter(),
                      attrs or None)

    def set_track(self, track: str) -> None:
        """Set the calling thread's default track name."""
        if self.enabled:
            self._buf().track = track

    def mark(self) -> float:
        """Host timestamp on the tracer's clock — pair with the
        ``since=`` filters to scope a snapshot to recent work."""
        return time.perf_counter()

    # -- snapshots ------------------------------------------------------
    def _all_bufs(self) -> List[_ThreadBuf]:
        with self._lock:
            return list(self._bufs)

    def spans(self, since: Optional[float] = None,
              track: Optional[str] = None) -> List[Span]:
        """All recorded spans, sorted by start time.  ``since`` keeps
        spans that *end* after the mark; ``track`` filters exactly."""
        out: List[Span] = []
        for buf in self._all_bufs():
            for name, trk, t0, t1, attrs in list(buf.spans):
                if since is not None and t1 <= since:
                    continue
                if track is not None and trk != track:
                    continue
                out.append(Span(name, trk, t0, t1, attrs))
        out.sort(key=lambda s: (s.t0, s.t1))
        return out

    def events_list(self, since: Optional[float] = None,
                    track: Optional[str] = None) -> List[Event]:
        out: List[Event] = []
        for buf in self._all_bufs():
            for name, trk, t, attrs in list(buf.events):
                if since is not None and t <= since:
                    continue
                if track is not None and trk != track:
                    continue
                out.append(Event(name, trk, t, attrs))
        out.sort(key=lambda e: e.t)
        return out

    def dropped(self) -> int:
        """Spans+events lost to ring wrap since construction/clear."""
        n = 0
        for buf in self._all_bufs():
            n += (buf.n_spans - len(buf.spans)) \
                + (buf.n_events - len(buf.events))
        return n

    def clear(self) -> None:
        for buf in self._all_bufs():
            buf.spans.clear()
            buf.events.clear()
            buf.n_spans = 0
            buf.n_events = 0

    def __bool__(self) -> bool:
        return self.enabled


NULL_TRACER = Tracer(capacity=1, enabled=False)
"""The shared disabled tracer — instrument against this by default so
call sites never branch on ``tracer is None``."""


def as_tracer(trace) -> Tracer:
    """Normalize a user-facing ``trace=`` knob: ``True`` builds a fresh
    tracer, a :class:`Tracer` passes through, falsy yields the shared
    no-op tracer."""
    if isinstance(trace, Tracer):
        return trace
    if trace:
        return Tracer()
    return NULL_TRACER
