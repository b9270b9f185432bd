"""Overlap analysis — did the I/O actually hide? (paper §4.3, Fig. 5c).

HeteGen's speedup comes from running pin ‖ transfer ‖ host GEMM ‖ device
compute concurrently.  :class:`repro_torch.core.engine.StreamStats` totals say
how busy each stream was; this module consumes the tracer's timeline to
answer the question the totals cannot: *while I/O was in flight, was
compute also in flight?*

Definitions (all on the host ``perf_counter`` clock):

* A stream's **busy set** is the interval union of its spans — self
  overlap within one stream (which cannot happen on the single-worker
  pools, but defensively) collapses.
* **io** = union(pin, transfer); **compute** = union(cpu_gemm, device).
* **I/O-hidden fraction** = |io ∩ compute| / |io| — the share of I/O
  wall-time during which some compute was also running.  1.0 means the
  paper's overlap story holds perfectly; ≈0 means the streams ran
  serially (the forced-serial regression test pins this).
* **critical path** per window: the component with the largest busy
  time inside the window — the stream to optimize next.
* **utilization** per stream: busy / window wall, same definition as
  ``StreamStats.utilization`` so the two reports cross-check.

Per-step breakdowns slice the same math by the batcher's ``step`` spans
("step" track); phase attribution uses the span's ``phase`` attr when
present.  Pure host arithmetic over recorded floats — no tensor is touched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.telemetry.tracer import Span

# the engine's stream tracks, in report order
IO_TRACKS = ("pin", "transfer")
COMPUTE_TRACKS = ("cpu_gemm", "device")
STREAM_TRACKS = IO_TRACKS + COMPUTE_TRACKS
SAMPLE_TRACK = "sample"

Interval = Tuple[float, float]


def stream_of(track: str) -> str:
    """The stream a track belongs to: a phase engine's pin thread records
    on ``pin:<phase>`` (two threads, two tracks), and both are the ``pin``
    stream; every other track is its own stream."""
    return track.split(":", 1)[0]


def union_intervals(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge intervals into a disjoint, sorted union.  Zero-duration
    intervals vanish (they carry no busy time)."""
    ivs = sorted((t0, t1) for t0, t1 in intervals if t1 > t0)
    out: List[Interval] = []
    for t0, t1 in ivs:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def intersect_unions(a: Sequence[Interval],
                     b: Sequence[Interval]) -> List[Interval]:
    """Intersection of two disjoint sorted unions (two-pointer sweep)."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip_union(ivs: Sequence[Interval], t0: float,
               t1: float) -> List[Interval]:
    """Restrict a disjoint union to the window [t0, t1]."""
    out = []
    for a, b in ivs:
        lo, hi = max(a, t0), min(b, t1)
        if hi > lo:
            out.append((lo, hi))
    return out


def total(ivs: Sequence[Interval]) -> float:
    return sum(t1 - t0 for t0, t1 in ivs)


@dataclasses.dataclass
class WindowReport:
    """Overlap numbers for one time window (a step, a phase, or the
    whole trace)."""

    label: str
    t0: float
    t1: float
    busy: Dict[str, float]            # track -> busy seconds in window
    io_busy: float                    # |union(pin, transfer)|
    compute_busy: float               # |union(cpu_gemm, device)|
    io_hidden: float                  # |io ∩ compute|
    phase: Optional[str] = None

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def io_hidden_frac(self) -> float:
        """Fraction of I/O wall-time with concurrent compute, in [0, 1].
        Windows with no I/O report 1.0 — nothing needed hiding."""
        if self.io_busy <= 0.0:
            return 1.0
        return min(1.0, max(0.0, self.io_hidden / self.io_busy))

    @property
    def critical_path(self) -> str:
        """The busiest *physical* component in the window (pin /
        transfer / cpu_gemm / device / sample; tie → report order).
        Envelope tracks (step, phase) would trivially win — they wrap
        the streams — so they only count when no stream recorded."""
        cand = {k: v for k, v in self.busy.items()
                if stream_of(k) in STREAM_TRACKS or k == SAMPLE_TRACK} \
            or self.busy
        if not cand or all(v <= 0.0 for v in cand.values()):
            return "idle"
        return max(cand, key=lambda k: (cand[k],))

    def utilization(self) -> Dict[str, float]:
        w = self.wall
        if w <= 0.0:
            return {k: 0.0 for k in self.busy}
        return {k: v / w for k, v in self.busy.items()}


@dataclasses.dataclass
class OverlapReport:
    """Whole-trace + per-step overlap breakdown."""

    overall: WindowReport
    steps: List[WindowReport]

    @property
    def io_hidden_frac(self) -> float:
        return self.overall.io_hidden_frac

    def as_dict(self) -> Dict[str, Any]:
        def win(w: WindowReport) -> Dict[str, Any]:
            return {"label": w.label, "wall_s": w.wall,
                    "phase": w.phase,
                    "busy_s": dict(w.busy),
                    "utilization": w.utilization(),
                    "io_busy_s": w.io_busy,
                    "compute_busy_s": w.compute_busy,
                    "io_hidden_frac": w.io_hidden_frac,
                    "critical_path": w.critical_path}
        return {"overall": win(self.overall),
                "steps": [win(w) for w in self.steps]}

    def render(self) -> str:
        """Human-readable text report (the ``--overlap-report`` output)."""
        o = self.overall
        lines = ["overlap report",
                 "=" * 64,
                 f"window           {o.wall * 1e3:10.3f} ms",
                 f"io hidden        {o.io_hidden_frac:10.3f}   "
                 f"(io busy {o.io_busy * 1e3:.3f} ms, "
                 f"compute busy {o.compute_busy * 1e3:.3f} ms)",
                 f"critical path    {o.critical_path:>10s}",
                 "stream utilization:"]
        util = o.utilization()
        order = (*STREAM_TRACKS, SAMPLE_TRACK)
        for trk in sorted((k for k in o.busy if stream_of(k) in order),
                          key=lambda k: (order.index(stream_of(k)), k)):
            lines.append(f"  {trk:<12s} {util[trk]:6.3f}   "
                         f"({o.busy[trk] * 1e3:.3f} ms busy)")
        if self.steps:
            lines.append("")
            lines.append(f"{'step':<16s} {'phase':<8s} {'wall ms':>9s} "
                         f"{'io hidden':>9s}  critical")
            for w in self.steps:
                lines.append(
                    f"{w.label:<16s} {(w.phase or '-'):<8s} "
                    f"{w.wall * 1e3:9.3f} {w.io_hidden_frac:9.3f}  "
                    f"{w.critical_path}")
        return "\n".join(lines)


def _window_report(label: str, t0: float, t1: float,
                   by_track: Dict[str, List[Interval]],
                   phase: Optional[str] = None) -> WindowReport:
    clipped = {trk: clip_union(ivs, t0, t1)
               for trk, ivs in by_track.items()}
    io = union_intervals(iv for trk, ivs in clipped.items()
                         if stream_of(trk) in IO_TRACKS for iv in ivs)
    comp = union_intervals(iv for trk, ivs in clipped.items()
                           if stream_of(trk) in COMPUTE_TRACKS for iv in ivs)
    return WindowReport(
        label=label, t0=t0, t1=t1,
        busy={trk: total(ivs) for trk, ivs in clipped.items()},
        io_busy=total(io), compute_busy=total(comp),
        io_hidden=total(intersect_unions(io, comp)), phase=phase)


def compute_overlap(spans: Sequence[Span], *,
                    step_track: str = "step") -> OverlapReport:
    """Build the overlap report from a span list.

    Spans on ``step_track`` define per-step windows (their ``phase``
    attr, if any, labels the row); every other track contributes busy
    intervals.  An empty trace yields a zero-width overall window.
    """
    by_track: Dict[str, List[Interval]] = {}
    step_spans: List[Span] = []
    for s in spans:
        if s.track == step_track:
            step_spans.append(s)
        else:
            by_track.setdefault(s.track, []).append((s.t0, s.t1))
    by_track = {trk: union_intervals(ivs) for trk, ivs in by_track.items()}

    if spans:
        t0 = min(s.t0 for s in spans)
        t1 = max(s.t1 for s in spans)
    else:
        t0 = t1 = 0.0
    overall = _window_report("overall", t0, t1, by_track)

    steps = []
    for s in sorted(step_spans, key=lambda s: s.t0):
        phase = (s.attrs or {}).get("phase")
        steps.append(_window_report(s.name, s.t0, s.t1, by_track,
                                    phase=phase))
    return OverlapReport(overall=overall, steps=steps)
