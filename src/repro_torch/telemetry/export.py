"""Chrome/Perfetto trace export + schema validation.

The tracer's spans serialize to the Chrome Trace Event Format (the JSON
``chrome://tracing`` / Perfetto's legacy importer reads): complete
events (``ph: "X"``) with microsecond timestamps relative to the trace
origin, one ``tid`` per logical track, and ``thread_name`` metadata so
the UI labels rows ``pin`` / ``transfer`` / ``cpu_gemm`` / ``device``
instead of thread ids.  Instant events become ``ph: "i"``.

:func:`validate_chrome_trace` checks the structural schema *and* the
two physical invariants our tracks promise — timestamps are monotone non-negative, and spans on one track
never overlap (each stream is serial: single-worker pools in the
engine, the serving thread for step/phase tracks).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.telemetry.tracer import Event, Span, Tracer

_PID = 0


def _track_ids(names: Sequence[str]) -> Dict[str, int]:
    # stable order: first-seen, so step/phase tracks land on low tids
    ids: Dict[str, int] = {}
    for n in names:
        if n not in ids:
            ids[n] = len(ids)
    return ids


def to_chrome_trace(spans: Sequence[Span],
                    events: Sequence[Event] = (),
                    *, t_origin: Optional[float] = None) -> Dict[str, Any]:
    """Build the Chrome Trace Event JSON object (not yet serialized)."""
    if t_origin is None:
        starts = [s.t0 for s in spans] + [e.t for e in events]
        t_origin = min(starts) if starts else 0.0
    tids = _track_ids([s.track for s in spans] + [e.track for e in events])

    trace_events: List[Dict[str, Any]] = []
    for track, tid in tids.items():
        trace_events.append({
            "ph": "M", "pid": _PID, "tid": tid,
            "name": "thread_name", "args": {"name": track}})
    for s in spans:
        ev: Dict[str, Any] = {
            "ph": "X", "pid": _PID, "tid": tids[s.track], "name": s.name,
            "ts": (s.t0 - t_origin) * 1e6, "dur": s.dur * 1e6,
            "cat": s.track}
        if s.attrs:
            ev["args"] = dict(s.attrs)
        trace_events.append(ev)
    for e in events:
        ev = {"ph": "i", "pid": _PID, "tid": tids[e.track], "name": e.name,
              "ts": (e.t - t_origin) * 1e6, "s": "t", "cat": e.track}
        if e.attrs:
            ev["args"] = dict(e.attrs)
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer) -> Dict[str, Any]:
    """Dump a tracer's full buffer to ``path`` as Chrome trace JSON."""
    doc = to_chrome_trace(tracer.spans(), tracer.events_list(),
                          t_origin=tracer.t_origin)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Schema + invariant check; returns a list of problems (empty ==
    valid).  Checked: required keys per event kind, non-negative
    monotone timestamps, non-negative durations, and **no overlapping
    spans within one (pid, tid) track** — the serial-stream guarantee
    the overlap math relies on."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]

    by_track: Dict[Any, List[Any]] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev or "name" not in ev:
            problems.append(f"event {i}: missing pid/tid/name")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
                continue
            by_track.setdefault((ev["pid"], ev["tid"]), []).append(
                (ts, ts + dur, ev["name"]))

    # per-track: spans sorted by start must not overlap.  Tolerance is
    # 1 ns — perf_counter deltas are exact doubles but serialization
    # may round.
    for key, spans in by_track.items():
        spans.sort()
        for (a0, a1, an), (b0, b1, bn) in zip(spans, spans[1:]):
            if b0 < a1 - 1e-3:  # µs units: 1e-3 µs = 1 ns slack
                problems.append(
                    f"track {key}: span {bn!r} (ts={b0:.3f}) overlaps "
                    f"{an!r} (ends {a1:.3f})")
    return problems
