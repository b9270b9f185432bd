"""Metrics registry — one snapshot interface over the serving counters.

PR 1-7 each grew an ad-hoc ``stats()`` dict (engine stream seconds,
scheduler counters, kv allocator gauges, speculative acceptance).  This
registry supersedes them behind one typed surface:

* :class:`Counter` — monotonically increasing totals (steps, tokens,
  preemptions).
* :class:`Gauge` — last-written point-in-time values (mapped pages,
  current alpha).
* :class:`Histogram` — fixed-bucket distributions (step latency).
  Buckets are cumulative-free plain counts per edge interval plus
  count/sum, so recording is O(#buckets) worst case and allocation-free.

Everything is host-side arithmetic — no device arrays, no syncs (the
``telemetry-no-sync`` lint rule walks these paths).  Thread safety is a
single registry lock taken per record; the serving hot path records a
handful of instruments per *step* (not per token or per linear), so the
lock is never contended enough to matter.

The legacy dicts stay readable during the deprecation window:
:meth:`MetricsRegistry.absorb` maps a nested ``stats()`` dict into
namespaced gauges/counters (``kv.free_pages``, ``scheduler.preemptions``,
``stream.cpu_s``, ...), and ``LLM.metrics()`` returns the merged
snapshot — tests assert key-for-key equivalence
(tests/test_telemetry.py).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_DEFAULT_EDGES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class Counter:
    """A monotonically increasing total."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += by


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket distribution: counts per ``(edge[i-1], edge[i]]``
    interval plus an overflow bucket, with running count/sum/min/max."""

    __slots__ = ("name", "edges", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str,
                 edges: Sequence[float] = _DEFAULT_EDGES):
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing")
        self.buckets = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        i = 0
        for e in self.edges:
            if value <= e:
                break
            i += 1
        self.buckets[i] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "edges": list(self.edges),
                "buckets": list(self.buckets)}


class MetricsRegistry:
    """Named instruments behind one snapshot.

    ::

        m = MetricsRegistry()
        m.counter("serve.steps").inc()
        m.gauge("kv.free_pages").set(31)
        m.histogram("serve.step_s").observe(0.012)
        m.snapshot()  # {"serve.steps": 1.0, "kv.free_pages": 31.0,
                      #  "serve.step_s": {...}}

    Instrument creation is get-or-create by name; asking for an existing
    name with a different type raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] = _DEFAULT_EDGES) -> Histogram:
        return self._get(name, Histogram, edges)

    # -- legacy-stats absorption ---------------------------------------
    def absorb(self, stats: Dict[str, Any], prefix: str = "") -> None:
        """Map a legacy nested ``stats()`` dict into namespaced gauges.

        Numeric leaves become gauges ``<prefix><path.to.leaf>``; nested
        dicts recurse with a dotted prefix; non-numeric leaves (policy
        names, executor labels) are skipped — they are identity, not
        measurement.  Idempotent per key: re-absorbing overwrites the
        gauge, matching point-in-time semantics.
        """
        for key, val in stats.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                self.absorb(val, prefix=f"{name}.")
            elif isinstance(val, bool):
                self.gauge(name).set(1.0 if val else 0.0)
            elif isinstance(val, (int, float)):
                self.gauge(name).set(float(val))
            elif hasattr(val, "cpu") and hasattr(val, "wall"):
                # a StreamStats-shaped object: busy seconds per stream
                self.absorb({"cpu_s": val.cpu, "pin_s": val.pin,
                             "trans_s": val.trans, "dev_s": val.dev,
                             "wall_s": val.wall}, prefix=f"{name}.")

    def snapshot(self) -> Dict[str, Any]:
        """One flat dict: counters/gauges as floats, histograms as
        dicts.  Safe to call from any thread."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, inst in sorted(self._instruments.items()):
                if isinstance(inst, Histogram):
                    out[name] = inst.as_dict()
                else:
                    out[name] = inst.value
            return out
