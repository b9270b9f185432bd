"""Fault tolerance for long runs: the part the ``Trainer`` needs, ported
from the JAX package's ``distributed/fault_tolerance.py``.

* :class:`StragglerDetector` — per-host EWMA of step times; a host whose
  smoothed step time exceeds ``factor`` x the fleet median is flagged.
* :func:`retry` — step-level retry with bounded attempts for transient
  failures.
* :class:`PreemptionHandler` — SIGTERM -> checkpoint-now flag.

``ElasticTopology`` and ``reshard_state`` wait for the port of
``distributed/`` onto ``torch.distributed``.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Dict, List, Tuple

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
