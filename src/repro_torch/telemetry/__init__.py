"""repro_torch.telemetry — zero-sync tracing, metrics, and trace-driven tuning.

The observability layer of the heterogeneous runtime:

* :mod:`tracer` — ring-buffered spans/events on host ``perf_counter``,
  never touching a device tensor.
* :mod:`metrics` — counters/gauges/histograms behind one snapshot.
* :mod:`export` — Chrome/Perfetto ``trace.json`` writer + validator.
* :mod:`overlap` — per-step I/O-hidden fraction, stream utilization,
  critical-path breakdown (paper Fig. 5c, Table 2).
* :mod:`recalibrate` — measured stream speeds → ``refine_alpha``.
"""

from repro_torch.telemetry.export import (to_chrome_trace,
                                          validate_chrome_trace,
                                          write_chrome_trace)
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry)
from repro_torch.telemetry.overlap import (OverlapReport, WindowReport,
                                           compute_overlap)
from repro_torch.telemetry.recalibrate import (SpeedEstimate,
                                               measured_speeds,
                                               recalibrate_alpha)
from repro_torch.telemetry.tracer import (NULL_TRACER, Event, Span, Tracer,
                                          as_tracer)

__all__ = [
    "Counter", "Event", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "OverlapReport", "Span", "SpeedEstimate", "Tracer",
    "WindowReport", "as_tracer", "compute_overlap", "measured_speeds",
    "recalibrate_alpha", "to_chrome_trace", "validate_chrome_trace",
    "write_chrome_trace",
]
