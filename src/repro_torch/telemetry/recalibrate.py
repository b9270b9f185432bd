"""Trace-driven alpha recalibration (paper §4.4 on measured spans).

``alpha_benchmark.refine_alpha`` refines the analytic alpha by probing
synthetic workloads.  Once a traced run exists we can do better: the
engine's spans carry the *actual* bytes each stream moved or computed,
so effective per-stream speeds fall out of the trace —

    v_cpu = Σ host-shard bytes / Σ cpu_gemm busy seconds
    v_pin = Σ device-shard bytes / Σ pin busy seconds
    v_com = Σ device-shard bytes / Σ transfer busy seconds

— and the probe callables the solver needs are linear projections from
those speeds:

    T_cpu(a) = (1 - a) · B / v_cpu
    T_com(a) = max(a · B / v_pin,  a · B / v_com)

The crossing F_cpu(ā) = F_com(ā) is scale-invariant in B, so the
refined alpha depends only on measured speed ratios; B (bytes per step)
just sets ``predicted_time``'s units.  Under a compressed wire format
(``wstream="q8"``) pin/transfer spans carry wire bytes plus an
``fp_bytes`` attr; v_pin/v_com come out in wire bytes/s and the link
term is scaled by the measured wire ratio r = Σwire/Σfp, i.e.
T_com(a) = a·B·r / v, matching the shifted law in docs/ANALYSIS.md.  The same ``refine_alpha``
machinery (probe window, polynomial fit, root solve, hysteresis at the
caller) applies unchanged — tests check the fit matches a direct
``refine_alpha`` call on the synthesized callables to tight tolerance.

Consumed by ``HeteGenBackend(recalibrate=...)``: at a safe point (start
of a decode step, engines idle) the backend snapshots recent spans,
recalibrates, and re-plans the phase if the refined alpha drifted past
the threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.core.alpha_benchmark import FitResult, refine_alpha
from repro_torch.telemetry.overlap import stream_of
from repro_torch.telemetry.tracer import Span

# engine/param-manager tracks that speed estimation reads
_CPU_TRACK = "cpu_gemm"
_PIN_TRACK = "pin"
_TRANS_TRACK = "transfer"


@dataclasses.dataclass(frozen=True)
class SpeedEstimate:
    """Effective stream speeds (bytes/s) measured from a trace.

    ``v_pin``/``v_com`` are *wire* bytes/s — under a compressed stream
    (``wstream="q8"``) the pin/transfer spans carry the bytes that
    actually moved.  ``pin_fp_bytes``/``trans_fp_bytes`` accumulate the
    spans' ``fp_bytes`` attr (uncompressed equivalent; defaults to the
    wire bytes on fp traces), so :attr:`wire_ratio` recovers the
    compression factor r the alpha law needs.
    """

    v_cpu: float
    v_pin: float
    v_com: float
    cpu_bytes: int
    pin_bytes: int
    trans_bytes: int
    cpu_s: float
    pin_s: float
    trans_s: float
    n_spans: int
    pin_fp_bytes: int = 0
    trans_fp_bytes: int = 0

    @property
    def wire_ratio(self) -> float:
        """Wire bytes per compute byte on the transfer stream (r <= 1
        under compression, exactly 1.0 on fp traces)."""
        if self.trans_fp_bytes <= 0:
            return 1.0
        return self.trans_bytes / self.trans_fp_bytes

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["wire_ratio"] = self.wire_ratio
        return d


def _tally(spans: Sequence[Span], track: str,
           phase: Optional[str]) -> tuple:
    """(wire_bytes, fp_bytes, secs, n) for byte-carrying spans of a track.
    ``fp_bytes`` falls back to the wire bytes when a span has no
    ``fp_bytes`` attr (fp streams: wire == compute)."""
    nbytes, fp_bytes, secs, n = 0, 0, 0.0, 0
    for s in spans:
        if stream_of(s.track) != track:
            continue
        attrs = s.attrs or {}
        if phase is not None and attrs.get("phase") not in (None, phase):
            continue
        b = attrs.get("bytes")
        if not b or s.dur <= 0.0:
            continue
        nbytes += int(b)
        fp_bytes += int(attrs.get("fp_bytes", b))
        secs += s.dur
        n += 1
    return nbytes, fp_bytes, secs, n


def measured_speeds(spans: Sequence[Span], *,
                    phase: Optional[str] = None) -> SpeedEstimate:
    """Effective v_cpu / v_pin / v_com from a traced run.

    Only spans carrying a ``bytes`` attr count (the engine and param
    manager attach it).  ``phase`` restricts to spans tagged with that
    phase attr (untagged spans always count).  Raises ``ValueError``
    when a stream has no measurable spans — an all-device or all-host
    plan cannot calibrate the streams it never exercised.
    """
    cpu_b, _, cpu_s, n_cpu = _tally(spans, _CPU_TRACK, phase)
    pin_b, pin_fp, pin_s, n_pin = _tally(spans, _PIN_TRACK, phase)
    trn_b, trn_fp, trn_s, n_trn = _tally(spans, _TRANS_TRACK, phase)
    missing = [name for name, n in
               [(_CPU_TRACK, n_cpu), (_PIN_TRACK, n_pin),
                (_TRANS_TRACK, n_trn)] if n == 0]
    if missing:
        raise ValueError(
            f"cannot estimate stream speeds: no byte-carrying spans on "
            f"{missing} (phase={phase!r})")
    return SpeedEstimate(
        v_cpu=cpu_b / cpu_s, v_pin=pin_b / pin_s, v_com=trn_b / trn_s,
        cpu_bytes=cpu_b, pin_bytes=pin_b, trans_bytes=trn_b,
        cpu_s=cpu_s, pin_s=pin_s, trans_s=trn_s,
        n_spans=n_cpu + n_pin + n_trn,
        pin_fp_bytes=pin_fp, trans_fp_bytes=trn_fp)


def recalibrate_alpha(
    spans: Sequence[Span],
    alpha0: float,
    *,
    phase: Optional[str] = None,
    bytes_per_step: Optional[float] = None,
    gamma: float = 0.08,
    lam: float = 0.02,
    degree: int = 2,
) -> FitResult:
    """Refine ``alpha0`` from a recorded trace.

    Measures stream speeds with :func:`measured_speeds`, synthesizes the
    probe callables above, and hands them to the existing
    ``refine_alpha`` solver.  ``bytes_per_step`` scales
    ``predicted_time`` to real seconds; when omitted the measured total
    device+host bytes are used (the refined alpha itself is
    scale-invariant either way).
    """
    est = measured_speeds(spans, phase=phase)
    # B counts *compute* bytes (the alpha split partitions the fp weight);
    # the link only carries r·B wire bytes of it.  On fp traces r == 1 and
    # fp tallies equal wire tallies, so this reduces to the original form.
    B = float(bytes_per_step) if bytes_per_step is not None else float(
        est.cpu_bytes + max(est.pin_fp_bytes, est.trans_fp_bytes))
    B = max(B, 1.0)
    r = est.wire_ratio

    def time_cpu(a: float) -> float:
        return (1.0 - a) * B / est.v_cpu

    def time_com(a: float) -> float:
        wire = a * B * r
        return max(wire / est.v_pin, wire / est.v_com)

    return refine_alpha(time_cpu, time_com, alpha0,
                        gamma=gamma, lam=lam, degree=degree)
