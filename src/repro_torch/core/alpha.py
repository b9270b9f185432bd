"""HeteGen's computation-distribution law (paper §3.2 and §4.2).

``alpha`` is the fraction of a linear module's weight computed **on the
accelerator** (with its weights streamed over the link); ``1 - alpha`` is
computed on the host CPU, concurrently.  The paper derives (Eq. 4):

    (1-a) W / V_cpu  =  a W / V_gpu  +  a W / V_com

i.e. host compute time balances (device compute + weight transfer), giving
(Eq. 5):

    a = 1 / ( V_cpu/V_com + V_cpu/V_gpu + 1 )

With device compute negligible relative to the link (Eq. 6):

    a ≈ V_com / (V_com + V_cpu)

and in measured-time form (Eq. 7), with T'_x the time for the *whole*
operator on resource x:

    a ≈ T'_cpu / (T'_cpu + T'_com)

The hybrid strategy (paper Fig. 5c) splits communication into pin||transfer
(Eq. 8-9):

    T_cpu = T_gpu + max(T_pin, T_trans)
    a ≈ T'_cpu / (T'_cpu + max(T'_pin, T'_trans))

All functions are pure and unit-free (any consistent speed/time units).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DEFAULT_PREFILL_TOKENS = 128   # prompt-length prior when none was observed
DEFAULT_VERIFY_TOKENS = 8      # draft-run prior (k + 1) when none observed


def alpha_analytic(v_cpu: float, v_gpu: float, v_com: float) -> float:
    """Exact distribution ratio, paper Eq. 5."""
    if v_cpu <= 0:
        return 1.0  # no host compute available: everything on the device
    if v_gpu <= 0 or v_com <= 0:
        return 0.0  # no device or no link: everything stays on the host
    return 1.0 / (v_cpu / v_com + v_cpu / v_gpu + 1.0)


def alpha_for_batch(hw, batch: int) -> float:
    """Batch-aware analytic ratio (paper §4.1): decode at batch ``b`` runs
    ~``b`` FLOPs per parameter byte, so compute-bound resources derate and
    the optimal split shifts with the serving batch size.

    ``hw`` is any speed provider with ``v_cpu(intensity)`` /
    ``v_gpu(intensity)`` / ``v_com()`` (duck-typed
    :class:`repro_torch.core.hw.HardwareSpec`).
    """
    intensity = float(max(batch, 1))
    return alpha_analytic(hw.v_cpu(intensity), hw.v_gpu(intensity),
                          hw.v_com())


def resolve_phase_tokens(phase: str,
                         tokens_per_seq: Optional[int] = None) -> int:
    """Per-sequence tokens of one step for a serving phase — THE place
    the phase -> intensity rule lives (alpha law and policy builder both
    call it): 1 for decode, the prompt length for prefill
    (:data:`DEFAULT_PREFILL_TOKENS` when unobserved), and the draft run
    length k + 1 for the speculative "verify" phase
    (:data:`DEFAULT_VERIFY_TOKENS` when unobserved) — verification scores
    batch x (k + 1) positions against one weight stream, so alpha tuning
    must see it as the prefill-like workload it is, not as decode."""
    if phase not in ("prefill", "decode", "verify"):
        raise ValueError(f"unknown phase {phase!r}")
    if tokens_per_seq is None:
        tokens_per_seq = {"prefill": DEFAULT_PREFILL_TOKENS,
                          "verify": DEFAULT_VERIFY_TOKENS,
                          "decode": 1}[phase]
    return max(int(tokens_per_seq), 1)


def alpha_for_phase(hw, batch: int, phase: str = "decode",
                    tokens_per_seq: Optional[int] = None) -> float:
    """Phase-aware analytic ratio (paper §4.1).

    Decode moves every parameter byte per step but computes only ``batch``
    token positions, so its arithmetic intensity is ~``batch`` FLOPs per
    parameter byte and the link/host usually dominate (small alpha).
    Prefill computes ``batch * prompt_len`` positions against the same
    weight traffic, so intensity scales with the prompt: the host GEMM
    derates by orders of magnitude and the optimal split pushes toward
    the accelerator (alpha -> 1).
    """
    intensity = float(max(batch, 1)
                      * resolve_phase_tokens(phase, tokens_per_seq))
    return alpha_analytic(hw.v_cpu(intensity), hw.v_gpu(intensity),
                          hw.v_com())


def effective_link_speed(v_com: float, wire_ratio: float) -> float:
    """Link speed in *compute* bytes/s when the wire format compresses.

    Streaming ``wire_ratio`` wire bytes per compute byte (int8 + scales
    over fp32 gives r ~= 1/4) makes the link look ``1/r`` times faster to
    the alpha law: substituting T_com -> r * T_com in Eq. 4 yields

        a = 1 / ( r * V_cpu/V_com + V_cpu/V_gpu + 1 )

    which is exactly :func:`alpha_analytic` evaluated at ``v_com / r``
    (derivation in docs/ANALYSIS.md).  Monotone: r < 1 => larger alpha.
    """
    if wire_ratio <= 0:
        raise ValueError("wire_ratio must be positive")
    return v_com / wire_ratio


def alpha_approx(v_cpu: float, v_com: float) -> float:
    """Approximate ratio ignoring device compute time, paper Eq. 6."""
    if v_cpu <= 0:
        return 1.0
    if v_com <= 0:
        return 0.0
    return v_com / (v_com + v_cpu)


def alpha_from_times(t_cpu: float, t_com: float) -> float:
    """Measured-time form, paper Eq. 7.

    ``t_cpu``/``t_com``: time to run / transfer the WHOLE operator on the
    host / over the link.
    """
    if t_cpu <= 0:
        return 0.0
    if t_com <= 0:
        return 1.0
    return t_cpu / (t_cpu + t_com)


def alpha_hybrid(t_cpu: float, t_pin: float, t_trans: float) -> float:
    """Hybrid pin||transfer form, paper Eq. 9."""
    return alpha_from_times(t_cpu, max(t_pin, t_trans))


def balance_residual(alpha: float, v_cpu: float, v_gpu: float,
                     v_com: float) -> float:
    """Signed imbalance of Eq. 4 at a given alpha (0 at the optimum).

    Positive means the host side is slower (alpha too small).
    """
    t_host = (1.0 - alpha) / v_cpu if v_cpu > 0 else float("inf")
    t_dev = alpha / v_gpu + alpha / v_com
    return t_host - t_dev


def quantize_alpha(alpha: float, n_out: int, tile: int = 128) -> float:
    """Round alpha to a whole number of MXU-aligned output-column tiles.

    TPU adaptation (DESIGN.md §2): the device-side fraction of a split
    linear is laid out in ``tile``-wide column blocks so the streamed matmul
    hits the 128x128 systolic array without re-layout.  Returns the achieved
    fraction ``k*tile/n_out`` closest to ``alpha`` (clamped to [0, 1]).
    """
    if n_out <= 0:
        raise ValueError("n_out must be positive")
    alpha = min(max(alpha, 0.0), 1.0)
    n_tiles = max(1, -(-n_out // tile))  # ceil
    k = round(alpha * n_out / tile)
    k = min(max(k, 0), n_tiles)
    cols = min(k * tile, n_out)
    return cols / n_out


def split_columns(alpha: float, n_out: int, tile: int = 128) -> int:
    """Number of output columns assigned to the device (tile-aligned)."""
    return int(round(quantize_alpha(alpha, n_out, tile) * n_out))


@dataclasses.dataclass(frozen=True)
class AlphaDecision:
    """A resolved distribution for one module."""

    alpha: float                 # achieved (tile-quantized) fraction
    device_cols: int             # output columns on the device
    host_cols: int               # output columns on the host
    t_cpu: float                 # predicted host time at this alpha
    t_com: float                 # predicted link time at this alpha

    @property
    def predicted_latency(self) -> float:
        return max(self.t_cpu, self.t_com)


def decide(n_out: int, bytes_total: float, *, v_cpu: float, v_gpu: float,
           v_com: float, v_pin: float | None = None,
           tile: int = 128) -> AlphaDecision:
    """End-to-end alpha decision for a module with ``n_out`` output columns.

    Uses the hybrid law when ``v_pin`` is given (communication limited by
    max(pin, transfer) — paper Eq. 9), else the exact analytic law (Eq. 5).
    """
    if v_pin is not None:
        # effective link speed under pin||transfer parallelism
        v_eff = min(v_com, v_pin) if v_pin < v_com else v_com
        a = alpha_analytic(v_cpu, v_gpu, v_eff)
    else:
        a = alpha_analytic(v_cpu, v_gpu, v_com)
    a_q = quantize_alpha(a, n_out, tile)
    dev_cols = split_columns(a, n_out, tile)
    t_cpu = (1 - a_q) * bytes_total / v_cpu if v_cpu > 0 else float("inf")
    t_com = a_q * bytes_total / v_com if v_com > 0 else float("inf")
    return AlphaDecision(alpha=a_q, device_cols=dev_cols,
                         host_cols=n_out - dev_cols, t_cpu=t_cpu, t_com=t_com)
