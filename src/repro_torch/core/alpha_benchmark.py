"""Alpha benchmark — measurement-refined distribution ratios (paper §4.4).

CPU GEMM time and link time are *not* exactly proportional to the parameter
fraction alpha (cache effects, per-call overheads, DMA setup), and one-shot
benchmarks are noisy.  The paper therefore refines the analytic alpha:

  1. start from the prior ``alpha0`` (Eq. 9),
  2. probe alphas in ``[alpha0 - gamma, alpha0 + gamma]`` in steps ``lambda``,
  3. measure T'_cpu(a) and max(T'_pin, T'_trans)(a) at each probe,
  4. fit polynomials  F_cpu(a), F_com(a)  to the measurements,
  5. solve  F_cpu(ā) = F_com(ā)   (paper Eq. 10-12).

The solver works on any pair of measurement callables, so the same code
refines (a) real wall-clock measurements on this host, (b) the discrete-event
simulator, and (c) unit-test stubs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import alpha as alpha_lib


@dataclasses.dataclass
class FitResult:
    alpha: float                    # refined ā
    alpha0: float                   # analytic prior
    probes: np.ndarray              # probed alpha values
    t_cpu: np.ndarray               # measured host times at probes
    t_com: np.ndarray               # measured max(pin, trans) at probes
    coef_cpu: np.ndarray            # polynomial coefficients (np.polyfit order)
    coef_com: np.ndarray
    predicted_time: float           # F_cpu(ā) (= F_com(ā) at the solution)


def _fit_poly(x: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    degree = min(degree, len(x) - 1)
    return np.polyfit(x, y, degree)


def refine_alpha(
    time_cpu: Callable[[float], float],
    time_com: Callable[[float], float],
    alpha0: float,
    *,
    gamma: float = 0.08,
    lam: float = 0.02,
    degree: int = 2,
    repeats: int = 1,
) -> FitResult:
    """Refine ``alpha0`` by probing and polynomial fitting (paper Eq. 10-12).

    ``time_cpu(a)``   — measured host time when the host computes (1-a).
    ``time_com(a)``   — measured max(T_pin, T_trans) when the device gets a.
    """
    lo = max(0.0, alpha0 - gamma)
    hi = min(1.0, alpha0 + gamma)
    n = max(3, int(round((hi - lo) / max(lam, 1e-6))) + 1)
    probes = np.linspace(lo, hi, n)

    t_cpu = np.array([
        min(time_cpu(float(a)) for _ in range(repeats)) for a in probes])
    t_com = np.array([
        min(time_com(float(a)) for _ in range(repeats)) for a in probes])

    coef_cpu = _fit_poly(probes, t_cpu, degree)
    coef_com = _fit_poly(probes, t_com, degree)

    # Solve F_cpu(a) - F_com(a) = 0 on [lo, hi]; fall back to the probe with
    # the smallest |difference| if no real root lands in range.
    diff = np.polysub(coef_cpu, coef_com)
    candidates = []
    if len(diff) > 1:
        for r in np.roots(diff):
            if abs(r.imag) < 1e-9 and lo - 1e-9 <= r.real <= hi + 1e-9:
                candidates.append(float(r.real))
    if candidates:
        a_bar = min(candidates, key=lambda a: abs(a - alpha0))
    else:
        a_bar = float(probes[np.argmin(np.abs(t_cpu - t_com))])
    a_bar = float(min(max(a_bar, 0.0), 1.0))
    predicted = float(np.polyval(coef_cpu, a_bar))
    return FitResult(alpha=a_bar, alpha0=alpha0, probes=probes, t_cpu=t_cpu,
                     t_com=t_com, coef_cpu=coef_cpu, coef_com=coef_com,
                     predicted_time=predicted)


# ---------------------------------------------------------------------------
# Real measurement helpers (used by examples/alpha_tuning.py on this host).
# ---------------------------------------------------------------------------

def measure_host_linear(n_in: int, n_out: int, *, batch: int = 1,
                        dtype=np.float32, iters: int = 3) -> float:
    """Wall-clock seconds for one (batch, n_in) @ (n_in, n_out) on the host."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, n_in)).astype(dtype)
    w = rng.standard_normal((n_in, n_out)).astype(dtype)
    x @ w  # warmup
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        x @ w
        best = min(best, time.perf_counter() - t0)
    return best


def measure_staging_copy(nbytes: int, *, iters: int = 3) -> float:
    """Wall-clock seconds to stage ``nbytes`` into a pre-allocated buffer.

    This is the 'pin' analogue on a TPU host: a memcpy into the DMA-able
    staging ring (DESIGN.md §2).
    """
    src = np.ones(nbytes, dtype=np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warmup
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return best


def calibrated_speeds(n_in: int = 4096, n_out: int = 4096,
                      *, link_bw: float | None = None) -> dict:
    """Measure this host's v_cpu / v_pin; take v_com from the hardware model.

    Returns a dict compatible with :func:`repro_torch.core.alpha.decide` kwargs.
    v_gpu/v_com come from the hardware spec (:data:`H100_HOST`).
    """
    from repro_torch.core.hw import H100_HOST

    nbytes = n_in * n_out * 4
    t_cpu = measure_host_linear(n_in, n_out)
    t_pin = measure_staging_copy(nbytes)
    return {
        "v_cpu": nbytes / max(t_cpu, 1e-9),
        "v_pin": nbytes / max(t_pin, 1e-9),
        "v_com": link_bw if link_bw is not None else H100_HOST.link_bw,
        "v_gpu": H100_HOST.accel_mem_bw,
    }


def probe_schedule(alpha0: float, gamma: float, lam: float) -> Sequence[float]:
    """The probe points the paper's benchmark visits (exposed for tests)."""
    lo = max(0.0, alpha0 - gamma)
    hi = min(1.0, alpha0 + gamma)
    n = max(3, int(round((hi - lo) / max(lam, 1e-6))) + 1)
    return list(np.linspace(lo, hi, n))


def analytic_prior(v_cpu: float, v_gpu: float, v_com: float,
                   v_pin: float | None = None) -> float:
    """Convenience: the Eq. 5/9 prior used as the center of the probe window."""
    if v_pin is not None and v_pin < v_com:
        return alpha_lib.alpha_analytic(v_cpu, v_gpu, v_pin)
    return alpha_lib.alpha_analytic(v_cpu, v_gpu, v_com)
