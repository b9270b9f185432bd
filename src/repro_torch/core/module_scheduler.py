"""Heterogeneous module scheduler (paper §4.5, Eq. 13).

When accelerator memory is not exhausted by the minimal streaming buffers,
whole modules are promoted to *resident* accelerator memory, removing their
host-compute and link cost entirely.  The paper ranks candidates by the gain

    g = T̄_cpu / Mem        (time saved per byte of accelerator memory)

and promotes greedily until the memory budget is reached.  Modules invoked
multiple times per step (e.g. zamba2's shared attention block) save
``calls * T̄_cpu``, which the gain reflects — reuse makes residency more
valuable (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass(frozen=True)
class ModuleInfo:
    name: str
    mem_bytes: float            # accelerator bytes if promoted
    t_cpu: float                # benchmarked host time per invocation (T̄_cpu)
    calls: int = 1              # invocations per step

    @property
    def gain(self) -> float:
        """Paper Eq. 13 (scaled by per-step reuse)."""
        if self.mem_bytes <= 0:
            return float("inf")
        return (self.t_cpu * self.calls) / self.mem_bytes


@dataclasses.dataclass
class SchedulePlan:
    resident: List[str]
    offloaded: List[str]
    used_bytes: float
    budget_bytes: float
    time_saved: float

    @property
    def resident_fraction(self) -> float:
        total = self.used_bytes + sum(0 for _ in ())  # placeholder for mypy
        return 0.0 if self.budget_bytes <= 0 else self.used_bytes / self.budget_bytes


def schedule(modules: Sequence[ModuleInfo], budget_bytes: float
             ) -> SchedulePlan:
    """Greedy promotion by descending gain g until the budget is exhausted.

    Deterministic: ties broken by (name) for reproducibility.  A module is
    skipped (not promoted) if it alone exceeds the remaining budget; later,
    smaller modules may still fit — this matches the paper's per-layer
    migration loop and gives the wide dynamic range of Fig. 8.
    """
    ranked = sorted(modules, key=lambda m: (-m.gain, m.name))
    resident: List[str] = []
    offloaded: List[str] = []
    used = 0.0
    saved = 0.0
    for m in ranked:
        if m.mem_bytes <= budget_bytes - used:
            resident.append(m.name)
            used += m.mem_bytes
            saved += m.t_cpu * m.calls
        else:
            offloaded.append(m.name)
    return SchedulePlan(resident=resident, offloaded=offloaded,
                        used_bytes=used, budget_bytes=budget_bytes,
                        time_saved=saved)


def dynamic_range(modules: Sequence[ModuleInfo], *, overhead_bytes: float,
                  total_bytes: float | None = None) -> Dict[str, float]:
    """Min/max accelerator-memory operating points (cf. paper §5.1).

    min — nothing resident, only streaming buffers + non-linear modules
          (``overhead_bytes``);
    max — everything resident.
    Returned as fractions of ``total_bytes`` (defaults to sum of modules +
    overhead), comparable to the paper's '6.5% .. 88.7%' span for OPT-30B.
    """
    weights = sum(m.mem_bytes for m in modules)
    total = total_bytes if total_bytes is not None else weights + overhead_bytes
    return {
        "min_fraction": overhead_bytes / total,
        "max_fraction": (weights + overhead_bytes) / total,
    }
