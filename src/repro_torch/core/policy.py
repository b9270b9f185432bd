"""Scheduler stage — turn a model's linear inventory into a placement plan.

Implements the paper's Fig. 4 scheduling pipeline:

    alpha benchmark  ->  per-module alpha        (§4.4, Eq. 9-12)
    value function   ->  residency promotion     (§4.5, Eq. 13)
    plan             ->  ModulePlan list for the runtime engine

The same planner feeds both the real threaded engine
(:mod:`repro_torch.core.engine`) and the simulator (:mod:`repro_torch.core.sim`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import alpha as alpha_lib
from repro_torch.core.engine import ModulePlan
from repro_torch.core.hw import HardwareSpec
from repro_torch.core.module_scheduler import ModuleInfo, SchedulePlan, schedule


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static description of one linear module in a model."""

    name: str
    n_in: int
    n_out: int
    group: str                  # "attn" | "mlp" | ... (pin-ring size group)
    dtype_bytes: int = 4
    calls: int = 1              # invocations per decode step (shared blocks)
    wire: str = "fp"            # streamed format: "fp" | "q8" (int8+scales)

    @property
    def nbytes(self) -> int:
        """Compute bytes: what the host GEMM and device matmul touch."""
        return self.n_in * self.n_out * self.dtype_bytes

    @property
    def wire_bytes(self) -> int:
        """Bytes that actually cross pin/DMA per full stream of the module.
        Distinct from :attr:`nbytes` when the wire format compresses —
        q8 moves an int8 payload plus one fp32 scale per output column."""
        if self.wire == "q8":
            return self.n_in * self.n_out + 4 * self.n_out
        return self.nbytes


@dataclasses.dataclass
class PolicyResult:
    plan: List[ModulePlan]
    alpha: float                       # resolved streaming alpha
    schedule: Optional[SchedulePlan]   # residency plan (None if no budget)
    predicted_step_time: float         # sum of per-module critical paths
    resident_bytes: int = 0            # accelerator bytes held by residents
    batch: int = 1                     # batch the plan was tuned for
    phase: str = "decode"              # "prefill" | "decode" (paper §4.1)
    tokens_per_seq: int = 1            # step tokens per sequence (prompt
    #                                    length for prefill, 1 for decode)
    wstream: str = "fp"                # wire format the plan was priced for

    @property
    def intensity(self) -> int:
        """FLOPs per parameter byte the plan was tuned for."""
        return self.batch * self.tokens_per_seq


def build_policy(
    linears: Sequence[LinearSpec],
    hw: HardwareSpec,
    *,
    budget_bytes: Optional[float] = None,
    batch: int = 1,
    phase: str = "decode",
    tokens_per_seq: Optional[int] = None,
    use_alpha_benchmark: bool = True,
    use_module_scheduler: bool = True,
    tile: int = 128,
) -> PolicyResult:
    """Resolve alpha + residency for a model's linears (paper Fig. 4).

    ``budget_bytes`` — accelerator memory available for weights (None means
    'only the streaming ring fits': fully offloaded operation).

    ``phase`` — the serving phase the plan targets (§4.1): decode steps run
    ~``batch`` FLOPs per weight byte (link/host bound, small alpha), while
    prefill runs ``batch * tokens_per_seq`` (compute bound, alpha -> 1).
    ``tokens_per_seq`` defaults to 1 for decode and
    :data:`repro_torch.core.alpha.DEFAULT_PREFILL_TOKENS` for prefill.
    """
    tokens_per_seq = alpha_lib.resolve_phase_tokens(phase, tokens_per_seq)
    batch = max(batch, 1)
    intensity = batch * tokens_per_seq  # FLOPs per weight byte this phase
    v_cpu = hw.v_cpu(intensity)
    v_gpu = hw.v_gpu(intensity)
    v_com = hw.v_com()
    v_pin = hw.v_pin()

    # == alpha_lib.alpha_for_batch(hw, batch), on the speeds computed above,
    # with the link derated/boosted by the wire format: compressed streaming
    # moves wire_bytes per nbytes of compute, so the link looks 1/r faster
    # (docs/ANALYSIS.md) and the equilibrium shifts toward the device.
    probe = max(linears, key=lambda s: s.nbytes)
    wire_ratio = probe.wire_bytes / probe.nbytes
    a0 = alpha_lib.alpha_analytic(
        v_cpu, v_gpu, alpha_lib.effective_link_speed(v_com, wire_ratio))
    a = a0
    if use_alpha_benchmark:
        from repro_torch.core.alpha_benchmark import refine_alpha

        def t_cpu_fn(x: float) -> float:
            # host share computes fp weights — compute bytes, not wire
            return (1.0 - x) * probe.nbytes / v_cpu

        def t_com_fn(x: float) -> float:
            # pin and DMA both move the wire format
            dev = x * probe.wire_bytes
            return max(dev / v_pin, dev / v_com)

        a = refine_alpha(t_cpu_fn, t_com_fn, a0).alpha

    # Residency promotion (Eq. 13).
    plan_map: Dict[str, str] = {s.name: "hetegen" for s in linears}
    sched = None
    if use_module_scheduler and budget_bytes is not None:
        infos = [ModuleInfo(name=s.name, mem_bytes=s.nbytes,
                            t_cpu=(1.0 - a) * s.nbytes / v_cpu,
                            calls=s.calls) for s in linears]
        # pin rings hold the wire format, so a compressed stream frees
        # budget for residency promotion
        ring = 2 * max((alpha_lib.quantize_alpha(a, s.n_out, tile)
                        * s.wire_bytes for s in linears), default=0.0)
        sched = schedule(infos, max(0.0, (budget_bytes or 0.0) - ring))
        for name in sched.resident:
            plan_map[name] = "resident"

    plan: List[ModulePlan] = []
    t_pred = 0.0
    resident_bytes = 0
    for s in linears:
        mode = plan_map[s.name]
        if mode == "resident":
            plan.append(ModulePlan(s.name, s.group, "resident"))
            t_pred += s.calls * s.nbytes / hw.accel_mem_bw
            resident_bytes += s.nbytes
        else:
            aq = alpha_lib.quantize_alpha(a, s.n_out, tile)
            plan.append(ModulePlan(s.name, s.group, "hetegen", aq))
            t_cpu = (1.0 - aq) * s.nbytes / v_cpu
            t_com = max(aq * s.wire_bytes / v_com,
                        aq * s.wire_bytes / v_pin)
            t_pred += s.calls * max(t_cpu, t_com)
    wstreams = {s.wire for s in linears}
    return PolicyResult(plan=plan, alpha=a, schedule=sched,
                        predicted_step_time=t_pred,
                        resident_bytes=resident_bytes,
                        batch=batch, phase=phase,
                        tokens_per_seq=tokens_per_seq,
                        wstream=("q8" if wstreams == {"q8"} else "fp"))
