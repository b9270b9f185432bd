"""Discrete-event simulator of heterogeneous offloaded decoding.

The port of the JAX package's ``core/sim.py``, pure Python over
:class:`repro_torch.core.hw.HardwareSpec`.  The paper's *performance*
results (Fig. 8 throughput curves, Table 2 stream-utilization breakdown,
Table 3 ablations) are reproduced under a simulated clock, and a fitted
host spec (``H100_HOST``) predicts a real run.  The simulator models the
four hardware streams HeteGen schedules:

    cpu    — host GEMM on the (1-alpha) share of each linear
    pin    — staging copies into the DMA-able ring ("pin memory")
    trans  — host->device DMA ("transfer")
    dev    — accelerator compute

with the true data dependencies of a transformer decode step:

  * activations are sequential: module i+1 cannot *compute* before module i
    finished (both its host and device halves);
  * weights are not: pinning/transfer for later modules may run arbitrarily
    far ahead, limited only by ring-buffer capacity (the asynchronous
    parameter manager, paper §4.3) and a device-side prefetch window;
  * the hybrid strategy (paper Fig. 5c) runs pin || transfer on separate
    streams; the non-hybrid variant (Fig. 5b) lets pinning block both the
    link and the host ("pinning memory blocks both communication and CPU
    computation").

Strategies simulated (see DESIGN.md §1 and benchmarks/):

    resident            everything in accelerator memory (no offload)
    naive_offload       Accelerate/DeepSpeed-style: stream everything from
                        pageable memory, no overlap, no host compute
    sync_offload        FlexGen-style: pinned transfers overlapped with the
                        previous module's device compute; attention on CPU;
                        no weight-split host compute
    hetegen_basic       Fig. 5a: alpha-split, unpinned async transfer
    hetegen_pinned      Fig. 5b: + pinning, but pin blocks cpu & link
    hetegen             Fig. 5c: hybrid pin||transfer + async manager

The same module schedule drives the real threaded engine
(:mod:`repro_torch.core.engine`); the simulator only supplies the clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.hw import HardwareSpec
from repro_torch.core import alpha as alpha_lib


# ---------------------------------------------------------------------------
# Workload description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimModule:
    """One schedulable module of the decode step."""

    name: str
    kind: str                 # "linear" | "attn_core" | "small"
    nbytes: int               # weight bytes (0 for attn_core)
    n_out: int                # output columns (alpha tile quantization)
    group: str                # async-manager size group ("attn" | "mlp" | ...)
    flops: float              # FLOPs for this module at the sim batch size
    cache_bytes: int = 0      # KV-cache bytes touched (attn_core only)
    calls: int = 1            # invocations per step (e.g. shared blocks)
    wire_bytes: Optional[int] = None   # streamed-format bytes; None => fp

    @property
    def link_bytes(self) -> int:
        """Bytes the full module would move across pin/DMA (wire format)."""
        return self.nbytes if self.wire_bytes is None else self.wire_bytes


@dataclasses.dataclass
class Placement:
    """Resolved policy for one module."""

    mode: str                 # "resident" | "hetegen" | "stream"
    alpha: float = 1.0        # device fraction (hetegen); 1.0 for stream


@dataclasses.dataclass
class SimResult:
    step_time: float                        # seconds per decode step
    busy: Dict[str, float]                  # per-stream busy seconds
    utilization: Dict[str, float]           # busy / step_time
    tokens_per_s: float
    device_bytes: float                     # resident + peak streamed bytes
    timeline: List[tuple]                   # (stream, start, end, module)

    def throughput(self, batch: int) -> float:
        return batch * self.tokens_per_s


# ---------------------------------------------------------------------------
# Core event loop
# ---------------------------------------------------------------------------

_STREAMS = ("cpu", "pin", "trans", "dev")


class _Clock:
    def __init__(self):
        self.free = {s: 0.0 for s in _STREAMS}
        self.busy = {s: 0.0 for s in _STREAMS}
        self.timeline: List[tuple] = []

    def run(self, stream: str, earliest: float, dur: float, tag: str) -> float:
        """Schedule ``dur`` seconds on ``stream`` no earlier than ``earliest``."""
        if dur <= 0:
            return max(earliest, self.free[stream])
        start = max(earliest, self.free[stream])
        end = start + dur
        self.free[stream] = end
        self.busy[stream] += dur
        self.timeline.append((stream, start, end, tag))
        return end


def _device_time(m: SimModule, hw: HardwareSpec, frac: float,
                 batch: int, mem_bytes: Optional[int] = None) -> float:
    """Device time for ``frac`` of module ``m`` (roofline of HBM vs MXU).

    ``mem_bytes`` overrides the weight bytes the memory term reads — a
    streamed q8 share holds (and re-reads) only the wire-format payload.
    """
    wb = m.nbytes if mem_bytes is None else mem_bytes
    t_mem = frac * (wb + m.cache_bytes) / hw.accel_mem_bw
    t_flops = frac * m.flops / hw.accel_flops
    return max(t_mem, t_flops)


def _host_time(m: SimModule, hw: HardwareSpec, frac: float) -> float:
    t_mem = frac * (m.nbytes + m.cache_bytes) / hw.host_mem_bw
    t_flops = frac * m.flops / hw.host_flops
    return max(t_mem, t_flops)


def simulate_step(
    modules: Sequence[SimModule],
    placements: Dict[str, Placement],
    hw: HardwareSpec,
    *,
    batch: int = 1,
    hybrid_comm: bool = True,
    async_manager: bool = True,
    prefetch_window: int = 2,
    pinned: bool = True,
    prepinned: bool = False,
) -> SimResult:
    """Simulate one decode step.

    ``hybrid_comm=False`` reproduces Fig. 5b (pinning blocks cpu+link).
    ``async_manager=False`` pins each module just-in-time, serializing
    pin -> transfer on the critical path (no cross-module prefetch).
    ``pinned=False`` transfers from pageable memory (Fig. 5a / naive).
    """
    clock = _Clock()
    ready = 0.0                        # when the previous module's output exists
    module_done: List[float] = []      # completion time per module index
    trans_done: Dict[int, float] = {}  # per-index transfer completion
    pin_done: Dict[int, float] = {}
    # ring-buffer state per group: completion time at which the slot frees
    ring_free: Dict[str, List[float]] = {}
    group_seq: Dict[str, int] = {}     # per-group streamed-module counter

    link_bw = hw.link_bw if pinned else hw.link_bw_unpinned
    device_bytes = 0.0
    peak_stream_bytes = 0.0

    mods = list(modules)
    for i, m in enumerate(mods):
        pl = placements.get(m.name, Placement("resident"))
        for _ in range(m.calls):
            if pl.mode == "resident" or m.kind in ("small",):
                t = _device_time(m, hw, 1.0, batch)
                end = clock.run("dev", ready, t, m.name)
                ready = end
                if m.kind == "linear":
                    device_bytes += m.nbytes
                continue

            if m.kind == "attn_core":
                # FlexGen-style strategies compute attention on the host to
                # avoid shipping the KV cache; hetegen keeps it on device.
                if pl.mode == "stream" and pl.alpha >= 1.0:
                    t = _host_time(m, hw, 1.0)
                    end = clock.run("cpu", ready, t, m.name)
                else:
                    t = _device_time(m, hw, 1.0, batch)
                    end = clock.run("dev", ready, t, m.name)
                ready = end
                continue

            # --- streamed / heterogeneous linear ---
            a = 1.0 if pl.mode == "stream" else pl.alpha
            a = alpha_lib.quantize_alpha(a, m.n_out)
            # bytes that cross pin/DMA: the wire format (compressed when
            # wire_bytes < nbytes); host compute still sees fp bytes
            dev_bytes = a * m.link_bytes
            peak_stream_bytes = max(peak_stream_bytes, dev_bytes)

            # pin stage
            seq = group_seq.get(m.group, 0)
            group_seq[m.group] = seq + 1
            if prepinned:
                # FlexGen-style: weights pinned once at load time (costs a
                # full extra copy of the weights in host RAM — the paper's
                # dynamic-range critique); no per-step pin stage
                pin_done[i] = 0.0
            elif pinned and dev_bytes > 0:
                t_pin = dev_bytes / hw.pin_bw
                if not hybrid_comm:
                    # Fig. 5b: pinning blocks both host compute and the link.
                    start = max(ready, clock.free["cpu"], clock.free["trans"])
                    end_pin = clock.run("pin", start, t_pin, m.name + "/pin")
                    clock.free["cpu"] = max(clock.free["cpu"], end_pin)
                    clock.free["trans"] = max(clock.free["trans"], end_pin)
                    pin_done[i] = end_pin
                elif async_manager:
                    # paper §4.3: the ring holds <=1 spare pinned buffer per
                    # group; pin of the group's seq-th module waits on the
                    # slot freed by the transfer of the (seq-2)-th.
                    ring = ring_free.setdefault(m.group, [0.0, 0.0])
                    slot_free = ring[seq % 2]
                    end_pin = clock.run("pin", slot_free, t_pin,
                                        m.name + "/pin")
                    pin_done[i] = end_pin
                else:
                    # just-in-time pinning: cannot start before the module is
                    # reached (no prefetch) — serializes pin -> transfer.
                    end_pin = clock.run("pin", ready, t_pin, m.name + "/pin")
                    pin_done[i] = end_pin
            else:
                pin_done[i] = 0.0

            # transfer stage (weights have no activation dependency; may run
            # ahead, limited by the device-side prefetch window)
            if dev_bytes > 0:
                t_trans = dev_bytes / link_bw
                window_gate = 0.0
                j = i - prefetch_window
                if j >= 0 and j < len(module_done):
                    window_gate = module_done[j]
                start = max(pin_done[i], window_gate)
                end_trans = clock.run("trans", start, t_trans,
                                      m.name + "/trans")
                trans_done[i] = end_trans
                if async_manager and hybrid_comm and pinned:
                    ring = ring_free.setdefault(m.group, [0.0, 0.0])
                    ring[seq % 2] = end_trans
            else:
                trans_done[i] = 0.0

            # host share
            cpu_end = ready
            if a < 1.0:
                t_cpu = _host_time(m, hw, 1.0 - a)
                cpu_end = clock.run("cpu", ready, t_cpu, m.name + "/cpu")

            # device share
            dev_end = ready
            if a > 0.0:
                t_dev = _device_time(m, hw, a, batch,
                                     mem_bytes=m.link_bytes)
                dev_end = clock.run("dev", max(ready, trans_done[i]), t_dev,
                                    m.name + "/dev")

            ready = max(cpu_end, dev_end)
        module_done.append(ready)

    step_time = ready if ready > 0 else 1e-12
    util = {s: clock.busy[s] / step_time for s in _STREAMS}
    return SimResult(
        step_time=step_time,
        busy=dict(clock.busy),
        utilization=util,
        tokens_per_s=1.0 / step_time,
        device_bytes=device_bytes + peak_stream_bytes * 2,  # double buffer
        timeline=clock.timeline,
    )


# ---------------------------------------------------------------------------
# Strategy frontends
# ---------------------------------------------------------------------------

def make_placements(
    modules: Sequence[SimModule],
    strategy: str,
    hw: HardwareSpec,
    *,
    gpu_mem_budget: Optional[float] = None,
    use_alpha_benchmark: bool = True,
    use_module_scheduler: bool = True,
    alpha_bias: float = 0.25,
    batch: int = 1,
) -> Dict[str, Placement]:
    """Resolve per-module placements for a named strategy.

    ``alpha_bias`` models the error of skipping the alpha benchmark (paper
    §4.4 / Table 3 row 'no alpha benchmark'): the analytic prior is computed
    from a host speed misestimated by +bias.
    """
    from repro_torch.core.module_scheduler import ModuleInfo, schedule

    placements: Dict[str, Placement] = {}
    if strategy == "resident":
        for m in modules:
            placements[m.name] = Placement("resident")
        return placements

    if strategy in ("naive_offload", "sync_offload"):
        # FlexGen-style percentage placement: first weights up to the
        # budget live on the accelerator, the rest stream (no gain
        # ranking, no split — that is HeteGen's contribution)
        budget = gpu_mem_budget or 0.0
        used = 0.0
        for m in modules:
            if m.kind == "linear":
                if strategy == "sync_offload" and \
                        used + m.nbytes <= budget:
                    placements[m.name] = Placement("resident")
                    used += m.nbytes
                else:
                    placements[m.name] = Placement("stream", 1.0)
            elif m.kind == "attn_core" and strategy == "sync_offload":
                placements[m.name] = Placement("stream", 1.0)  # attn on CPU
            else:
                placements[m.name] = Placement("resident")
        return placements

    if not strategy.startswith("hetegen"):
        raise ValueError(f"unknown strategy {strategy!r}")

    # intensity: decode GEMV does ~batch FLOPs per weight byte (bf16)
    intensity = max(batch, 1)
    v_cpu = hw.v_cpu(intensity)
    v_gpu = hw.v_gpu(intensity)
    v_com = hw.v_com()
    if not use_alpha_benchmark:
        v_cpu = v_cpu * (1.0 + alpha_bias)  # misestimated prior
    linears = [m for m in modules if m.kind == "linear"]
    wire_ratio = 1.0
    if linears:
        big = max(linears, key=lambda m: m.nbytes)
        if big.nbytes > 0:
            wire_ratio = big.link_bytes / big.nbytes
    a = alpha_lib.alpha_analytic(
        v_cpu, v_gpu, alpha_lib.effective_link_speed(v_com, wire_ratio))

    if use_alpha_benchmark:
        # refine against end-to-end simulated step time (the paper probes
        # alpha0 +- gamma against real measurements — the sim IS our
        # measurement here), so the refined alpha is never worse than the
        # analytic prior at the probed granularity
        from repro_torch.core.alpha_benchmark import probe_schedule

        def step_time_at(alpha):
            pl = {m.name: (Placement("hetegen", alpha)
                           if m.kind == "linear" else Placement("resident"))
                  for m in modules}
            return simulate_step(modules, pl, hw, batch=batch).step_time

        probes = list(probe_schedule(a, gamma=0.08, lam=0.02)) + [a]
        a = min(probes, key=step_time_at)

    for m in modules:
        if m.kind == "linear":
            placements[m.name] = Placement("hetegen", a)
        else:
            placements[m.name] = Placement("resident")

    # module scheduler: promote high-gain modules to residency (paper §4.5)
    if use_module_scheduler and gpu_mem_budget is not None:
        infos = [ModuleInfo(name=m.name, mem_bytes=m.nbytes,
                            t_cpu=_host_time(m, hw, 1.0), calls=m.calls)
                 for m in modules if m.kind == "linear"]
        # budget available for promotions = budget minus streaming buffers
        # (sized to the wire format actually staged)
        stream_buf = 2 * max((a * m.link_bytes for m in modules
                              if m.kind == "linear"), default=0)
        plan = schedule(infos, max(0.0, gpu_mem_budget - stream_buf))
        for name in plan.resident:
            placements[name] = Placement("resident")
    return placements


def run_strategy(
    modules: Sequence[SimModule],
    strategy: str,
    hw: HardwareSpec,
    *,
    batch: int = 1,
    gpu_mem_budget: Optional[float] = None,
    **toggles,
) -> SimResult:
    """Resolve placements for ``strategy`` and simulate one decode step."""
    sim_kw = {}
    if strategy == "naive_offload":
        sim_kw = dict(pinned=False, async_manager=False, hybrid_comm=False,
                      prefetch_window=0)
    elif strategy == "sync_offload":
        sim_kw = dict(pinned=True, async_manager=False, hybrid_comm=False,
                      prefetch_window=2, prepinned=True)
    elif strategy == "hetegen_basic":      # Fig. 5a
        sim_kw = dict(pinned=False, async_manager=False, hybrid_comm=True)
    elif strategy == "hetegen_pinned":     # Fig. 5b
        sim_kw = dict(pinned=True, hybrid_comm=False)
    elif strategy in ("hetegen", "resident"):
        sim_kw = dict(pinned=True, hybrid_comm=True, async_manager=True)
    for k in ("hybrid_comm", "async_manager", "pinned", "prefetch_window"):
        if k in toggles:
            sim_kw[k] = toggles.pop(k)
    placements = make_placements(modules, strategy, hw, batch=batch,
                                 gpu_mem_budget=gpu_mem_budget, **toggles)
    return simulate_step(modules, placements, hw, batch=batch, **sim_kw)
