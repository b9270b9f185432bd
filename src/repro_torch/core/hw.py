"""Hardware models for heterogeneous (accelerator + host + interconnect) systems.

HeteGen's distribution law (paper Eq. 4-9) is parameterized entirely by the
speeds of three resources:

  * the accelerator           (fast compute, small memory)
  * the host CPU              (slow compute, large memory)
  * the host<->device link    (the offloading bottleneck)

plus, for the *hybrid* strategy (paper Fig. 5c), the staging ("pin")
bandwidth, since communication is split into pin || transfer.

Three concrete systems are modeled:

  * ``PAPER_A10``  — the paper's evaluation rig (NVIDIA A10 + Intel Xeon
    @2.30GHz + PCIe 30 GB/s, Table 1).  Used by the paper-reproduction
    benchmarks so Fig. 8 / Table 2 / Table 3 are comparable to the paper.
  * ``TPU_V5E``    — the TPU-native target this framework is built for.
    Accelerator constants match the roofline constants used in
    EXPERIMENTS.md (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
  * ``H100_HOST``  — an NVIDIA H100 SXM on a PCIe host, the default of
    this package's offload backend.  Accelerator fields are data-sheet
    numbers; host and link fields were fitted on one such host from a
    traced serving run (another host differs: ``HeteGenBackend``'s
    ``recalibrate=`` adapts the plan to the host it runs on).

Decode-phase (batch≈1) linear layers are memory-bandwidth bound on every
resource, so "speed" for the alpha law is expressed in *parameter bytes per
second* — the same convention as the paper's Fig. 1 ("parameter size divided
by processing time").  For compute-bound phases (prefill / large batch) the
speeds are derated by an arithmetic-intensity-aware effective rate, computed
in :func:`effective_speeds`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Speeds/capacities of one heterogeneous node.

    All bandwidths are bytes/second, flops are FLOP/s, capacities bytes.
    """

    name: str
    # Accelerator ("GPU" in the paper).
    accel_flops: float              # dense matmul peak (bf16/fp16)
    accel_mem_bw: float             # HBM bandwidth
    accel_mem_bytes: float          # HBM capacity
    # Host ("CPU" in the paper).
    host_flops: float               # practical CPU GEMM peak
    host_mem_bw: float              # host DRAM bandwidth usable by GEMV
    host_mem_bytes: float           # host DRAM capacity
    # Interconnect.
    link_bw: float                  # host->device DMA (pinned/staged source)
    link_bw_unpinned: float         # host->device from pageable memory
    pin_bw: float                   # host memcpy into the staging/pinned ring
    # Multi-chip fabric (used by the roofline, not by the alpha law).
    ici_bw: Optional[float] = None  # per-link inter-chip interconnect
    dcn_bw: Optional[float] = None  # per-host data-center network

    # ----- speeds for the alpha law (bytes of parameters per second) -----

    def v_gpu(self, intensity: float = 1.0) -> float:
        """Accelerator speed in param-bytes/s at a given arithmetic intensity.

        ``intensity`` is FLOPs per parameter *byte* (2/bytes_per_param for
        batch-1 GEMV, scaled by batch for larger batches).  The device is
        memory-bound below the roofline ridge and compute-bound above it.
        """
        mem_rate = self.accel_mem_bw
        compute_rate = self.accel_flops / max(intensity, 1e-30)
        return min(mem_rate, compute_rate)

    def v_cpu(self, intensity: float = 1.0) -> float:
        mem_rate = self.host_mem_bw
        compute_rate = self.host_flops / max(intensity, 1e-30)
        return min(mem_rate, compute_rate)

    def v_com(self) -> float:
        return self.link_bw

    def v_pin(self) -> float:
        return self.pin_bw


def effective_speeds(hw: HardwareSpec, *, flops_per_byte: float
                     ) -> tuple[float, float, float, float]:
    """(v_cpu, v_gpu, v_com, v_pin) at a given arithmetic intensity.

    ``flops_per_byte`` — FLOPs executed per parameter byte moved/processed.
    Decode with batch b and 2-byte params has intensity b (2*b flops per
    2-byte weight element).
    """
    return (hw.v_cpu(flops_per_byte), hw.v_gpu(flops_per_byte),
            hw.v_com(), hw.v_pin())


# ---------------------------------------------------------------------------
# The paper's evaluation hardware (Table 1): A10 24GB + Xeon 2.30GHz + PCIe.
# CPU GEMV bandwidth ~6 channels DDR4-2933 derated; the paper caps CPU use at
# 16 cores.  pin_bw chosen so that T_pin/T_trans ~= 0.72/0.97 (Table 2).
# ---------------------------------------------------------------------------
PAPER_A10 = HardwareSpec(
    name="a10-xeon-pcie",
    accel_flops=125e12,            # A10 FP16 tensor-core dense
    accel_mem_bw=600e9,            # A10 HBM
    accel_mem_bytes=24e9,
    host_flops=1.2e12,             # 16 Xeon cores, AVX-512 fp32 GEMM
    host_mem_bw=120e9,             # measured-class DDR4 GEMV bandwidth
    host_mem_bytes=512e9,
    link_bw=30e9,                  # Table 1: PCIe 30 GB/s (pinned)
    link_bw_unpinned=9e9,          # pageable-source PCIe (what naive offload gets)
    pin_bw=40e9,                   # host memcpy into pinned ring
)

# ---------------------------------------------------------------------------
# TPU v5e host — the deployment target.  Roofline constants per the task
# sheet: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s per ICI link.  Host side:
# a v5e host exposes ~PCIe gen4-class DMA to its chips and a server-class
# DRAM subsystem.
# ---------------------------------------------------------------------------
TPU_V5E = HardwareSpec(
    name="tpu-v5e-host",
    accel_flops=197e12,
    accel_mem_bw=819e9,
    accel_mem_bytes=16e9,
    host_flops=2.0e12,
    host_mem_bw=150e9,
    host_mem_bytes=256e9,
    link_bw=32e9,
    link_bw_unpinned=10e9,
    pin_bw=45e9,
    ici_bw=50e9,
    dcn_bw=25e9,
)

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM host — the default of repro_torch's HeteGenBackend.
# Accelerator: NVIDIA data sheet (67 TFLOP/s fp32 without tensor cores —
# the engine streams fp32 weights — 3.35 TB/s HBM3, 80 GB).
# Host and link fields: fitted by chip_smoke.py (fit_host_spec) from the
# spans of one traced serving run of OPT-6.7B offloaded at full size
# (fp32 wire, fp32 pages, four requests, decode batch 4, prefill chunks
# of 18-32 rows, one pin thread per phase engine) on one "NVIDIA H100
# 80GB HBM3, 700.00 W" (nvidia-smi --query-gpu=name,power.limit) whose
# host reports 8 CPUs (nproc), Intel CPU family 6 model 207 with no model
# name (lscpu) and 108447924224 bytes of memory.  One host's speeds: a
# pin stream (a strided column view copied into the pinned ring) slower
# than the link, and an H2D link well below PCIe gen5's peak there.
# ---------------------------------------------------------------------------
H100_HOST = HardwareSpec(
    name="h100-host",
    accel_flops=67e12,
    accel_mem_bw=3.35e12,
    accel_mem_bytes=80e9,
    # host GEMM spans of the prefill chunks: sum(rows * bytes) / seconds,
    # the alpha law's units (intensity counted as rows per weight byte)
    host_flops=84.91e9,
    host_mem_bw=6.293e9,           # host GEMM spans at decode (4 rows)
    host_mem_bytes=108447924224,   # as the machine reports it
    link_bw=16.93e9,               # transfer spans (pinned H2D, copy stream)
    link_bw_unpinned=6.751e9,      # one timed pageable copy_ of 256 MB
    pin_bw=4.980e9,                # pin spans (host copy into pinned ring)
    ici_bw=450e9,                  # NVLink per direction (data sheet)
)

# Registry for CLI flags (--hw).
HARDWARE = {h.name: h for h in (PAPER_A10, TPU_V5E, H100_HOST)}
HARDWARE["a10"] = PAPER_A10
HARDWARE["v5e"] = TPU_V5E
HARDWARE["h100"] = H100_HOST
