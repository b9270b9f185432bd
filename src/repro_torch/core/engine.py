"""HeteGen runtime engine — threaded hybrid heterogeneous parallelism (§4.2).

Executes the linear modules of a model under a per-module placement plan:

    resident  — weights live in device memory; plain device matmul.
    hetegen   — weights live in host memory; the output dimension is split
                at a tile-aligned column ``alpha``-fraction: the device part
                is staged (pin) || copied to the card || the host part is
                computed by a host GEMM thread, all concurrently; results
                are concatenated (exact — column blocks of a matmul are
                independent).
    stream    — alpha = 1: pure weight streaming (FlexGen-style baseline).
    host      — alpha = 0: pure host compute (CPU-only baseline).

``wstream`` picks the wire format of the streamed device shards:

    "fp"      — stream the shard as-is (full precision).
    "q8"      — quantize each shard once at load to int8 + fp32 per-column
                scales (:func:`repro_torch.kernels.q8_matmul.quantize_weights_np`)
                and stream the ``(q, scale)`` pair; the device share runs
                the hand-written ``q8_matmul`` kernel, dequantizing inside
                the matmul.  The host partition keeps its fp weights.

Four executors provide the four streams of the paper's Fig. 5c: the host
GEMM thread (numpy), the manager's pin thread, the transfer thread (which
issues ``non_blocking`` copies from the pinned slot on a dedicated CUDA
copy stream and records an event), and the device queue (the caller's
current CUDA stream, which waits on that event).  The partitions are
column *views* of the host weights: the host GEMM reads its columns in
place and the pin thread stages the device columns straight into the
pinned slot, so the engine holds no second copy of an fp weight.

Ring-slot release: a slot is released only after its host-to-device copy
has completed (the transfer thread synchronizes on the copy's event, where
it also takes the transfer time); the copied tensors are
``record_stream``-ed on the compute stream, which ``wait_event``-s on the
copy.  On the CPU (``device="cpu"``) the "copy" is a ``clone`` of the
slot, so the same release rule holds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import alpha as alpha_lib
from repro_torch.core.param_manager import (AsyncParamManager, Entry,
                                            Staged, plan_prefetch_order)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.q8_matmul import quantize_weights_np
from repro_torch.telemetry.tracer import NULL_TRACER, Tracer


@dataclasses.dataclass(frozen=True)
class ModulePlan:
    name: str
    group: str                 # size group for the pinned ring ("attn"/"mlp")
    mode: str                  # "resident" | "hetegen" | "stream" | "host"
    alpha: float = 1.0         # device fraction for hetegen


@dataclasses.dataclass
class StreamStats:
    cpu: float = 0.0           # host GEMM seconds
    pin: float = 0.0           # staging seconds
    trans: float = 0.0         # host->device transfer seconds
    dev: float = 0.0           # device matmul seconds
    wall: float = 0.0          # end-to-end engine-active seconds

    def utilization(self) -> Dict[str, float]:
        w = max(self.wall, 1e-12)
        return {"cpu": self.cpu / w, "pin": self.pin / w,
                "trans": self.trans / w, "dev": self.dev / w}

    def __add__(self, other: "StreamStats") -> "StreamStats":
        """Aggregate busy seconds across engines; wall takes the max (the
        engines share one serving timeline)."""
        return StreamStats(cpu=self.cpu + other.cpu,
                           pin=self.pin + other.pin,
                           trans=self.trans + other.trans,
                           dev=self.dev + other.dev,
                           wall=max(self.wall, other.wall))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class HeteGenEngine:
    """Executes named linears under a placement plan with async overlap."""

    def __init__(self, weights: Dict[str, np.ndarray],
                 plan: Sequence[ModulePlan], *,
                 biases: Optional[Dict[str, np.ndarray]] = None,
                 tile: int = 128,
                 device=None,
                 resident_store: Optional[Dict[str, torch.Tensor]] = None,
                 tracer: Tracer = NULL_TRACER,
                 trace_phase: Optional[str] = None,
                 wstream: str = "fp"):
        if wstream not in ("fp", "q8"):
            raise ValueError(f"unknown wire format {wstream!r} "
                             "(expected 'fp' or 'q8')")
        self.device = resolve_device(device)
        self.plan = {p.name: p for p in plan}
        self.order = [p.name for p in plan]
        self.tile = tile
        self.biases = {k: torch.as_tensor(v).to(self.device)
                       for k, v in (biases or {}).items()}
        self.stats = StreamStats()
        self._lock = threading.Lock()
        self.tracer = tracer
        self.trace_phase = trace_phase
        self.wstream = wstream

        # Partition every weight once, ahead of time.  ``resident_store``
        # lets a phase-aware backend run several engines without holding
        # duplicate device copies of modules both plans keep resident.
        self._resident: Dict[str, torch.Tensor] = {}
        self._host_part: Dict[str, np.ndarray] = {}
        self._dev_cols: Dict[str, int] = {}
        self._fp_shard_bytes: Dict[str, int] = {}
        stage_src: Dict[str, Entry] = {}
        groups: Dict[str, str] = {}
        for p in plan:
            w = weights[p.name]
            if p.mode == "resident":
                if resident_store is not None and p.name in resident_store:
                    self._resident[p.name] = resident_store[p.name]
                else:
                    self._resident[p.name] = \
                        torch.from_numpy(np.ascontiguousarray(w)) \
                        .to(self.device)
                    if resident_store is not None:
                        resident_store[p.name] = self._resident[p.name]
                continue
            if p.mode == "host":
                self._host_part[p.name] = w
                self._dev_cols[p.name] = 0
                continue
            a = 1.0 if p.mode == "stream" else p.alpha
            cols = alpha_lib.split_columns(a, w.shape[-1], tile)
            self._dev_cols[p.name] = cols
            if cols > 0:
                shard = w[..., :cols]             # a view, staged in place
                self._fp_shard_bytes[p.name] = shard.nbytes
                if wstream == "q8" and shard.ndim == 2:
                    stage_src[p.name] = quantize_weights_np(shard)
                else:
                    stage_src[p.name] = shard
                groups[p.name] = p.group
            if cols < w.shape[-1]:
                self._host_part[p.name] = w[..., cols:]

        self.manager = (AsyncParamManager(stage_src, groups,
                                          pinned=self.device.type == "cuda",
                                          tracer=tracer,
                                          trace_phase=trace_phase,
                                          fp_bytes=self._fp_shard_bytes)
                        if stage_src else None)
        self._next_in_group = plan_prefetch_order(
            [n for n in self.order if n in stage_src], groups)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._cpu_pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="hostgemm")
        self._trans_pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="transfer")
        if self.device.type == "cuda":
            # fp32 device shares must match the fp32 host shares
            torch.backends.cuda.matmul.allow_tf32 = False
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------------
    def warm_prefetch(self) -> None:
        """Stage the first module of each group before the step begins."""
        if self.manager is None:
            return
        seen = set()
        for name in self.order:
            p = self.plan[name]
            if self._dev_cols.get(name, 0) > 0 \
                    and p.mode in ("hetegen", "stream"):
                if p.group not in seen:
                    self.manager.prefetch(name)
                    seen.add(p.group)

    def _host_matmul(self, x_np: np.ndarray, name: str) -> np.ndarray:
        """The host share's product.  numpy runs a 3-D ``x @ w`` as one
        product per leading index, each reading the whole share, so an
        input of several tokens per row (a verify step, a batched
        admission) is multiplied as one (rows, K) product; one-token rows
        (decode) keep the 3-D call (``tools/host_gemm_shapes.py`` times
        both)."""
        w = self._host_part[name]
        x2 = x_np.reshape(-1, x_np.shape[-1]) \
            if x_np.ndim > 2 and x_np.shape[-2] > 1 else x_np
        with self.tracer.span(name, track="cpu_gemm", bytes=w.nbytes,
                              rows=x_np.size // x_np.shape[-1],
                              module=name, phase=self.trace_phase):
            t0 = time.perf_counter()
            y = x2 @ w
            with self._lock:
                self.stats.cpu += time.perf_counter() - t0
        return y.reshape(x_np.shape[:-1] + (y.shape[-1],))

    def _transfer(self, staged: Staged, name: str, seq: Optional[int]):
        """Copy a staged slot to the device (transfer thread).  Returns the
        device tensors and the copy's event; the slot may be re-staged as
        soon as this returns."""
        parts = staged if isinstance(staged, tuple) else (staged,)
        wire = sum(p.numel() * p.element_size() for p in parts)
        attrs = dict(bytes=wire, module=name, phase=self.trace_phase)
        if seq is not None:
            attrs["seq"] = seq
        fp = self._fp_shard_bytes.get(name)
        if fp is not None:
            attrs["fp_bytes"] = fp
        event = None
        with self.tracer.span(name, track="transfer", **attrs):
            t0 = time.perf_counter()
            if self._copy_stream is None:
                arrs = tuple(p.clone() for p in parts)
            else:
                with torch.cuda.stream(self._copy_stream):
                    arrs = tuple(p.to(self.device, non_blocking=True)
                                 for p in parts)
                    event = torch.cuda.Event()
                    event.record(self._copy_stream)
                # the copy must finish before its slot is released; the
                # wait runs here, on the transfer thread, and is the
                # transfer-time measurement (it feeds the alpha law)
                event.synchronize()
            with self._lock:
                self.stats.trans += time.perf_counter() - t0
        return (arrs if isinstance(staged, tuple) else arrs[0]), event

    def _device_matmul(self, x: torch.Tensor, w) -> torch.Tensor:
        if isinstance(w, tuple):              # q8 wire: (int8 q, scale)
            q, s = w
            y = kernel_ops.q8_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                                     q, s)
            return y.reshape(x.shape[:-1] + (q.shape[-1],))
        return torch.matmul(x, w)

    # ------------------------------------------------------------------
    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """y = x @ W[name] (+ bias), executed per the placement plan."""
        p = self.plan[name]
        if p.mode == "resident":
            with self.tracer.span(name, track="device", module=name,
                                  phase=self.trace_phase):
                t0 = time.perf_counter()
                y = torch.matmul(x, self._resident[name])
                _sync(self.device)            # dev busy-seconds
                with self._lock:
                    self.stats.dev += time.perf_counter() - t0
        else:
            cols = self._dev_cols[name]
            has_host = name in self._host_part

            # 1. stage-ahead: kick the pin of the next same-group module
            if self.manager is not None and cols > 0:
                nxt = self._next_in_group.get(name)
                if nxt is not None:
                    self.manager.prefetch(nxt)

            # 2. host share on the GEMM thread (x moves device->host first,
            #    as in the paper: "transmitting activation from the GPU")
            host_fut = None
            if has_host:
                x_np = x.detach().to("cpu").numpy()
                host_fut = self._cpu_pool.submit(self._host_matmul, x_np,
                                                 name)

            # 3. device share: acquire the staged slot, copy, release once
            #    the copy completed, then matmul on the compute stream
            y_dev = None
            if cols > 0:
                staged = self.manager.acquire(name)
                seq = self.manager.seq_of(name)
                w_fut = self._trans_pool.submit(self._transfer, staged,
                                                name, seq)
                w_dev, event = w_fut.result()
                self.manager.release(name)
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for t in (w_dev if isinstance(w_dev, tuple)
                              else (w_dev,)):
                        t.record_stream(stream)
                with self.tracer.span(name, track="device", module=name,
                                      phase=self.trace_phase, seq=seq):
                    t0 = time.perf_counter()
                    y_dev = self._device_matmul(x, w_dev)
                    _sync(self.device)        # dev busy-seconds
                    with self._lock:
                        self.stats.dev += time.perf_counter() - t0

            # 4. combine
            if y_dev is None:
                y = torch.from_numpy(host_fut.result()).to(self.device)
            elif host_fut is None:
                y = y_dev
            else:
                y_host = torch.from_numpy(host_fut.result()).to(self.device)
                y = torch.cat([y_dev, y_host], dim=-1)

        if name in self.biases:
            y = y + self.biases[name]
        return y

    # ------------------------------------------------------------------
    def set_tracer(self, tracer: Tracer,
                   trace_phase: Optional[str] = None) -> None:
        self.tracer = tracer
        if trace_phase is not None:
            self.trace_phase = trace_phase
        if self.manager is not None:
            self.manager.tracer = tracer
            self.manager.trace_phase = self.trace_phase

    def finish_stats(self) -> StreamStats:
        with self._lock:
            self.stats.wall = time.perf_counter() - self._t_start
            if self.manager is not None:
                self.stats.pin = self.manager.pin_seconds
            return self.stats

    def reset_stats(self) -> None:
        with self._lock:
            self.stats = StreamStats()
            self._t_start = time.perf_counter()
        if self.manager is not None:
            self.manager.reset_pin_seconds()

    def device_resident_bytes(self) -> int:
        return sum(w.numel() * w.element_size()
                   for w in self._resident.values())

    def pinned_overhead_bytes(self) -> int:
        return 0 if self.manager is None \
            else self.manager.pinned_overhead_bytes()

    def close(self) -> None:
        """Shut the pools down (their queued work finishes first) and
        drain the copy stream, so no ring slot is left with a copy in
        flight when the engine is dropped or replaced."""
        self._cpu_pool.shutdown(wait=True)
        self._trans_pool.shutdown(wait=True)
        if self.manager is not None:
            self.manager.shutdown()
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
