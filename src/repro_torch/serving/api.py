"""The request-level serving front door.

:class:`LLM` is the port of the JAX package's facade, over the continuous
batcher (:class:`repro_torch.serving.batcher.ContinuousBatcher`)::

    be = HeteGenBackend(cfg, params)                    # offloaded, on cuda
    with LLM(cfg, backend=be, own_backend=True, paged=True) as llm:
        rid = llm.submit(prompt, max_new=16)
        outs = llm.drain()                              # {rid: RequestOutput}

Requests are the unit: each carries its prompt, budget, stop token and
:class:`repro_torch.serving.sampling.SamplingParams` (greedy, temperature,
top-k or top-p, with its own random stream and, when asked for, per-token
logprobs in :class:`RequestOutput`).  ``backend=None``
serves resident weights from ``params``: the batcher through
:class:`repro_torch.serving.backends.ResidentBackend`, the one-shot
generator through the stacked whole model.  Scheduling knobs (``policy``,
``optimistic``, ``preempt_mode``, ``chunk_tokens``, ``prefix_dedupe``)
are facade-level, as in the JAX package.

``generate`` picks the executor as the JAX facade does: a rectangular
batch (one prompt length, one budget, no logprobs) with nothing else in
flight runs one-shot on :class:`repro_torch.serving.engine.Generator`
(``last_executor == "generator"``); anything else runs through the
batcher.  Sampling draws from request-owned random streams (keyed by the
facade's ``seed`` and the request id, or the request's own seed, and its
token count, never its batch row), so both give the same tokens.

``trace=True`` (or a :class:`repro_torch.telemetry.tracer.Tracer`)
records zero-sync spans across the batcher, the scheduler and an offload
backend's four streams; :meth:`LLM.write_trace` exports them as Chrome
trace JSON, :meth:`LLM.overlap_report` computes the I/O-hidden fraction,
stream utilization and critical path (paper Fig. 5c), and
:meth:`LLM.metrics` flattens every serving counter into one snapshot.

Not ported yet: speculative decoding (``spec=``) and tokenizers, which
raise when asked for, and the streaming front ends (``LLM.stream``,
``LLM.stream_text``, per-token callbacks, ``AsyncLLM``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import Generator
from repro_torch.serving.sampling import (SamplingParams, request_key,
                                          seed_key)
from repro_torch.serving.scheduler import SchedulerPolicy
from repro_torch.telemetry.export import write_chrome_trace
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.overlap import OverlapReport, compute_overlap
from repro_torch.telemetry.tracer import Tracer, as_tracer

Prompt = Sequence[int]


@dataclasses.dataclass
class GenRequest:
    """One generation request, fully self-describing."""

    prompt: List[int]
    max_new: int
    eos: Optional[int] = None
    sampling: SamplingParams = SamplingParams()
    rid: Optional[int] = None                        # assigned by the LLM
    priority: int = 0


@dataclasses.dataclass
class RequestOutput:
    """What a finished request produced."""

    rid: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str          # "length" | "eos"
    # one entry per token when SamplingParams.logprobs was set:
    # {"token": id, "logprob": float, "top": {id: logprob, ...}}
    logprobs: Optional[List[Dict]] = None


def _finish_reason(tokens: List[int], eos: Optional[int]) -> str:
    return "eos" if (eos is not None and tokens and tokens[-1] == eos) \
        else "length"


class LLM:
    """Request-level serving facade over the continuous batcher."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 backend=None, own_backend: Optional[bool] = None,
                 sampling: SamplingParams = SamplingParams(),
                 max_slots: int = 4, max_len: int = 512,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 retune_hysteresis: Optional[int] = None,
                 policy: Union[str, SchedulerPolicy, None] = "fcfs",
                 optimistic: bool = True,
                 preempt_mode: Optional[str] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_dedupe: Optional[bool] = None,
                 seed: int = 0,
                 spec=None, tokenizer=None,
                 trace: Union[bool, Tracer] = False,
                 selfcheck: bool = False,
                 wstream: Optional[str] = None,
                 device=None):
        if backend is None and params is None:
            raise ValueError("LLM needs params or a backend")
        for name, val in (("spec", spec), ("tokenizer", tokenizer)):
            if val:
                raise NotImplementedError(f"LLM({name}=...) is not ported "
                                          "yet")
        if wstream not in (None, "fp", "q8"):
            raise ValueError(f"unknown wire format {wstream!r} "
                             "(expected 'fp' or 'q8')")
        if wstream is not None:
            be_ws = getattr(backend, "wstream", None)
            if be_ws is None:
                if wstream != "fp":
                    raise ValueError(
                        "wstream='q8' needs a streaming backend "
                        "(HeteGenBackend(wstream='q8'))")
            elif be_ws != wstream:
                raise ValueError(
                    f"wstream={wstream!r} conflicts with the backend's "
                    f"wire format {be_ws!r}")
        self.wstream = wstream
        self.cfg = cfg
        # without a backend the one-shot generator runs the stacked whole
        # model over these params (moved to the device only if they are
        # elsewhere); the batcher wraps the same tensors in a
        # ResidentBackend (per-layer views of them), built at its first
        # use or here for paged serving, as in the JAX package, so a
        # family no backend takes (SSM) still generates one-shot
        self._params = None
        self._device = device
        self._backend = backend
        self._own_backend = (backend is None) if own_backend is None \
            else bool(own_backend)
        if backend is None:
            self._params = M.tree_to(params, resolve_device(device))
            if paged:
                self._resident_backend()
        self.sampling = sampling
        self.seed = seed
        # observability: trace=True records zero-sync spans across the
        # whole stack (batcher steps, engine streams, scheduler events);
        # the registry is always live and merges the stats() keys on
        # metrics()
        self.tracer = as_tracer(trace)
        self._metrics = MetricsRegistry()
        if self.tracer and backend is not None \
                and hasattr(backend, "set_tracer"):
            backend.set_tracer(self.tracer)
        # request_key folds request ids into this; step_key derives the
        # per-token draws
        self._base_key = seed_key(seed)
        self._batcher_kw = dict(
            max_slots=max_slots, max_len=max_len, paged=paged,
            page_size=page_size, n_pages=n_pages, kv_dtype=kv_dtype,
            retune_hysteresis=retune_hysteresis, policy=policy,
            optimistic=optimistic, preempt_mode=preempt_mode,
            chunk_tokens=chunk_tokens, prefix_dedupe=prefix_dedupe,
            selfcheck=selfcheck, sampling=sampling, seed=seed,
            tracer=self.tracer, metrics=self._metrics)
        self._ids = itertools.count()
        self._batcher: Optional[ContinuousBatcher] = None
        self._generator: Optional[Generator] = None
        self._closed = False
        self.last_executor: Optional[str] = None
        self.last_metrics: Dict[str, float] = {}

    # -- executor -------------------------------------------------------
    def _resident_backend(self):
        if self._backend is None:
            from repro_torch.serving.backends import ResidentBackend
            self._backend = ResidentBackend(self.cfg, self._params,
                                            device=self._device)
        return self._backend

    def _ensure_batcher(self) -> ContinuousBatcher:
        if self._batcher is None:
            # the facade manages backend lifetime, not the batcher
            self._batcher = ContinuousBatcher(
                self.cfg, backend=self._resident_backend(),
                own_backend=False, **self._batcher_kw)
        return self._batcher

    def _ensure_generator(self) -> Generator:
        if self._generator is None:
            if self._params is not None:
                self._generator = Generator(self.cfg, self._params)
            else:
                self._generator = Generator(self.cfg, backend=self._backend)
        return self._generator

    # -- request normalization -----------------------------------------
    def _as_requests(self, prompts, max_new, eos, sampling
                     ) -> List[GenRequest]:
        if isinstance(prompts, GenRequest):
            prompts = [prompts]
        elif prompts and isinstance(prompts[0], (int, np.integer)):
            prompts = [prompts]          # a single raw token sequence
        reqs: List[GenRequest] = []
        for i, p in enumerate(prompts):
            if isinstance(p, GenRequest):
                req = p
            else:
                if max_new is None:
                    raise ValueError("max_new is required for raw prompts")
                sp = sampling[i] if isinstance(sampling, (list, tuple)) \
                    else (sampling or self.sampling)
                req = GenRequest(list(int(t) for t in p), max_new, eos=eos,
                                 sampling=sp)
            if req.rid is None:
                req.rid = next(self._ids)
            reqs.append(req)
        return reqs

    # -- blocking batch -------------------------------------------------
    def generate(self, prompts, max_new: Optional[int] = None, *,
                 eos: Optional[int] = None,
                 sampling=None) -> List[RequestOutput]:
        """Run a batch of requests to completion and return their outputs.

        A rectangular batch with nothing else in flight runs one-shot
        (one prefill + the decode loop); ragged prompts, per-request
        budgets, logprobs, or overlap with submitted work run through the
        continuous batcher.  Either way the tokens are the same
        (request-owned sampling streams)."""
        reqs = self._as_requests(prompts, max_new, eos, sampling)
        if not reqs:
            return []
        busy = self._batcher is not None and (
            self._batcher.queue or self._batcher.scheduler.resident())
        rect = (len({len(r.prompt) for r in reqs}) == 1
                and len({r.max_new for r in reqs}) == 1
                # logprob extraction rides the batcher's sampler
                and not any(r.sampling.logprobs is not None for r in reqs))
        if rect and not busy:
            return self._generate_oneshot(reqs)
        return self._generate_batched(reqs)

    def _generate_oneshot(self, reqs: List[GenRequest]
                          ) -> List[RequestOutput]:
        g = self._ensure_generator()
        toks = np.asarray([r.prompt for r in reqs], dtype=np.int32)
        keys = [request_key(self._base_key, r.rid, r.sampling)
                for r in reqs]
        res = g.generate({"tokens": toks}, reqs[0].max_new,
                         sampling=[r.sampling for r in reqs],
                         request_keys=keys)
        self.last_executor = "generator"
        self.last_metrics = {"prefill_s": res.prefill_s,
                             "decode_s": res.decode_s,
                             "tokens_per_s": res.tokens_per_s}
        outs = []
        for req, row in zip(reqs, res.tokens):
            if req.eos is not None and req.eos in row:
                row = row[:row.index(req.eos) + 1]
            outs.append(RequestOutput(req.rid, req.prompt, list(row),
                                      _finish_reason(row, req.eos)))
        return outs

    def _generate_batched(self, reqs: List[GenRequest]
                          ) -> List[RequestOutput]:
        b = self._ensure_batcher()
        for req in reqs:
            self._submit_req(req)
        t0 = time.perf_counter()
        steps = 0
        while not all(b.requests[r.rid].done for r in reqs):
            self._step_or_stall()
            steps += 1
        dt = max(time.perf_counter() - t0, 1e-9)
        n_tok = sum(len(b.requests[r.rid].generated) for r in reqs)
        self.last_executor = "batcher"
        self.last_metrics = {"steps": steps, "wall_s": dt,
                             "tokens_per_s": n_tok / dt}
        return [self._take_result(r.rid) for r in reqs]

    # -- incremental ----------------------------------------------------
    def submit(self, prompt: Union[Prompt, GenRequest],
               max_new: Optional[int] = None, *,
               eos: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None) -> int:
        """Queue one request on the continuous batcher; returns its id."""
        req = self._as_requests(prompt, max_new, eos, sampling)[0]
        if priority is not None:
            req.priority = priority
        return self._submit_req(req)

    def _submit_req(self, req: GenRequest) -> int:
        b = self._ensure_batcher()
        b.submit(req.prompt, req.max_new, req.eos,
                 sampling=req.sampling, rid=req.rid,
                 priority=req.priority)
        return req.rid

    def step(self) -> int:
        """Advance the scheduler one step; returns the number of active
        slots after it."""
        if self._batcher is None:
            return 0
        return self._batcher.step()

    def _step_or_stall(self) -> int:
        """One scheduler step that refuses to spin: an idle scheduler
        whose admission makes no progress can never make any."""
        b = self._batcher
        idle_before = not b.active.any() and not b.scheduler.resident()
        queued_before = len(b.queue)
        n = self.step()
        if n == 0 and b.queue and idle_before \
                and len(b.queue) == queued_before \
                and not b.scheduler.resident():
            raise RuntimeError("scheduler stalled with queued requests")
        return n

    def drain(self, max_steps: int = 100_000) -> Dict[int, RequestOutput]:
        """Run the batcher until every submitted request finishes; each
        finished request is reported exactly once and then evicted."""
        b = self._batcher
        if b is None:
            return {}
        t0 = time.perf_counter()
        before = sum(len(r.generated) for r in b.requests.values())
        steps = 0
        for _ in range(max_steps):
            if not b.queue and not b.scheduler.resident():
                break
            self._step_or_stall()
            steps += 1
        dt = max(time.perf_counter() - t0, 1e-9)
        toks = sum(len(r.generated) for r in b.requests.values()) - before
        self.last_executor = "batcher"
        self.last_metrics = {"steps": steps, "wall_s": dt,
                             "tokens_per_s": toks / dt}
        return {rid: self._take_result(rid)
                for rid in list(b.requests)
                if b.requests[rid].done}

    def result(self, rid: int) -> RequestOutput:
        """Output of a batcher-scheduled request (complete or partial)."""
        req = self._ensure_batcher().requests[rid]
        reason = req.finish_reason or _finish_reason(req.generated, req.eos)
        return RequestOutput(req.rid, req.prompt, list(req.generated),
                             reason,
                             logprobs=None if req.logprobs is None
                             else list(req.logprobs))

    def _take_result(self, rid: int) -> RequestOutput:
        out = self.result(rid)
        self._batcher.requests.pop(rid, None)
        return out

    # -- introspection / lifecycle -------------------------------------
    @property
    def backend(self):
        """The serving backend: the one passed in, or the resident one
        built for the batcher (None until then)."""
        return self._backend

    def stats(self) -> Dict:
        """Serving counters: per-phase plans, engine stream busy-time,
        scheduler and page-pool counters."""
        st: Dict = {"executor": self.last_executor, **self.last_metrics}
        be = self._backend
        if hasattr(be, "wstream"):
            st["wstream"] = be.wstream
        if hasattr(be, "policies"):
            st["phase_alpha"] = {ph: p.alpha
                                 for ph, p in be.policies.items()}
            st["phase_batch"] = {ph: (p.batch, p.tokens_per_seq)
                                 for ph, p in be.policies.items()}
        if hasattr(be, "device_resident_bytes"):
            st["resident_bytes"] = be.device_resident_bytes()
        if hasattr(be, "finish_stats"):
            st["stream"] = be.finish_stats()
        if self._batcher is not None:
            st["retunes"] = self._batcher.retunes
            sched = self._batcher.scheduler
            st["scheduler"] = {"policy": sched.policy.name,
                               "preemptions": sched.preemptions,
                               "waiting": len(sched.waiting),
                               "preempted": len(sched.preempted),
                               "chunks_planned": sched.chunks_planned,
                               "dedupe_hits": sched.dedupe_hits,
                               "dedupe_tokens": sched.dedupe_tokens,
                               "max_wait_steps": max(
                                   (s.wait_steps for s in sched.pending),
                                   default=0)}
            kv = self._batcher.kv
            if kv is not None:
                st["paged"] = {"page_size": kv.page_size,
                               "pool_pages": kv.n_pages - 1,
                               "mapped_pages": kv.n_pages - 1
                               - kv.free_pages}
                st["kv"] = kv.stats()
        return st

    def metrics(self) -> Dict:
        """One flat snapshot of every serving metric: the live batcher
        instruments (``serve.*``) merged with the :meth:`stats` keys as
        namespaced gauges (``scheduler.preemptions``, ``kv.free_pages``,
        ``stream.cpu_s``, ...)."""
        reg = self._batcher.metrics if self._batcher is not None \
            else self._metrics
        reg.absorb(self.stats())
        return reg.snapshot()

    def write_trace(self, path: str) -> Dict:
        """Dump the recorded spans as Chrome trace JSON; returns the
        document (empty trace if tracing was never enabled)."""
        return write_chrome_trace(path, self.tracer)

    def overlap_report(self) -> OverlapReport:
        """Per-step I/O-hidden fraction / stream utilization / critical
        path from the recorded spans (paper Fig. 5c, Table 2)."""
        return compute_overlap(self.tracer.spans())

    def close(self) -> None:
        """Tear down everything the facade owns (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._batcher is not None:
            self._batcher.close()
        if self._own_backend and self._backend is not None:
            self._backend.close()

    def __enter__(self) -> "LLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
