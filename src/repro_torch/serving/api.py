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
logprobs in :class:`RequestOutput`).  ``backend=None`` serves resident
weights from ``params``: the one-shot generator and the batcher through
the stacked whole model (the batcher's
:class:`repro_torch.serving.backends.ScanResidentBackend`), or, with
``paged=True``, the batcher through
:class:`repro_torch.serving.backends.ResidentBackend`.  Scheduling knobs
(``policy``, ``optimistic``, ``preempt_mode``, ``chunk_tokens``,
``prefix_dedupe``) are facade-level, as in the JAX package.

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

``spec=`` (:class:`repro_torch.serving.speculative.SpecConfig`) serves
through speculative decoding (host drafts, one batched verify a step);
``tokenizer=`` (e.g. :class:`repro_torch.serving.tokenizer.ByteTokenizer`)
takes text prompts and fills ``RequestOutput.text``.  :meth:`LLM.stream`
yields a request's tokens as they decode, :meth:`LLM.stream_text` its
text, and ``submit(on_token=)`` (or ``GenRequest.stream``) calls back
per token.  :class:`AsyncLLM` is the event-loop front end: a background
thread owns the ``step()`` crank, on the backend's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import Generator
from repro_torch.serving.sampling import (SamplingParams, request_key,
                                          seed_key)
from repro_torch.serving.scheduler import SchedulerPolicy
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.tokenizer import StreamDecoder, Tokenizer
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
    stream: Optional[Callable[[int], None]] = None   # per-token callback
    rid: Optional[int] = None                        # assigned by the LLM
    priority: int = 0           # larger = more important (priority policy)


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
    text: Optional[str] = None  # decoded tokens when the LLM has a tokenizer


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
                 spec: Optional[SpecConfig] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 trace: Union[bool, Tracer] = False,
                 selfcheck: bool = False,
                 wstream: Optional[str] = None,
                 device=None):
        if backend is None and params is None:
            raise ValueError("LLM needs params or a backend")
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
        # elsewhere), and so does the batcher, which builds its own
        # ScanResidentBackend over the same tensors at its first use;
        # paged serving wraps them in a ResidentBackend (per-layer views),
        # built here, as in the JAX package.  A family the batcher does
        # not take (SSM, hybrid) still generates one-shot
        self._params = None
        self._device = device
        self._backend = backend
        self._own_backend = (backend is None) if own_backend is None \
            else bool(own_backend)
        if backend is None:
            self._params = M.tree_to(params, resolve_device(device))
            if paged:
                from repro_torch.serving.backends import ResidentBackend
                self._backend = ResidentBackend(cfg, self._params,
                                                device=device)
        self.sampling = sampling
        self.seed = seed
        self.spec = spec
        self.tokenizer = tokenizer
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
            selfcheck=selfcheck, seed=seed, spec=spec,
            tracer=self.tracer, metrics=self._metrics)
        self._ids = itertools.count()
        self._batcher: Optional[ContinuousBatcher] = None
        self._generator: Optional[Generator] = None
        self._callbacks: Dict[int, Callable[[int], None]] = {}
        self._delivered: Dict[int, int] = {}
        self._streaming: set = set()    # rids owned by live stream() iters
        self._closed = False
        self.last_executor: Optional[str] = None
        self.last_metrics: Dict[str, float] = {}

    # -- executor -------------------------------------------------------
    def _ensure_batcher(self) -> ContinuousBatcher:
        if self._batcher is None:
            if self._backend is None:
                # the batcher builds and owns its ScanResidentBackend
                self._batcher = ContinuousBatcher(
                    self.cfg, self._params, device=self._device,
                    **self._batcher_kw)
            else:
                # the facade manages backend lifetime, not the batcher
                self._batcher = ContinuousBatcher(
                    self.cfg, backend=self._backend, own_backend=False,
                    **self._batcher_kw)
        return self._batcher

    def _ensure_generator(self) -> Generator:
        if self._generator is None:
            if self._params is not None:
                self._generator = Generator(self.cfg, self._params)
            else:
                self._generator = Generator(self.cfg, backend=self._backend)
        return self._generator

    @property
    def device(self) -> torch.device:
        """The device the facade serves on: its backend's, or the one its
        resident params were placed on."""
        if self._backend is not None:
            return torch.device(self._backend.device)
        return resolve_device(self._device)

    # -- request normalization -----------------------------------------
    def _encode(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError("text prompts need a tokenizer "
                             "(LLM(..., tokenizer=ByteTokenizer()))")
        return list(self.tokenizer.encode(text))

    def _decode(self, tokens: Sequence[int]) -> Optional[str]:
        return None if self.tokenizer is None \
            else self.tokenizer.decode(tokens)

    def _default_eos(self, eos: Optional[int]) -> Optional[int]:
        if eos is None and self.tokenizer is not None:
            return self.tokenizer.eos_id
        return eos

    def _as_requests(self, prompts, max_new, eos, sampling
                     ) -> List[GenRequest]:
        if isinstance(prompts, (GenRequest, str)):
            prompts = [prompts]
        elif prompts and isinstance(prompts[0], (int, np.integer)):
            prompts = [prompts]          # a single raw token sequence
        eos = self._default_eos(eos)
        reqs: List[GenRequest] = []
        for i, p in enumerate(prompts):
            if isinstance(p, GenRequest):
                req = p
            else:
                if max_new is None:
                    raise ValueError("max_new is required for raw prompts")
                sp = sampling[i] if isinstance(sampling, (list, tuple)) \
                    else (sampling or self.sampling)
                toks = self._encode(p) if isinstance(p, str) \
                    else list(int(t) for t in p)
                req = GenRequest(toks, max_new, eos=eos, sampling=sp)
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
        budgets, logprobs, a per-token callback, speculative decoding, or
        overlap with submitted work run through the continuous batcher.
        Either way the tokens are the same (request-owned sampling
        streams)."""
        reqs = self._as_requests(prompts, max_new, eos, sampling)
        if not reqs:
            return []
        busy = self._batcher is not None and (
            self._batcher.queue or self._batcher.scheduler.resident())
        rect = (len({len(r.prompt) for r in reqs}) == 1
                and len({r.max_new for r in reqs}) == 1
                and not any(r.stream for r in reqs)
                # logprob extraction rides the batcher's sampler
                and not any(r.sampling.logprobs is not None for r in reqs)
                # draft -> verify -> rollback lives in the batcher's step
                and self.spec is None)
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
                                      _finish_reason(row, req.eos),
                                      text=self._decode(row)))
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
    def submit(self, prompt: Union[str, Prompt, GenRequest],
               max_new: Optional[int] = None, *,
               eos: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None) -> int:
        """Queue one request on the continuous batcher; returns its id.
        ``on_token`` (or ``GenRequest.stream``) is called with each new
        token as steps deliver it; ``priority``, when given, overrides a
        ``GenRequest``'s own (0 included)."""
        req = self._as_requests(prompt, max_new, eos, sampling)[0]
        if priority is not None:
            req.priority = priority
        return self._submit_req(req, on_token)

    def _submit_req(self, req: GenRequest,
                    on_token: Optional[Callable[[int], None]] = None
                    ) -> int:
        b = self._ensure_batcher()
        b.submit(req.prompt, req.max_new, req.eos,
                 sampling=req.sampling, rid=req.rid,
                 priority=req.priority)
        self._delivered[req.rid] = 0
        cb = on_token or req.stream
        if cb is not None:
            self._callbacks[req.rid] = cb
        return req.rid

    def step(self) -> int:
        """Advance the scheduler one step and fire the per-token
        callbacks; returns the number of active slots after it."""
        if self._batcher is None:
            return 0
        n = self._batcher.step()
        self._deliver()
        return n

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

    def stream(self, prompt: Union[str, Prompt, GenRequest],
               max_new: Optional[int] = None, *,
               eos: Optional[int] = None,
               sampling: Optional[SamplingParams] = None
               ) -> Iterator[int]:
        """Submit one request and yield its tokens as they decode.

        Submission is eager (the request is in the scheduler when this
        returns); only the delivery is lazy.  Other in-flight requests
        advance underneath; several iterators interleave freely."""
        rid = self.submit(prompt, max_new, eos=eos, sampling=sampling)
        # the iterator owns this request's reporting: a concurrent drain()
        # must neither evict it mid-iteration nor report it
        self._streaming.add(rid)
        return self._stream_tokens(rid)

    def _stream_tokens(self, rid: int) -> Iterator[int]:
        b = self._batcher
        req = b.requests[rid]
        sent = 0
        try:
            while True:
                while sent < len(req.generated):
                    yield req.generated[sent]
                    sent += 1
                if req.done:
                    break
                self._step_or_stall()
            self.last_executor = "batcher"
        finally:
            self._streaming.discard(rid)
            if req.done:
                self._take_result(rid)  # evict: fully delivered by yield

    def stream_text(self, prompt: Union[str, Prompt, GenRequest],
                    max_new: Optional[int] = None, *,
                    eos: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None
                    ) -> Iterator[str]:
        """:meth:`stream`, decoded: yields text chunks as tokens land.
        A multi-byte character split across tokens is held back until it
        is complete (empty chunks are skipped), so the chunks join to
        ``decode(tokens)`` without a trailing eos."""
        if self.tokenizer is None:
            raise ValueError("stream_text needs a tokenizer")
        dec = StreamDecoder(self.tokenizer)
        eos = self._default_eos(eos)
        for tok in self.stream(prompt, max_new, eos=eos,
                               sampling=sampling):
            if eos is not None and tok == eos:
                break
            chunk = dec.push(tok)
            if chunk:
                yield chunk
        tail = dec.flush()
        if tail:
            yield tail

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
                if b.requests[rid].done and rid not in self._streaming}

    def result(self, rid: int) -> RequestOutput:
        """Output of a batcher-scheduled request (complete or partial)."""
        req = self._ensure_batcher().requests[rid]
        reason = req.finish_reason or _finish_reason(req.generated, req.eos)
        return RequestOutput(req.rid, req.prompt, list(req.generated),
                             reason,
                             logprobs=None if req.logprobs is None
                             else list(req.logprobs),
                             text=self._decode(req.generated))

    def _take_result(self, rid: int) -> RequestOutput:
        """result() + eviction: a reported request leaves the
        scheduler's books."""
        out = self.result(rid)
        self._batcher.requests.pop(rid, None)
        self._delivered.pop(rid, None)
        return out

    def _deliver(self) -> None:
        for rid, cb in list(self._callbacks.items()):
            req = self._batcher.requests[rid]
            sent = self._delivered.get(rid, 0)
            for tok in req.generated[sent:]:
                cb(tok)
            self._delivered[rid] = len(req.generated)
            if req.done:
                del self._callbacks[rid]

    # -- introspection / lifecycle -------------------------------------
    @property
    def backend(self):
        """The serving backend: the one passed in, the ResidentBackend
        built for paged serving, or the batcher's ScanResidentBackend
        (None until the batcher is first needed)."""
        if self._backend is not None:
            return self._backend
        return self._batcher.backend if self._batcher is not None else None

    def stats(self) -> Dict:
        """Serving counters: per-phase plans, engine stream busy-time,
        scheduler and page-pool counters."""
        st: Dict = {"executor": self.last_executor, **self.last_metrics}
        be = self.backend
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
            if self._batcher.spec is not None:
                spec = self._batcher.spec_stats.as_dict()
                spec["per_request"] = {
                    rid: s.as_dict()
                    for rid, s in self._batcher.spec_by_req.items()}
                st["spec"] = spec
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


# ---------------------------------------------------------------------------
# AsyncLLM: the event-loop front end
# ---------------------------------------------------------------------------

_CLOSED = object()          # queue sentinel: no more tokens


class AsyncRequest:
    """Handle for a request submitted to :class:`AsyncLLM`.

    Iterate it to stream tokens as the background loop decodes them, or
    call :meth:`result` to wait for the finished :class:`RequestOutput`.
    Both are safe from any thread; tokens already queued keep flowing
    after the request completes."""

    def __init__(self, rid: int):
        self.rid = rid
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._output: Optional[RequestOutput] = None
        self._error: Optional[BaseException] = None

    # called by the AsyncLLM loop thread
    def _push(self, tok: int) -> None:
        self._q.put(tok)

    def _finish(self, output: Optional[RequestOutput] = None,
                error: Optional[BaseException] = None) -> None:
        self._output, self._error = output, error
        self._done.set()
        self._q.put(_CLOSED)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestOutput:
        """Block until the request finished.  Raises the loop's failure
        (scheduler stall, closed mid-flight) instead of returning a
        partial output."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        if self._error is not None:
            raise self._error
        return self._output

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is _CLOSED:
                # keep the sentinel so a second iteration terminates too
                self._q.put(_CLOSED)
                if self._error is not None:
                    raise self._error
                return
            yield item


class AsyncLLM:
    """Event-loop serving: a background thread drives the scheduler.

    ``submit`` returns an :class:`AsyncRequest` at once and the loop
    thread steps the scheduler whenever requests are in flight:
    ``stream()`` yields tokens with no caller-driven stepping,
    ``result()`` blocks, and many threads can submit and consume at once
    (the facade is guarded by one lock; each step batches work from every
    submitter).  The loop thread enters the backend's CUDA device before
    it steps (the current device and stream belong to each thread), so
    the kernels launch where the weights are.

        with AsyncLLM(cfg, params, policy="priority") as allm:
            hi = allm.submit(p1, max_new=32, priority=5)
            for tok in allm.stream(p2, max_new=64):   # no step() anywhere
                ...
            out = hi.result()

    Construction forwards every keyword to :class:`LLM`, or wraps an
    existing facade via ``llm=``; ``close()`` tears down what it built.
    ``close(drain=True)`` (the default) finishes in-flight requests
    first; ``close(drain=False)`` fails their handles with a
    ``RuntimeError``.  A scheduler failure (e.g. a stalled page pool)
    fails every in-flight handle and surfaces on the next ``submit``."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[Dict] = None, *,
                 llm: Optional[LLM] = None, **llm_kwargs):
        if llm is None:
            llm = LLM(cfg, params, **llm_kwargs)
            self._own_llm = True
        else:
            if llm_kwargs or cfg is not None or params is not None:
                raise ValueError("pass either llm= or LLM constructor "
                                 "arguments, not both")
            self._own_llm = False
        self._llm = llm
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._handles: Dict[int, AsyncRequest] = {}
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._busy_s = 0.0          # loop seconds spent inside step()
        self._tokens_done = 0       # tokens of finished requests
        self._thread = threading.Thread(target=self._run,
                                        name="asyncllm-step", daemon=True)
        self._thread.start()

    # -- submission -----------------------------------------------------
    def _register(self, req: GenRequest) -> AsyncRequest:
        if self._closed:
            raise RuntimeError("AsyncLLM is closed")
        if self._failure is not None:
            raise RuntimeError("AsyncLLM loop failed") from self._failure
        h = AsyncRequest(-1)
        if req.stream is None:
            on_tok = h._push
        else:
            # the GenRequest's own callback keeps firing (from the loop
            # thread) beside the handle's queue
            def on_tok(tok, _user=req.stream, _push=h._push):
                _user(tok)
                _push(tok)
        h.rid = self._llm._submit_req(req, on_token=on_tok)
        self._handles[h.rid] = h
        return h

    def submit(self, prompt: Union[str, Prompt, GenRequest],
               max_new: Optional[int] = None, *,
               eos: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None) -> AsyncRequest:
        """Queue one request; returns its handle at once.  The loop wakes
        and decodes without further calls."""
        with self._work:
            req = self._llm._as_requests(prompt, max_new, eos, sampling)[0]
            if priority is not None:
                req.priority = priority
            h = self._register(req)
            self._work.notify_all()
        return h

    def stream(self, prompt: Union[str, Prompt, GenRequest],
               max_new: Optional[int] = None, *,
               eos: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[int] = None) -> Iterator[int]:
        """Submit and iterate tokens as the loop decodes them."""
        return iter(self.submit(prompt, max_new, eos=eos, sampling=sampling,
                                priority=priority))

    def generate(self, prompts, max_new: Optional[int] = None, *,
                 eos: Optional[int] = None, sampling=None,
                 timeout: Optional[float] = None) -> List[RequestOutput]:
        """Blocking batch convenience over the event loop."""
        with self._work:
            reqs = self._llm._as_requests(prompts, max_new, eos, sampling)
            handles = [self._register(r) for r in reqs]
            self._work.notify_all()
        return [h.result(timeout) for h in handles]

    # -- the loop -------------------------------------------------------
    def _run(self) -> None:
        dev = self._llm.device
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._work:
                while not self._handles and not self._closed:
                    self._work.wait()
                if not self._handles:          # closed and drained
                    return
                t0 = time.perf_counter()
                try:
                    self._llm._step_or_stall()
                except BaseException as e:     # stall, backend death, ...
                    self._failure = e
                    for h in self._handles.values():
                        h._finish(error=e)
                    self._handles.clear()
                    continue
                self._busy_s += time.perf_counter() - t0
                b = self._llm._batcher
                fin = [rid for rid in self._handles
                       if rid in b.requests and b.requests[rid].done]
                for rid in fin:
                    out = self._llm._take_result(rid)
                    self._tokens_done += len(out.tokens)
                    self._handles.pop(rid)._finish(output=out)

    # -- introspection / lifecycle -------------------------------------
    @property
    def llm(self) -> LLM:
        return self._llm

    def stats(self) -> Dict:
        with self._lock:
            st = self._llm.stats()
            st["in_flight"] = len(self._handles)
            if self._busy_s > 0:
                # the loop thread owns the crank, so report its own rate
                st["executor"] = "batcher(async)"
                st["tokens_per_s"] = self._tokens_done / self._busy_s
            return st

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the loop (idempotent).  ``drain=True`` lets in-flight
        requests finish first; ``drain=False`` fails their handles with
        ``RuntimeError``.  With a ``timeout``, raises ``TimeoutError`` if
        the drain did not finish in time and leaves the backend open
        under the still-stepping loop thread."""
        with self._work:
            if not drain and self._handles:
                err = RuntimeError(
                    "AsyncLLM closed with requests in flight")
                for h in self._handles.values():
                    h._finish(error=err)
                self._handles.clear()
            self._closed = True
            self._work.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                "AsyncLLM close timed out with requests still draining; "
                "retry close() or close(drain=False)")
        if self._own_llm:
            self._llm.close()

    def __enter__(self) -> "AsyncLLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
