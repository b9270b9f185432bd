"""Continuous batching: a pure executor under a pluggable scheduler.

Requests join/leave a fixed pool of ``max_slots`` decode slots without
stopping the batch.  Every admit/preempt/resume decision lives in
:class:`repro_torch.serving.scheduler.Scheduler`; the batcher applies the
scheduler's per-step :class:`repro_torch.serving.scheduler.StepPlan`:

  * **preempt** — copy the victim's KV pages to host memory (swap mode)
    and clear its slot;
  * **start** — restore saved pages (swap resume) or prefill
    ``prompt + generated`` (fresh admissions and recompute resumes are one
    code path); several same-length fresh admissions share one prefill;
  * **prefill** — advance one chunk of a chunked admission;
  * **decode** — advance every active slot one token (dense mode decodes
    the full slot width, inactive rows masked; paged mode compacts to the
    active block-table rows).

The batcher schedules over any :mod:`repro_torch.serving.backends` backend;
between a decode step's math and its host-side sampling it nudges the
offload engine's pinned ring (``backend.prefetch_next_step()``) so step
N+1's pins overlap step N's tail.

Sampling is **per request**: each submit may carry its own
:class:`repro_torch.serving.sampling.SamplingParams`, rows of one decode
batch are sampled under their own parameters (row-vectorized sampler),
and every request owns a random stream keyed by its id (or its own
``seed``) and its generated-token count — never by batch-row number.
Scheduling (compaction, preemption, resume) therefore cannot perturb
tokens.  ``SamplingParams.logprobs`` additionally records each sampled
token's log-probability (and top-k alternatives) straight out of the
sampler's sort.

``paged=True`` swaps the dense cache for
:class:`repro_torch.serving.kv_cache.PagedKVCache`, over a backend that
pages (``ResidentBackend``, ``HeteGenBackend``; the
``ScanResidentBackend`` built without a backend does not); its pools
are device tensors the model updates in place, so no pool is copied
back after a step.  ``kv_dtype="int8"`` stores int8 pages.

``spec=`` (:class:`repro_torch.serving.speculative.SpecConfig`) turns on
speculative decoding: the host drafts before the plan, the scheduler
reserves each drafted request's ``k + 1`` positions, and the decode step
becomes one ``backend.verify`` over ``[pending] + drafts`` per row,
accepted on the host and rolled back by ``PagedKVCache.truncate`` (or a
dense length reset).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_cache import slot_view
from repro_torch.serving.sampling import (SamplerConfig, SamplingParams,
                                          greedy, pack_sampling, request_key,
                                          sample_rows, seed_key, step_key)
from repro_torch.serving.scheduler import (PREFILLING, RequestState, RUNNING,
                                           Scheduler, SchedulerPolicy)
from repro_torch.serving.speculative import (AdaptiveK, SpecConfig,
                                             SpecStats, accept_drafts,
                                             logprob_record)
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracer import NULL_TRACER, Tracer


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 max_slots: int = 4, max_len: int = 512,
                 backend=None, sampler: SamplerConfig = SamplerConfig(),
                 seed: int = 0, paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 retune_hysteresis: Optional[int] = None,
                 own_backend: Optional[bool] = None,
                 policy: Union[str, SchedulerPolicy, None] = "fcfs",
                 optimistic: bool = True,
                 preempt_mode: Optional[str] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_dedupe: Optional[bool] = None,
                 spec: Optional[SpecConfig] = None,
                 selfcheck: bool = False,
                 tracer: Tracer = NULL_TRACER,
                 metrics: Optional[MetricsRegistry] = None,
                 device=None):
        if cfg.family in ("ssm", "hybrid", "encdec"):
            raise NotImplementedError(
                "continuous batching supports transformer KV caches")
        if backend is None and params is None:
            raise ValueError("ContinuousBatcher needs params or a backend")
        self.cfg = cfg
        self._own_backend = backend is None if own_backend is None \
            else bool(own_backend)
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._step_no = 0
        if backend is None:
            # the scan-stacked whole model, as in the JAX package (every
            # transformer family); its cache is not pageable, so paged
            # serving passes a ResidentBackend, as LLM(paged=True) does
            from repro_torch.serving.backends import ScanResidentBackend
            backend = ScanResidentBackend(cfg, params, device=device)
        self.backend = backend
        self.device = backend.device
        if tracer and hasattr(self.backend, "set_tracer"):
            self.backend.set_tracer(tracer)
        if hasattr(self.backend, "retune"):
            # the decode batch is the slot count
            self.backend.retune(max_slots)
        self.max_slots = max_slots
        self.max_len = max_len
        self.default_sampling = SamplingParams.from_config(sampler)
        # the one base key request_key folds request ids into; every
        # sampling draw derives from it per request
        self._base_key = seed_key(seed)
        self._pack_sig = None               # slot -> request of _packed
        self._packed: Optional[Dict] = None
        self._packed_lp: Optional[int] = None
        self.paged = paged
        self.kv = None
        if paged:
            self.kv = self.backend.init_paged_cache(
                max_slots, max_len, page_size=page_size, n_pages=n_pages,
                kv_dtype=kv_dtype, check=selfcheck)
            self.cache = self.kv.init_cache()
        else:
            self.cache = self.backend.init_cache(max_slots, max_len)
        self.scheduler = Scheduler(policy, max_slots, max_len, kv=self.kv,
                                   optimistic=optimistic,
                                   preempt_mode=preempt_mode,
                                   chunk_tokens=chunk_tokens,
                                   prefix_dedupe=prefix_dedupe,
                                   tracer=tracer)
        # per-slot lengths (a vector 'len' drives per-slot scatter updates)
        self.cache["len"] = torch.zeros((max_slots,), dtype=torch.int32,
                                        device=self.device)
        # dense chunked prefill accumulates each slot's KV in a private
        # batch-1 cache, merged into the global cache on the final chunk
        self._pending_dense: Dict[int, Dict] = {}
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                  device=self.device)
        self._ids = itertools.count()
        self.retune_hysteresis = retune_hysteresis
        self._plan_batch = max_slots
        self.retunes = 0
        # speculative decoding: host drafting + one batched verify a step;
        # the batcher owns the drafter's per-request state
        self.spec = spec
        self.spec_stats = SpecStats()
        self.spec_by_req: Dict[int, SpecStats] = {}
        self._adaptive: Optional[AdaptiveK] = None
        if spec is not None:
            if not hasattr(self.backend, "verify"):
                raise ValueError(
                    "speculative decoding needs a backend exposing "
                    "verify(batch, cache); "
                    f"{type(self.backend).__name__} does not")
            if spec.adaptive:
                self._adaptive = AdaptiveK(spec.k, spec.k_min, spec.k_max)
        self._closed = False

    # -- scheduler views ------------------------------------------------
    @property
    def requests(self) -> Dict[int, RequestState]:
        return self.scheduler.requests

    @property
    def queue(self) -> List[RequestState]:
        """Everything still wanting a slot (waiting + preempted)."""
        return self.scheduler.pending

    @property
    def active(self) -> np.ndarray:
        return self.scheduler.active_mask()

    @property
    def policy(self) -> SchedulerPolicy:
        return self.scheduler.policy

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int,
               eos: Optional[int] = None, *,
               sampling: Optional[SamplingParams] = None,
               rid: Optional[int] = None,
               priority: int = 0) -> int:
        """Queue a request; ``rid`` lets an owning facade keep one id
        space; ``priority`` matters to priority-aware policies."""
        sp = self.default_sampling if sampling is None else sampling
        rid = next(self._ids) if rid is None else rid
        st = RequestState(rid, list(prompt), max_new, eos, sampling=sp,
                          key=request_key(self._base_key, rid, sp),
                          priority=priority)
        self.scheduler.submit(st)
        return rid

    def _sample_slot_rows(self, logits: torch.Tensor,
                          slots: List[int]) -> torch.Tensor:
        """Sample one token per logits row, row i belonging to slot
        ``slots[i]``.  Each occupied slot draws under its request's own
        params with the key for its next token; vacant rows (the dense
        path's masked garbage) and mid-prefill rows sample greedily and
        draw nothing, so they cannot perturb real requests.  Rows whose
        request asked for logprobs get their per-token record appended
        here, straight out of the sampler's sort."""
        with self.tracer.span("sample", track="sample", rows=len(slots)):
            return self._sample_slot_rows_traced(logits, slots)

    def _sample_slot_rows_traced(self, logits: torch.Tensor,
                                 slots: List[int]) -> torch.Tensor:
        slot_req = self.scheduler.slot_req
        reqs = [None if slot_req[s] is None
                or slot_req[s].status == PREFILLING else slot_req[s]
                for s in slots]
        params = [SamplingParams() if r is None else r.sampling
                  for r in reqs]
        lp_k = [p.logprobs for p in params if p.logprobs is not None]
        if not lp_k and all(p.kind == "greedy" for p in params):
            # the default serving config: skip the full-vocab sort (greedy
            # rows draw nothing, so this is exactly equivalent)
            return greedy(logits)
        keys = [None if r is None else step_key(r.key, len(r.generated))
                for r in reqs]
        sig = tuple((s, -1 if r is None else r.rid)
                    for s, r in zip(slots, reqs))
        if sig != self._pack_sig:
            self._pack_sig = sig
            self._packed = pack_sampling(params, device=logits.device)
            self._packed_lp = max(lp_k) if lp_k else None
        if self._packed_lp is None:
            return sample_rows(logits, keys, self._packed)
        toks, lp = sample_rows(logits, keys, self._packed,
                               top_logprobs=self._packed_lp)
        # the step's one read-back of logprobs: (B,) and (B, k) values
        chosen = lp["logprob"].tolist()
        top_ids = lp["top_tokens"].tolist()
        top_lp = lp["top_logprobs"].tolist()
        tok_list = toks.tolist()
        for i, req in enumerate(reqs):
            if req is None or req.sampling.logprobs is None:
                continue
            k = req.sampling.logprobs
            req.logprobs.append({
                "token": int(tok_list[i]),
                "logprob": float(chosen[i]),
                "top": {int(t): float(l)
                        for t, l in zip(top_ids[i][:k], top_lp[i][:k])},
            })
        return toks

    def _tokens(self, toks: List[List[int]]) -> torch.Tensor:
        return torch.tensor(toks, dtype=torch.int32, device=self.device)

    # -- plan application ----------------------------------------------
    def _apply_preempt(self, st: RequestState) -> None:
        """Device side of an eviction: copy the victim's KV pages to host
        (swap mode — before anything can rewrite them) and clear its slot
        length.  Recompute mode keeps only the token ids."""
        if st.swap_block_ids is not None:
            ids = torch.as_tensor(st.swap_block_ids, dtype=torch.long,
                                  device=self.device)
            # advanced indexing gathers a copy; the pools stay untouched
            st.saved_kv = {k: v[ids].to("cpu").numpy()
                           for k, v in self.cache.items()
                           if k.startswith("pages_")}
        self._pending_dense.pop(st.slot, None)
        self.cache["len"][st.slot] = 0
        st.slot = None

    def _start(self, st: RequestState) -> None:
        """Device side of an admission: swap-restore saved pages, or
        prefill ``prompt + generated`` (fresh and recompute resumes)."""
        slot = st.slot
        if st.saved_kv is not None:
            # token-exact resume: scatter the saved KV bits into the
            # freshly mapped pages; the pending input token is the last
            # one generated before eviction
            ids = torch.as_tensor(
                self.kv.mapped_pages(slot)[:len(st.swap_block_ids)],
                dtype=torch.long, device=self.device)
            for key, saved in st.saved_kv.items():
                self.cache[key][ids] = torch.from_numpy(saved).to(
                    self.device)
            self.cache["len"][slot] = st.saved_len
            self.tokens[slot] = st.generated[-1]
            st.saved_kv = None
            st.swap_block_ids = None
            return
        toks = self._tokens([st.prompt + st.generated])
        if self.paged:
            logits = self._prefill_paged_slot(slot, toks)
        else:
            logits = self._prefill_dense_slot(slot, toks)
        first = int(self._sample_slot_rows(logits, [slot])[0])
        self.cache["len"][slot] = toks.shape[1]
        self.tokens[slot] = first
        st.generated.append(first)
        self._maybe_finish(st)

    def _merge_dense(self, slot: int, one_cache: Dict, row: int = 0) -> None:
        """Copy row ``row`` of a private dense cache into ``slot``, along
        the backend's ``cache_batch_axis`` (0 for the per-layer cache, 1
        for the stacked one)."""
        axis = self.backend.cache_batch_axis
        for key, glob in self.cache.items():
            if key == "len" or glob.dim() == 0:
                continue
            glob.select(axis, slot).copy_(one_cache[key].select(axis, row))

    def _prefill_dense_slot(self, slot: int, toks: torch.Tensor
                            ) -> torch.Tensor:
        """Batch-1 prefill into a fresh dense cache, then a copy of the row
        into the global cache (the copy the paged path exists to avoid)."""
        one_cache = self.backend.init_cache(1, self.max_len)
        one_cache, logits = self.backend.prefill({"tokens": toks},
                                                 one_cache)
        self._merge_dense(slot, one_cache)
        return logits

    def _export_tables(self) -> None:
        self.cache["block_tables"] = self.kv.device_block_tables()
        self.scheduler.tables_dirty = False

    def _prefill_paged_slot(self, slot: int, toks: torch.Tensor
                            ) -> torch.Tensor:
        """Prefill through a batch-1 block-table view: the prompt's KV
        scatters straight into the pages just mapped for this slot."""
        self._export_tables()
        _, logits = self.backend.prefill({"tokens": toks},
                                         slot_view(self.cache, slot))
        return logits

    def _start_batch(self, sts: List[RequestState]) -> None:
        """Admit several same-length fresh requests in ONE prefill call:
        attention rows are independent, so it is token-identical to
        per-slot admission and streams the weights once."""
        slots = [st.slot for st in sts]
        toks = self._tokens([st.prompt + st.generated for st in sts])
        n = toks.shape[1]
        if self.paged:
            self._export_tables()
            view = {k: v for k, v in self.cache.items()
                    if k.startswith("pages_")}
            view["block_tables"] = self.cache["block_tables"][
                torch.as_tensor(slots, device=self.device)]
            view["len"] = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
            _, logits = self.backend.prefill({"tokens": toks}, view)
        else:
            grp = self.backend.init_cache(len(sts), self.max_len)
            grp, logits = self.backend.prefill({"tokens": toks}, grp)
            for i, slot in enumerate(slots):
                self._merge_dense(slot, grp, row=i)
        firsts = self._sample_slot_rows(logits, slots).tolist()
        for i, st in enumerate(sts):
            self.cache["len"][st.slot] = n
            self.tokens[st.slot] = firsts[i]
            st.generated.append(firsts[i])
            self._maybe_finish(st)

    def _prefill_chunk(self, st: RequestState) -> None:
        """Advance one chunk of a chunked prefill: run tokens
        ``[prefill_cursor, prefill_target)`` at the right KV offset.
        Intermediate chunks only write KV; the final chunk samples the
        request's first token and flips it to running, so the slot joins
        this same step's decode."""
        slot = st.slot
        start, end = st.prefill_cursor, st.prefill_target
        seq = st.prompt + st.generated
        n = len(seq)
        toks = self._tokens([seq[start:end]])
        if self.paged:
            self._export_tables()
            _, logits = self.backend.prefill(
                {"tokens": toks}, slot_view(self.cache, slot, length=start))
        else:
            one_cache = self._pending_dense.get(slot)
            if one_cache is None:
                one_cache = self.backend.init_cache(1, self.max_len)
            one_cache, logits = self.backend.prefill({"tokens": toks},
                                                     one_cache)
            self._pending_dense[slot] = one_cache
        st.prefill_cursor = end
        if end < n:
            return
        if not self.paged:
            self._merge_dense(slot, self._pending_dense.pop(slot))
        st.status = RUNNING            # before sampling: the row is real
        first = int(self._sample_slot_rows(logits, [slot])[0])
        self.cache["len"][slot] = n
        self.tokens[slot] = first
        st.generated.append(first)
        self._maybe_finish(st)

    def _maybe_finish(self, st: RequestState) -> None:
        hit_eos = (st.eos is not None and st.generated
                   and st.generated[-1] == st.eos)
        if hit_eos or len(st.generated) >= st.max_new:
            st.finish_reason = "eos" if hit_eos else "length"
            slot = st.slot
            self.scheduler.finish(st)
            if slot is not None:
                self.cache["len"][slot] = 0
                st.slot = None
            if self.spec is not None:
                self.spec.drafter.release(st.rid)
                if self._adaptive is not None:
                    self._adaptive.release(st.rid)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Run one scheduler step: apply the policy's plan (preempt /
        admit / resume / grow pages), then advance all active slots one
        token.  Returns the number of active slots after the step."""
        self._step_no += 1
        t0 = time.perf_counter()
        toks_before = sum(len(r.generated) for r in self.requests.values())
        sp = self.tracer.span(f"step{self._step_no}", track="step")
        with sp:
            n = self._step_inner(sp)
        m = self.metrics
        m.counter("serve.steps").inc()
        m.counter("serve.tokens").inc(
            sum(len(r.generated) for r in self.requests.values())
            - toks_before)
        m.histogram("serve.step_s").observe(time.perf_counter() - t0)
        m.gauge("serve.active_slots").set(n)
        return n

    def _step_inner(self, sp) -> int:
        if self.kv is not None and self.kv.check:
            self.kv.validate()
        with self.tracer.span("plan", track="phase"):
            # drafting comes before the plan: the scheduler reserves each
            # drafted request's k + 1 positions up front; proposals of
            # requests the plan preempts are dropped (deterministic
            # drafters re-propose the same run on resume)
            proposals = self._draft_proposals() if self.spec is not None \
                else None
            advances = None
            if proposals:
                advances = {rid: len(d) + 1 for rid, d in proposals.items()}
            plan = self.scheduler.plan(advances)
        admit_cm = self.tracer.span("prefill", track="phase") \
            if (plan.preempt or plan.start or plan.prefill) \
            else contextlib.nullcontext()
        with admit_cm:
            for st in plan.preempt:
                self._apply_preempt(st)
            # group same-length fresh admissions into one prefill call;
            # swap restores and odd lengths keep the batch-1 path
            fresh: Dict[int, List[RequestState]] = {}
            for st in plan.start:
                if st.saved_kv is not None:
                    self._start(st)
                else:
                    fresh.setdefault(
                        len(st.prompt) + len(st.generated), []).append(st)
            for sts in fresh.values():
                if len(sts) == 1:
                    self._start(sts[0])
                else:
                    self._start_batch(sts)
            for st in plan.prefill:
                self._prefill_chunk(st)
        if self.paged and self.scheduler.tables_dirty:
            self._export_tables()
        active = self.scheduler.active_mask()
        if not active.any():
            sp.set(phase="prefill" if (plan.start or plan.prefill)
                   else "idle")
            return 0
        occ = int(active.sum())
        # paged decode compacts to the active slots; dense decode always
        # runs the full slot width (inactive rows compute masked garbage)
        executed = occ if self.paged else self.max_slots
        if (self.retune_hysteresis is not None
                and hasattr(self.backend, "retune")
                and abs(executed - self._plan_batch)
                > self.retune_hysteresis):
            self.backend.retune(executed, phase="decode")
            self._plan_batch = executed
            self.retunes += 1
        if proposals:
            proposals = {rid: d for rid, d in proposals.items()
                         if d and rid in self.requests
                         and self.requests[rid].status == RUNNING}
        if proposals:
            # drafted and undrafted rows share one verify step (an
            # undrafted row's bonus draw is the baseline decode draw)
            sp.set(phase="verify")
            with self.tracer.span("verify", track="phase"):
                self._spec_step(proposals, active)
            return int(self.scheduler.active_mask().sum())
        sp.set(phase="decode")
        with self.tracer.span("decode", track="phase"):
            if self.paged and occ < self.max_slots:
                self._decode_active_slots(active)
            else:
                self.cache, logits = self.backend.decode(self.tokens,
                                                         self.cache)
                self._prefetch_next_step()
                self.tokens = self._sample_slot_rows(
                    logits, list(range(self.max_slots)))
        nxt = self.tokens.tolist()
        for st in self.scheduler.running():
            st.generated.append(nxt[st.slot])
            self._maybe_finish(st)
        return int(self.scheduler.active_mask().sum())

    def _draft_proposals(self) -> Dict[int, List[int]]:
        """Host-side drafting over the running slots, capped per request
        so a fully accepted run never overshoots ``max_new`` (the bonus
        token needs headroom of 1) or ``max_len`` (``kv_len + k + 1 <=
        max_len``)."""
        out: Dict[int, List[int]] = {}
        for st in self.scheduler.running():
            k = self._adaptive.k_for(st.rid) if self._adaptive is not None \
                else self.spec.k
            k = min(k, st.max_new - len(st.generated) - 1,
                    self.max_len - st.kv_len - 1)
            if k <= 0:
                continue
            d = self.spec.drafter.propose(st.rid, st.prompt + st.generated,
                                          k)
            if d:
                out[st.rid] = [int(t) for t in d[:k]]
        return out

    def _spec_step(self, proposals: Dict[int, List[int]],
                   active: np.ndarray) -> None:
        """Draft -> verify -> accept -> rollback, as one step.

        Every running slot joins the verify batch — drafted rows carry
        ``[pending] + drafts``, undrafted rows their pending token —
        padded to the widest run.  Paged: the active slots' block-table
        and length rows form the batch, each row scored at its own
        ``kv_len`` (the paged-prefill kernel's per-row offset), pad
        positions past a row's pages written to the trash page.  Dense:
        the full slot width, lengths restored after the call and set per
        row below.  Acceptance runs on the host over one copy of the
        (rows, width, V) logits; the bonus tokens of stochastic rows are
        drawn in one ``sample_rows`` call on the logits' device with each
        request's plain step key.  Rejected drafts roll back as metadata
        (``PagedKVCache.truncate`` / the length): stale KV past a length
        is never attended before it is overwritten."""
        slot_req = self.scheduler.slot_req
        slots = [int(s) for s in np.flatnonzero(active)]
        drafts = {s: proposals.get(slot_req[s].rid, []) for s in slots}
        width = max(len(d) for d in drafts.values()) + 1

        def row_tokens(s: int) -> List[int]:
            d = drafts[s]
            return [slot_req[s].generated[-1]] + d + [0] * (width - 1 - len(d))

        if self.paged:
            idx = torch.as_tensor(slots, device=self.device)
            sub = {k: v for k, v in self.cache.items()
                   if k.startswith("pages_")}
            sub["block_tables"] = self.cache["block_tables"][idx]
            sub["len"] = self.cache["len"][idx]
            _, logits = self.backend.verify(
                {"tokens": self._tokens([row_tokens(s) for s in slots])},
                sub)
            row_of = {s: i for i, s in enumerate(slots)}
        else:
            lens_before = self.cache["len"].clone()
            toks = self._tokens([row_tokens(s) if active[s] else [0] * width
                                 for s in range(self.max_slots)])
            self.cache, logits = self.backend.verify({"tokens": toks},
                                                     self.cache)
            self.cache["len"] = lens_before
            row_of = {s: s for s in slots}
        self._prefetch_next_step()

        with self.tracer.span("sample", track="sample", rows=len(slots)):
            # the step's one copy of the verify logits to the host
            lg = logits.float().cpu().numpy()            # (rows, width, V)
            emitted: Dict[int, List[int]] = {}
            bonus: List[int] = []
            for s in slots:
                st = slot_req[s]
                m = len(drafts[s])
                out, owed = accept_drafts(lg[row_of[s], :m + 1], drafts[s],
                                          st.sampling, st.key,
                                          len(st.generated))
                if owed and st.sampling.kind == "greedy":
                    out.append(int(np.argmax(lg[row_of[s], m])))
                elif owed:
                    bonus.append(s)
                emitted[s] = out
            if bonus:
                at_row = torch.as_tensor([row_of[s] for s in bonus],
                                         device=logits.device)
                at_pos = torch.as_tensor([len(drafts[s]) for s in bonus],
                                         device=logits.device)
                reqs = [slot_req[s] for s in bonus]
                drawn = sample_rows(
                    logits[at_row, at_pos].float(),
                    [step_key(r.key, len(r.generated) + len(drafts[s]))
                     for r, s in zip(reqs, bonus)],
                    pack_sampling([r.sampling for r in reqs],
                                  device=logits.device)).tolist()
                for s, t in zip(bonus, drawn):
                    emitted[s].append(int(t))

        for s in slots:
            st = slot_req[s]
            m = len(drafts[s])
            out = emitted[s]
            n_full = len(out) - 1                 # drafts accepted, pre-cut
            if st.eos is not None and st.eos in out:
                out = out[:out.index(st.eos) + 1]
            accepted = min(len(out), n_full)
            if m > 0:
                self.spec_stats.record(m, accepted)
                self.spec_by_req.setdefault(st.rid, SpecStats()) \
                    .record(m, accepted)
                if self._adaptive is not None:
                    self._adaptive.update(st.rid, m, accepted)
            if st.sampling.logprobs is not None:
                rows = lg[row_of[s]]
                for j, t in enumerate(out):
                    st.logprobs.append(
                        logprob_record(rows[j], t, st.sampling.logprobs))
            st.generated.extend(out)
            # rollback: kv_len now counts only pending + accepted drafts;
            # pages past it unmap (paged) and the length shrinks
            new_len = st.kv_len
            if self.paged:
                self.cache = self.kv.truncate(self.cache, s, new_len)
                self.scheduler.tables_dirty = True
            self.cache["len"][s] = new_len
            self.tokens[s] = out[-1]
            self._maybe_finish(st)

    def _prefetch_next_step(self) -> None:
        if hasattr(self.backend, "prefetch_next_step"):
            self.backend.prefetch_next_step()

    def _decode_active_slots(self, active: np.ndarray) -> None:
        """One decode step over the active slots only: selecting the
        active block-table / length / token rows of the global pools is a
        metadata operation, so inactive slots cost nothing."""
        slots = np.flatnonzero(active)
        idx = torch.as_tensor(slots, device=self.device)
        sub = {k: v for k, v in self.cache.items()
               if k.startswith("pages_")}
        sub["block_tables"] = self.cache["block_tables"][idx]
        sub["len"] = self.cache["len"][idx]
        sub, logits = self.backend.decode(self.tokens[idx], sub)
        self._prefetch_next_step()
        self.cache["len"][idx] = sub["len"]
        self.tokens[idx] = self._sample_slot_rows(logits, slots.tolist())

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.queue and not self.scheduler.resident():
                break
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release the backend when this batcher owns it.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.kv is not None:
            self.kv.close()
        if self._own_backend:
            self.backend.close()

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
