"""Scheduling as an API: admission/preemption/resume policies over requests.

A host-only copy of the JAX package's scheduler (no device arrays are
involved, so the decisions are identical).  FlexGen's lesson (PAPERS.md)
is that *policy* — who runs, who waits, who gets evicted — dominates
offloaded throughput long before kernels do, so this module makes it a
first-class seam:

  * :class:`RequestState` — one request's full scheduling state: prompt,
    budget, sampling stream, priority, generated tokens, status
    (waiting / running / preempted / finished), and — when preempted with
    ``preempt_mode="swap"`` — its host-saved KV pages.
  * :class:`SchedulerPolicy` — the pluggable decision surface: admission
    order, sacrifice order, and which running victims an incoming request
    may preempt.  Three implementations ship: :class:`FCFSPolicy`,
    :class:`PriorityPolicy`, :class:`FairSharePolicy` (registry:
    :func:`get_policy`).
  * :class:`Scheduler` — owns the request queues, the slot table, and all
    page *accounting* (`PagedKVCache` alloc/free), and emits a per-step
    :class:`StepPlan`.  The :class:`repro_torch.serving.batcher.ContinuousBatcher`
    shrinks to a pure executor: it applies the plan (save / restore /
    prefill), runs the decode step, and reports tokens back.

Optimistic paging (ROADMAP paged follow-up): with ``optimistic=True``
(the default for paged serving) admission maps only the pages the prompt
needs *now* — ``prompt + 1`` positions instead of ``prompt + max_new`` —
and every step grows each running slot by exactly the next decode
position.  The pool therefore admits far more concurrent requests than
worst-case reservation would, and *page pressure* becomes a scheduling
event rather than an admission error: when ``alloc`` raises
:class:`PagesExhausted`, the policy picks victims, their pages are
released, and they re-enter the admission queue.

Preemption is loss-free and token-exact in both modes:

  * ``preempt_mode="swap"`` (paged default) — the victim's mapped pages
    are gathered to host memory (the natural direction for a HeteGen
    deployment: host RAM is the big pool) and scattered back into freshly
    mapped pages on resume.  KV bits are preserved exactly, so the resumed
    request continues bit-identically.
  * ``preempt_mode="recompute"`` (dense default) — the victim keeps only
    its token ids; resume re-prefills ``prompt + generated`` in one pass.
    Teacher-forced prefill reproduces the decode-path KV and logits
    exactly on this backend (tests/test_scheduler.py), and sampling draws
    from request-owned PRNG streams keyed by generated-token count
    (PR 3), so resumed requests are token-identical either way.

Starvation/thrash guards: a growth victim may be the growing request
itself (it simply waits for co-tenants to release pages), but when a
request is *alone* and still cannot grow, no future step can help — the
scheduler raises instead of flapping.  ``FairSharePolicy`` only allows
preemption after a victim has generated ``quantum`` tokens since its last
(re)admission, so every preemption cycle makes at least ``quantum``
tokens of progress.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Protocol, Union, runtime_checkable

import numpy as np

from repro_torch.serving.kv_cache import PagedKVCache, PagesExhausted
from repro_torch.serving.sampling import SamplingParams
from repro_torch.telemetry.tracer import NULL_TRACER, Tracer

WAITING = "waiting"
RUNNING = "running"
PREFILLING = "prefilling"
PREEMPTED = "preempted"
FINISHED = "finished"


@dataclasses.dataclass
class RequestState:
    """One request's complete scheduling state (the queue's unit)."""

    rid: int
    prompt: List[int]
    max_new: int
    eos: Optional[int] = None
    sampling: SamplingParams = SamplingParams()
    key: Optional[int] = None            # request-owned random stream
    priority: int = 0                    # larger = more important
    arrival: int = 0                     # monotonic submission index
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: Optional[List[Dict]] = None  # per-token, when requested
    status: str = WAITING
    finish_reason: Optional[str] = None  # "eos" | "length" once finished
    slot: Optional[int] = None
    preemptions: int = 0                 # times this request was evicted
    resumed_at: int = 0                  # len(generated) at last admission
    wait_steps: int = 0                  # steps spent waiting/preempted
    # swap-mode preemption state: which pages to save (recorded at the
    # planning step, before they return to the free list) and the host
    # copy the executor gathers before anything overwrites them
    swap_block_ids: Optional[List[int]] = None
    saved_len: int = 0
    saved_kv: Optional[Dict[str, np.ndarray]] = None
    # chunked-prefill state (status == PREFILLING): tokens of
    # prompt + generated already written to KV, and the end the current
    # plan's chunk must reach (set by Scheduler.plan, consumed by the
    # executor which advances the cursor after prefilling)
    prefill_cursor: int = 0
    prefill_target: int = 0
    # prefix-dedupe state: cumulative hashes of the prompt's full pages
    # (computed at submit) and how many tokens were forked from a shared
    # prefix at admission instead of prefilled
    prefix_hashes: Optional[List[bytes]] = None
    forked_len: int = 0

    @property
    def done(self) -> bool:
        return self.status == FINISHED

    @property
    def kv_len(self) -> int:
        """KV positions materialized while running: the prompt plus every
        generated token except the newest (still the pending input)."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def slice_served(self) -> int:
        """Tokens generated since the last (re)admission."""
        return len(self.generated) - self.resumed_at


@dataclasses.dataclass
class StepPlan:
    """What the executor must do before this step's decode.

    ``preempt`` entries still carry their old ``slot`` so the executor can
    save their KV (swap mode) and clear the slot's length — their pages
    and slots are already released in the scheduler's accounting.
    ``start`` entries are already assigned a slot with pages mapped; the
    executor restores saved KV (``saved_kv`` set) or prefills
    ``prompt + generated`` (fresh admissions and recompute resumes — for
    a fresh request ``generated`` is empty, so the two are one code
    path).

    ``prefill`` entries are chunked admissions (status ``prefilling``):
    the executor prefills tokens ``[prefill_cursor, prefill_target)``
    into the slot's already-mapped pages and advances the cursor; on the
    final chunk (target == prompt + generated) it samples the first
    token and flips the request to ``running`` so the slot joins that
    same step's decode."""

    preempt: List[RequestState] = dataclasses.field(default_factory=list)
    start: List[RequestState] = dataclasses.field(default_factory=list)
    prefill: List[RequestState] = dataclasses.field(default_factory=list)


@runtime_checkable
class SchedulerPolicy(Protocol):
    """The pluggable scheduling surface.

    All three methods are pure functions of request state — policies hold
    no queues and mutate nothing, which is what lets the scheduler replay
    them every step against whatever the current queues are.
    """

    name: str

    def admit_order(self, pending: List[RequestState]
                    ) -> List[RequestState]:
        """Order the admission queue (waiting + preempted), most
        deserving first.  Admission is head-of-line: when the head cannot
        be placed, nothing behind it jumps the queue."""
        ...

    def preempt_order(self, running: List[RequestState]
                      ) -> List[RequestState]:
        """Sacrifice order over the running set, first victim first."""
        ...

    def may_preempt(self, incoming: RequestState,
                    victim: RequestState) -> bool:
        """May ``incoming`` (a pending request) evict ``victim`` to get
        admitted?  Page *growth* of already-running requests does not
        consult this — growth always may preempt (the alternative is a
        wedged step); this gate exists so admission cannot churn."""
        ...


class FCFSPolicy:
    """Arrival order; admission never preempts.  Page growth sacrifices
    the newest-arrived running request first (it has the least sunk
    work), exactly vLLM's recompute-preemption default."""

    name = "fcfs"

    def admit_order(self, pending):
        return sorted(pending, key=lambda s: s.arrival)

    def preempt_order(self, running):
        return sorted(running, key=lambda s: -s.arrival)

    def may_preempt(self, incoming, victim):
        return False


class PriorityPolicy:
    """Strict priorities: higher ``priority`` admits first and may evict
    any strictly lower-priority running request (strictness is the
    anti-thrash guarantee — equal priorities never preempt each other).
    Ties break FCFS."""

    name = "priority"

    def admit_order(self, pending):
        return sorted(pending, key=lambda s: (-s.priority, s.arrival))

    def preempt_order(self, running):
        return sorted(running, key=lambda s: (s.priority, -s.arrival))

    def may_preempt(self, incoming, victim):
        return incoming.priority > victim.priority


class FairSharePolicy:
    """Round-robin over service: least-served requests admit first, the
    most-served running request is sacrificed first, and a running
    request becomes evictable once it has generated ``quantum`` tokens
    since its last (re)admission.  Starvation bound: with any waiting
    request, no slot holder runs more than ``quantum`` tokens before
    yielding, so a waiter starts within ``quantum`` steps of reaching the
    head of the queue — and every preemption cycle ships at least
    ``quantum`` tokens, so slicing can never live-lock."""

    name = "fair_share"

    def __init__(self, quantum: int = 8):
        self.quantum = max(int(quantum), 1)

    def admit_order(self, pending):
        return sorted(pending, key=lambda s: (len(s.generated), s.arrival))

    def preempt_order(self, running):
        return sorted(running,
                      key=lambda s: (-len(s.generated), -s.arrival))

    def may_preempt(self, incoming, victim):
        return victim.slice_served >= self.quantum \
            and len(incoming.generated) < len(victim.generated) \
            + self.quantum

    def __repr__(self):
        return f"FairSharePolicy(quantum={self.quantum})"


POLICIES = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "fair_share": FairSharePolicy,
}


def get_policy(policy: Union[str, SchedulerPolicy, None]) -> SchedulerPolicy:
    """Resolve a policy name (registry) or pass a policy object through."""
    if policy is None:
        return FCFSPolicy()
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"known: {sorted(POLICIES)}") from None
    return policy


def _prefix_hashes(prompt: List[int], page_size: int) -> List[bytes]:
    """Cumulative digests of the prompt's *full* pages: entry j covers
    tokens [0, (j+1)*page_size).  Chained, so equal j-th entries imply the
    whole prefix matches — one comparison finds the longest shared
    page-aligned prefix at admission."""
    out: List[bytes] = []
    h = hashlib.sha256()
    for j in range(len(prompt) // page_size):
        page = prompt[j * page_size:(j + 1) * page_size]
        # lint: allow[hot-path-sync] hashes a host list of prompt ints at
        # admission (prefix dedupe); no device array is ever involved
        h.update(np.asarray(page, np.int64).tobytes())
        out.append(h.digest())
    return out


class Scheduler:
    """Owns who runs: queues, the slot table, and page accounting.

    The executor calls :meth:`plan` once per step and applies the
    returned :class:`StepPlan` (saves, then restores/prefills) before
    decoding; everything device-side stays in the executor, everything
    decision-side lives here.  ``kv`` is the page *allocator* — this
    class calls ``alloc``/``free``/``mapped_pages`` (host metadata only)
    and flips :attr:`tables_dirty` so the executor knows to re-export the
    device block tables."""

    def __init__(self, policy: Union[str, SchedulerPolicy, None],
                 max_slots: int, max_len: int, *,
                 kv: Optional[PagedKVCache] = None,
                 optimistic: bool = True,
                 preempt_mode: Optional[str] = None,
                 chunk_tokens: Optional[int] = None,
                 prefix_dedupe: Optional[bool] = None,
                 tracer: Tracer = NULL_TRACER):
        self.policy = get_policy(policy)
        # scheduling decisions land as instant events on the "sched"
        # track (docs/OBSERVABILITY.md) — admit/resume/preempt/finish
        self.tracer = tracer
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv = kv
        self.optimistic = bool(optimistic) and kv is not None
        if preempt_mode is None:
            preempt_mode = "swap" if kv is not None else "recompute"
        if preempt_mode not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        if preempt_mode == "swap" and kv is None:
            raise ValueError("preempt_mode='swap' needs a paged cache")
        self.preempt_mode = preempt_mode
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = chunk_tokens
        # prefix dedupe needs page-aliasing: default on for paged serving
        self.prefix_dedupe = (kv is not None if prefix_dedupe is None
                              else bool(prefix_dedupe) and kv is not None)
        self.requests: Dict[int, RequestState] = {}
        self.waiting: List[RequestState] = []
        self.preempted: List[RequestState] = []
        self.slot_req: List[Optional[RequestState]] = [None] * max_slots
        self.preemptions = 0           # total eviction events
        self.chunks_planned = 0        # chunked-prefill chunks emitted
        self.dedupe_hits = 0           # admissions that forked a prefix
        self.dedupe_tokens = 0         # prompt tokens never re-prefilled
        self.tables_dirty = False      # block tables changed since export
        self._arrivals = 0

    # -- queue views ----------------------------------------------------
    @property
    def pending(self) -> List[RequestState]:
        """Everything that wants a slot: never-run plus preempted."""
        return self.waiting + self.preempted

    def running(self) -> List[RequestState]:
        """Slots decoding this step (excludes mid-prefill slots)."""
        return [st for st in self.slot_req
                if st is not None and st.status == RUNNING]

    def prefilling(self) -> List[RequestState]:
        """Slots mid-chunked-prefill: they hold pages but do not decode."""
        return [st for st in self.slot_req
                if st is not None and st.status == PREFILLING]

    def resident(self) -> List[RequestState]:
        """Every slot holder — running plus prefilling."""
        return [st for st in self.slot_req if st is not None]

    def active_mask(self) -> np.ndarray:
        return np.asarray([st is not None and st.status == RUNNING
                           for st in self.slot_req], bool)

    # -- intake / completion -------------------------------------------
    def submit(self, st: RequestState) -> None:
        if st.rid in self.requests:
            raise ValueError(f"duplicate request id {st.rid}")
        st.arrival = self._arrivals
        self._arrivals += 1
        st.status = WAITING
        if st.sampling.logprobs is not None and st.logprobs is None:
            st.logprobs = []
        if self.prefix_dedupe and st.prefix_hashes is None:
            st.prefix_hashes = _prefix_hashes(st.prompt, self.kv.page_size)
        self.requests[st.rid] = st
        self.waiting.append(st)

    def finish(self, st: RequestState) -> None:
        """Retire a finished request: release its slot and pages."""
        st.status = FINISHED
        self.tracer.event("finish", track="sched", rid=st.rid,
                          reason=st.finish_reason,
                          generated=len(st.generated))
        if st.slot is not None:
            if self.kv is not None:
                self.kv.free(st.slot)
                self.tables_dirty = True
            self.slot_req[st.slot] = None

    # -- the per-step plan ---------------------------------------------
    def plan(self, advances: Optional[Dict[int, int]] = None) -> StepPlan:
        """Decide this step's preemptions, admissions, and page growth.

        All accounting (slots, pages) is committed here; the executor
        then performs the device work in plan order (saves before
        restores/prefills, so swapped KV is read before its old pages
        can be rewritten).

        ``advances`` maps request ids to this step's KV advance in
        positions (default 1, the plain decode step).  Speculative
        decoding passes ``k_eff + 1`` per drafted request so optimistic
        growth reserves the whole draft run up front; rejection later
        *shrinks* the slot back (``PagedKVCache.truncate``), so a spec
        step can never hold rejected pages across steps."""
        out = StepPlan()
        if self.optimistic:
            # growth first: running requests reserve their next decode
            # position, most-protected first so pressure lands on the
            # requests the policy would sacrifice anyway
            for st in reversed(self.policy.preempt_order(self.running())):
                if st.status == RUNNING:
                    adv = 1 if advances is None \
                        else max(int(advances.get(st.rid, 1)), 1)
                    self._grow(st, out, adv)
        # advance in-flight chunked prefills before admitting anything new:
        # a half-prefilled slot that stops getting chunks is pure waste
        for st in self.prefilling():
            if st.status == PREFILLING and st not in out.preempt:
                self._plan_chunk(st, out)
        for st in self.policy.admit_order(list(self.pending)):
            # a request preempted in THIS plan keeps its turn for next
            # step — resuming it immediately would just thrash
            if st in out.preempt:
                continue
            if not self._try_admit(st, out):
                break                      # head-of-line: no queue jumping
        for st in self.pending:
            st.wait_steps += 1
        return out

    # -- internals ------------------------------------------------------
    def _preempt(self, victim: RequestState, out: StepPlan) -> None:
        # a mid-prefill victim has sampled nothing: recompute semantics
        # are exact and free of swap bookkeeping — drop the pages, reset
        # the cursor, re-prefill (chunked again) on re-admission
        mid_prefill = victim.status == PREFILLING
        victim.status = PREEMPTED
        victim.preemptions += 1
        self.preemptions += 1
        self.tracer.event("preempt", track="sched", rid=victim.rid,
                          mode=self.preempt_mode,
                          mid_prefill=mid_prefill)
        victim.prefill_cursor = 0
        victim.forked_len = 0
        if self.kv is not None:
            if self.preempt_mode == "swap" and not mid_prefill:
                n_blocks = self.kv.blocks_for(victim.kv_len)
                victim.swap_block_ids = \
                    self.kv.mapped_pages(victim.slot)[:n_blocks]
                victim.saved_len = victim.kv_len
            self.kv.free(victim.slot)
            self.tables_dirty = True
        # the slot is free for reuse from this moment; the state keeps
        # victim.slot so the executor can save/clear it, and drops it there
        self.slot_req[victim.slot] = None
        self.preempted.append(victim)
        out.preempt.append(victim)

    def _grow(self, st: RequestState, out: StepPlan,
              advance: int = 1) -> bool:
        """Map the page(s) covering ``st``'s next ``advance`` decode
        positions, evicting victims (possibly ``st`` itself) under page
        pressure."""
        return self._grow_to(st, min(st.kv_len + advance, self.max_len),
                             out)

    def _grow_to(self, st: RequestState, target: int,
                 out: StepPlan) -> bool:
        """Map pages so ``st`` covers ``target`` positions, evicting
        victims (possibly ``st`` itself) under page pressure.  Candidates
        are every slot holder — a mid-prefill slot's pages are as
        reclaimable (by recompute) as a decoding slot's."""
        while True:
            try:
                self.kv.alloc(st.slot, target)
                self.tables_dirty = True
                return True
            except PagesExhausted:
                pass
            cands = self.resident()
            victims = self.policy.preempt_order(cands)
            v = victims[0]             # cands always contains st itself
            if v is st and len(cands) == 1:
                # alone and still short: every usable page is already
                # ours, so no later step can ever satisfy this request
                raise RuntimeError(
                    f"scheduler stalled: request {st.rid} needs "
                    f"{self.kv.blocks_for(target)} pages but the pool "
                    f"holds {self.kv.usable_pages}")
            self._preempt(v, out)
            if v is st:
                return False           # sit out; resume when pages free

    def _chunk_end(self, st: RequestState) -> int:
        """Where the next prefill chunk stops: cursor + chunk_tokens,
        capped at the full prompt + generated (recompute resumes replay
        generated tokens through the same chunked path)."""
        n = len(st.prompt) + len(st.generated)
        if self.chunk_tokens is None:
            return n                   # dedupe tail: one chunk to the end
        return min(st.prefill_cursor + self.chunk_tokens, n)

    def _plan_chunk(self, st: RequestState, out: StepPlan) -> None:
        """Emit the next chunk of an in-flight chunked prefill.  The
        final chunk maps one extra position (the slot joins that step's
        decode, mirroring :meth:`_admit_need_tokens`'s +1)."""
        end = self._chunk_end(st)
        n = len(st.prompt) + len(st.generated)
        if self.optimistic:
            target = min(end + 1, self.max_len) if end == n else end
            if not self._grow_to(st, target, out):
                return                 # self-preempted under pressure
        st.prefill_target = end
        self.chunks_planned += 1
        out.prefill.append(st)

    def _admit_need_tokens(self, st: RequestState, shared_len: int,
                           chunked: bool) -> int:
        """KV positions an admission must map up front."""
        if not self.optimistic:
            # classic reservation: everything the request could ever want
            # (max_new is the request's total budget, resumes included)
            return min(len(st.prompt) + st.max_new, self.max_len)
        if st.swap_block_ids is not None:
            # +1: a restored request joins this same step's decode
            return min(st.saved_len + 1, self.max_len)
        if chunked:
            # first chunk only; later chunks grow step by step
            return min(shared_len + self.chunk_tokens, self.max_len)
        n = len(st.prompt) + len(st.generated)
        # +1: a started request joins this same step's decode
        return min(n + 1, self.max_len)

    def _dedupe_probe(self, st: RequestState):
        """Longest page-aligned prompt prefix already materialized in a
        resident slot: returns (shared tokens, source request).  Only
        *full* pages are shared (aliasing needs immutability) and at
        least one tail token is always left to prefill, so the admission
        produces first-token logits."""
        if not self.prefix_dedupe or st.swap_block_ids is not None \
                or not st.prefix_hashes:
            return 0, None
        ps = self.kv.page_size
        n = len(st.prompt) + len(st.generated)
        best_j, best_src = 0, None
        for src in self.resident():
            if not src.prefix_hashes:
                continue
            limit = len(src.prefix_hashes)
            if src.status == PREFILLING:
                # only pages the cursor has fully written are shareable
                limit = min(limit, src.prefill_cursor // ps)
            limit = min(limit, len(st.prefix_hashes), (n - 1) // ps)
            for j in range(limit, best_j, -1):
                # chained digests: one equality implies the whole prefix
                if st.prefix_hashes[j - 1] == src.prefix_hashes[j - 1]:
                    best_j, best_src = j, src
                    break
        return best_j * ps, best_src

    def _free_slot(self) -> Optional[int]:
        for i, occ in enumerate(self.slot_req):
            if occ is None:
                return i
        return None

    def _try_admit(self, st: RequestState, out: StepPlan) -> bool:
        n = len(st.prompt) + len(st.generated)
        shared_len, src = self._dedupe_probe(st)
        chunked = (self.chunk_tokens is not None
                   and st.swap_block_ids is None
                   and n - shared_len > self.chunk_tokens)
        # any admission that does not land fully-materialized goes through
        # the prefilling state: chunked prompts, and dedupe hits (which
        # prefill only the tail past the forked prefix)
        prefilling = chunked or shared_len > 0
        need_tokens = self._admit_need_tokens(st, shared_len, chunked)
        need_blocks = 0 if self.kv is None \
            else self.kv.blocks_for(need_tokens) \
            - self.kv.blocks_for(shared_len)
        slot = self._free_slot()
        avail = None if self.kv is None else self.kv.free_pages
        victims: List[RequestState] = []
        if slot is None or (avail is not None and avail < need_blocks):
            # plan the minimal policy-sanctioned eviction set first, so a
            # doomed admission preempts nobody; requests started earlier
            # in THIS plan are never victims — they have not prefilled
            # yet, and appearing in both start and preempt would hand the
            # executor a contradiction.  The dedupe source is spared too:
            # evicting it would free the pages we are about to alias.
            cands = [v for v in self.policy.preempt_order(self.running())
                     if v.status == RUNNING and v not in out.start
                     and v is not src
                     and self.policy.may_preempt(st, v)]
            have_slot = slot is not None
            for v in cands:
                if have_slot and (avail is None or avail >= need_blocks):
                    break
                victims.append(v)
                have_slot = True
                if avail is not None:
                    avail += len(self.kv.mapped_pages(v.slot))
            if not have_slot or (avail is not None
                                 and avail < need_blocks):
                return False
        for v in victims:
            self._preempt(v, out)
        if slot is None:
            slot = victims[0].slot
        if self.kv is not None:
            if shared_len:
                self.kv.fork_aligned(src.slot, slot, shared_len)
                self.tables_dirty = True
            try:
                self.kv.alloc(slot, need_tokens)
            except PagesExhausted:
                # shared (forked) pages can make a victim's mapped count
                # an over-estimate of what freeing reclaims
                if shared_len:
                    self.kv.free(slot)   # undo the fork's aliases
                return False
            self.tables_dirty = True
        resume = st in self.preempted
        if st in self.waiting:
            self.waiting.remove(st)
        if resume:
            self.preempted.remove(st)
        self.tracer.event("resume" if resume else "admit", track="sched",
                          rid=st.rid, slot=slot,
                          wait_steps=st.wait_steps)
        st.slot = slot
        st.resumed_at = len(st.generated)
        st.wait_steps = 0
        self.slot_req[slot] = st
        if prefilling:
            st.status = PREFILLING
            st.prefill_cursor = shared_len
            st.forked_len = shared_len
            if shared_len:
                self.dedupe_hits += 1
                self.dedupe_tokens += shared_len
            self._plan_chunk(st, out)  # first chunk rides this same plan
        else:
            st.status = RUNNING
            out.start.append(st)
        return True
