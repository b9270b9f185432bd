"""Paged KV cache: a block-pool allocator for the offload serving path.

KV tokens live in fixed-size **pages** drawn from one global pool per
layer, and each slot owns a **block table** mapping logical kv blocks to
physical page ids (the vLLM-style design of the JAX package's
``serving/kv_cache.py``, which this module mirrors).  Admission maps
pages, release unmaps them — no cache buffer is ever sliced or merged.

Split of responsibilities:

  * :class:`PagedKVCache` is the *host-side allocator*: free-list,
    ref-counts, per-slot block tables, all numpy.  It re-exports its
    block tables to the device after map/unmap events.
  * the *device-side* page pools are cache-dict leaves
    ("pages_k{l}" / "pages_v{l}", layout (n_pages, Hkv, page_size, hd) —
    one (page_size, hd) tile per (page, head), the layout the paged CUDA
    kernels read) minted by :meth:`PagedKVCache.init_cache`.  They are
    device tensors **updated in place**: the model's paged writes are
    ``index_put_`` calls and :meth:`fork` / :meth:`truncate` copy pages
    inside the pool, so the cache dict always holds the same tensors.

Ref-counts make shared prompt prefixes cheap: :meth:`fork` aliases the
fully-immutable pages of a prefix into another slot's table and bumps
their counts (the trailing partial page is copied); pages return to the
free list only when the last owner releases them.

Page id 0 is a reserved trash page: unmapped block-table entries point at
it, so the masked garbage writes of inactive slots land somewhere
harmless instead of in another slot's pages.  int8 pools carry
per-(page, head, token) fp32 scale pages.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import torch_dtype

TRASH_PAGE = 0


class PagesExhausted(RuntimeError):
    """Raised when an allocation needs more pages than the free list has."""


class PagedCacheCorruption(RuntimeError):
    """Raised by the ``check=True`` self-check when an allocator invariant
    is violated (double release, ref-count drift, leaked pages, ...)."""


class PagedKVCache:
    """Block-pool allocator + block tables for a slot-based serving cache.

    ``n_pages`` bounds the pool (page 0 is reserved as trash); the default
    matches dense capacity — ``max_slots * ceil(max_len / page_size)``
    usable pages — but smaller pools are valid and simply make admission
    wait for pages (the OOM-of-pages regime the batcher queues through).
    """

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int, *,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, check: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = page_size
        self.blocks_per_slot = -(-max_len // page_size)
        self.n_pages = (1 + max_slots * self.blocks_per_slot
                        if n_pages is None else int(n_pages))
        if self.n_pages < 2:
            raise ValueError("need at least one usable page beyond trash")
        self.kv_dtype = kv_dtype
        # runtime self-check mode (LLM(selfcheck=True) / serve --selfcheck):
        # validate the free-list/ref-count/table invariants after every
        # mutating operation and refuse double releases / leaked closes
        self.check = check
        self._refcount_max = 0
        # host-side metadata: free list, ref-counts, block tables
        self._free: List[int] = list(range(self.n_pages - 1, TRASH_PAGE, -1))
        self._ref = np.zeros((self.n_pages,), np.int32)
        self._tables = np.full((max_slots, self.blocks_per_slot), TRASH_PAGE,
                               np.int32)
        self._n_blocks = np.zeros((max_slots,), np.int32)

    # -- device-side pool construction ---------------------------------
    def init_cache(self) -> Dict:
        """Mint the cache dict the model's paged plumbing consumes."""
        cfg = self.cfg
        q8 = self.kv_dtype == "int8"
        dt = torch.int8 if q8 else torch_dtype(cfg)
        dev = self.device
        shape = (self.n_pages, cfg.n_kv_heads, self.page_size, cfg.hd)
        cache: Dict = {"len": torch.zeros((self.max_slots,),
                                          dtype=torch.int32, device=dev),
                       "block_tables": self.device_block_tables()}
        for l in range(cfg.n_layers):
            cache[f"pages_k{l}"] = torch.zeros(shape, dtype=dt, device=dev)
            cache[f"pages_v{l}"] = torch.zeros(shape, dtype=dt, device=dev)
            if q8:
                cache[f"pages_ks{l}"] = torch.zeros(
                    shape[:3], dtype=torch.float32, device=dev)
                cache[f"pages_vs{l}"] = torch.zeros(
                    shape[:3], dtype=torch.float32, device=dev)
        return cache

    def device_block_tables(self) -> torch.Tensor:
        """The (max_slots, blocks_per_slot) tables as a device tensor —
        re-exported after every map/unmap event (tiny: int32 per block)."""
        return torch.from_numpy(self._tables.copy()).to(self.device)

    # -- allocator -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        """Pool capacity excluding the reserved trash page."""
        return self.n_pages - 1

    def blocks_for(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.page_size), 0)

    def alloc(self, slot: int, n_tokens: int) -> None:
        """Map pages so ``slot`` covers ``n_tokens`` logical positions.

        Growth is incremental — already-mapped pages are kept, only the
        shortfall is drawn from the free list — which is what makes
        *optimistic* paging (ROADMAP follow-up, now the scheduler's
        default) a pure policy change: the scheduler simply calls
        ``alloc(slot, kv_len + 1)`` every decode step instead of
        ``alloc(slot, prompt + max_new)`` once at admission, and treats
        :class:`PagesExhausted` as a preemption event instead of an
        admission error.

        All-or-nothing: raises :class:`PagesExhausted` (mapping nothing)
        when the free list cannot cover the growth, so a failed admission
        leaves the pool untouched and the request can simply stay queued.
        """
        need_blocks = self.blocks_for(n_tokens)
        if need_blocks > self.blocks_per_slot:
            raise ValueError(
                f"{n_tokens} tokens exceed max_len={self.max_len}")
        grow = need_blocks - int(self._n_blocks[slot])
        if grow <= 0:
            return
        if grow > len(self._free):
            raise PagesExhausted(
                f"slot {slot} needs {grow} pages, {len(self._free)} free")
        for j in range(int(self._n_blocks[slot]), need_blocks):
            pid = self._free.pop()
            self._ref[pid] = 1
            self._tables[slot, j] = pid
        self._n_blocks[slot] = need_blocks
        self._refcount_max = max(self._refcount_max, 1)
        if self.check:
            self.validate()

    def free(self, slot: int) -> None:
        """Unmap every page of ``slot``; pages whose ref-count hits zero
        return to the free list (shared prefix pages survive)."""
        if self.check and not self._n_blocks[slot]:
            raise PagedCacheCorruption(
                f"double release: slot {slot} holds no pages")
        for j in range(int(self._n_blocks[slot])):
            pid = int(self._tables[slot, j])
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)
        self._tables[slot, :] = TRASH_PAGE
        self._n_blocks[slot] = 0
        if self.check:
            self.validate()

    def fork_aligned(self, src_slot: int, dst_slot: int,
                     n_tokens: int) -> None:
        """Alias ``src_slot``'s first ``n_tokens`` (a multiple of
        ``page_size``) into ``dst_slot`` by reference — pure metadata:
        ref-count bumps and table writes, no page data moves.  This is
        the admission-time prefix-dedupe primitive: page-aligned shared
        prefixes are immutable (prefill only ever appends past them), so
        aliasing is always safe without copy-on-write."""
        if self._n_blocks[dst_slot]:
            raise ValueError(f"dst slot {dst_slot} still holds pages")
        n_full, partial = divmod(n_tokens, self.page_size)
        if partial:
            raise ValueError(
                f"fork_aligned needs page-aligned n_tokens, got {n_tokens}")
        if n_full > int(self._n_blocks[src_slot]):
            raise ValueError("fork extends past src slot's mapped pages")
        for j in range(n_full):
            pid = int(self._tables[src_slot, j])
            self._ref[pid] += 1
            self._refcount_max = max(self._refcount_max, int(self._ref[pid]))
            self._tables[dst_slot, j] = pid
        self._n_blocks[dst_slot] = n_full
        if self.check:
            self.validate()

    def fork(self, cache: Dict, src_slot: int, dst_slot: int,
             n_tokens: int) -> Dict:
        """Alias ``src_slot``'s first ``n_tokens`` into ``dst_slot``.

        Fully-covered pages are shared by reference (via
        :meth:`fork_aligned` — ref-count bump, no data movement); the
        trailing partial page — the only one a future append could write
        into — is deep-copied into a fresh page, so no copy-on-write
        machinery is needed on the decode path.  Returns the cache dict
        (the partial-page copy lands in the pools in place).
        """
        n_full, partial = divmod(n_tokens, self.page_size)
        if n_full + (1 if partial else 0) > int(self._n_blocks[src_slot]):
            raise ValueError("fork extends past src slot's mapped pages")
        if partial and not self._free:
            raise PagesExhausted("no free page for the partial prefix page")
        self.fork_aligned(src_slot, dst_slot, n_full * self.page_size)
        if partial:
            src_pid = int(self._tables[src_slot, n_full])
            dst_pid = self._free.pop()
            self._ref[dst_pid] = 1
            self._tables[dst_slot, n_full] = dst_pid
            self._n_blocks[dst_slot] = n_full + 1
            _copy_page(cache, src_pid, dst_pid)
            if self.check:
                self.validate()
        return cache

    def truncate(self, cache: Dict, slot: int, new_len: int) -> Dict:
        """Shrink ``slot`` to ``new_len`` logical positions — the rollback
        primitive of speculative decoding (rejected draft tokens vanish as
        block-table metadata, the payoff of the paged design).

        Pages past ``blocks_for(new_len)`` are unmapped: ref-counts drop,
        pages return to the free list at zero, and a truncate that lands
        exactly on a page boundary releases the boundary page too.  The
        kept trailing page is *writable* again (future appends land in
        it), so when it is shared (ref > 1 — a forked/deduped page) it is
        **copied on shrink** into a fresh page first; appending can then
        never corrupt the sibling that still aliases the original.
        Returns the cache dict (a needed page copy lands in the pools in
        place).
        """
        keep = self.blocks_for(new_len)
        n = int(self._n_blocks[slot])
        if keep > n:
            raise ValueError(
                f"truncate to {new_len} tokens needs {keep} pages but "
                f"slot {slot} maps only {n}")
        for j in range(keep, n):
            pid = int(self._tables[slot, j])
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)
            self._tables[slot, j] = TRASH_PAGE
        self._n_blocks[slot] = keep
        if keep and new_len % self.page_size:
            pid = int(self._tables[slot, keep - 1])
            if self._ref[pid] > 1:
                if not self._free:
                    raise PagesExhausted(
                        "no free page for copy-on-shrink of a shared page")
                new_pid = self._free.pop()
                self._ref[pid] -= 1
                self._ref[new_pid] = 1
                self._tables[slot, keep - 1] = new_pid
                _copy_page(cache, pid, new_pid)
        if self.check:
            self.validate()
        return cache

    def mapped_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self._tables[slot, :self._n_blocks[slot]]]

    def refcount(self, page_id: int) -> int:
        return int(self._ref[page_id])

    # -- runtime self-check --------------------------------------------
    def validate(self) -> None:
        """Prove the allocator invariants; raise
        :class:`PagedCacheCorruption` naming the first violated one.

        Called after every mutating op when ``check=True`` (and directly
        by the batcher's per-step hook); safe to call at any time.
        """
        free = self._free
        if len(set(free)) != len(free):
            raise PagedCacheCorruption("free list holds duplicate page ids")
        for pid in free:
            if not (TRASH_PAGE < pid < self.n_pages):
                raise PagedCacheCorruption(
                    f"free list holds out-of-range page id {pid}")
            if self._ref[pid] != 0:
                raise PagedCacheCorruption(
                    f"free page {pid} has ref-count {int(self._ref[pid])}")
        if self._ref[TRASH_PAGE] != 0:
            raise PagedCacheCorruption("trash page has a non-zero ref-count")
        # count table occurrences of every real page
        occ = np.zeros((self.n_pages,), np.int64)
        for slot in range(self.max_slots):
            n = int(self._n_blocks[slot])
            row = self._tables[slot]
            for j in range(self.blocks_per_slot):
                pid = int(row[j])
                if not (0 <= pid < self.n_pages):
                    raise PagedCacheCorruption(
                        f"slot {slot} block {j} maps out-of-range page {pid}")
                if j >= n:
                    if pid != TRASH_PAGE:
                        raise PagedCacheCorruption(
                            f"slot {slot} block {j} beyond its {n} mapped "
                            f"pages points at page {pid}, not trash")
                elif pid == TRASH_PAGE:
                    raise PagedCacheCorruption(
                        f"slot {slot} block {j} inside its {n} mapped pages "
                        f"points at the trash page")
                else:
                    occ[pid] += 1
        for pid in range(TRASH_PAGE + 1, self.n_pages):
            if int(self._ref[pid]) != int(occ[pid]):
                raise PagedCacheCorruption(
                    f"page {pid}: ref-count {int(self._ref[pid])} != "
                    f"{int(occ[pid])} block-table occurrence(s)")
        referenced = int((self._ref > 0).sum())
        if len(free) + referenced != self.usable_pages:
            raise PagedCacheCorruption(
                f"page accounting drift: {len(free)} free + {referenced} "
                f"referenced != {self.usable_pages} usable")

    def stats(self) -> Dict:
        """Cheap allocator counters (O(n_pages), no device sync) — safe to
        poll every request even with ``check=False``.

        ``pages_leaked`` is the gap between pool capacity and what the
        free list plus live ref-counts account for: non-zero means pages
        were lost to ref-count drift.  ``refcount_max`` is the high-water
        sharing degree (>= 2 once any prefix was forked/deduped).
        """
        referenced = int((self._ref > 0).sum())
        return {
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "usable_pages": self.usable_pages,
            "free_pages": len(self._free),
            "mapped_pages": referenced,
            "pages_leaked": self.usable_pages - len(self._free) - referenced,
            "refcount_max": self._refcount_max,
        }

    def close(self) -> Dict:
        """End-of-life audit: returns :meth:`stats`; with ``check=True``
        raises :class:`PagedCacheCorruption` when pages leaked (pages
        still mapped by live slots are fine — the batcher may close
        mid-flight — only unaccounted-for pages count as leaks)."""
        st = self.stats()
        if self.check and st["pages_leaked"]:
            raise PagedCacheCorruption(
                f"{st['pages_leaked']} page(s) leaked at close "
                f"(free {st['free_pages']} + mapped {st['mapped_pages']} "
                f"< usable {st['usable_pages']})")
        return st


def _copy_page(cache: Dict, src_pid: int, dst_pid: int) -> None:
    """Copy page ``src_pid`` onto ``dst_pid`` in every pool, in place."""
    for key, pool in cache.items():
        if key.startswith("pages_"):
            pool[dst_pid] = pool[src_pid]


def slot_view(cache: Dict, slot: int, length: int = 0) -> Dict:
    """A batch-1 view of a paged cache for admission prefill: the pools
    are shared (writes scatter into the slot's mapped pages), only the
    block-table row and length are sliced — no buffer copies.
    ``length`` is the slot's already-materialized KV length (non-zero when
    continuing a chunked prefill mid-prompt)."""
    one = {k: v for k, v in cache.items()
           if k.startswith("pages_")}
    bt = cache["block_tables"]
    one["block_tables"] = bt[slot:slot + 1]
    one["len"] = torch.tensor(length, dtype=torch.int32, device=bt.device)
    return one
