"""The port's paged KV cache, mirroring tests/test_kv_cache.py: allocator
invariants (all-or-nothing alloc, ref-counted fork, copy-on-shrink
truncate), slot views sharing the pools, in-place pool updates, and the
paged batcher equal to the dense one token for token."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.serving.backends import ResidentBackend
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kv_cache import (TRASH_PAGE, PagedCacheCorruption,
                                          PagedKVCache, PagesExhausted,
                                          slot_view)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    return cfg, M.init_params(cfg, 0, device="cpu")


def _consistent(kv: PagedKVCache):
    mapped = {}
    for s in range(kv.max_slots):
        for pid in kv.mapped_pages(s):
            mapped[pid] = mapped.get(pid, 0) + 1
    assert TRASH_PAGE not in mapped
    for pid, cnt in mapped.items():
        assert kv.refcount(pid) == cnt
    assert len(kv._free) + len(mapped) == kv.n_pages - 1
    kv.validate()


def test_alloc_all_or_nothing(tiny):
    cfg, _ = tiny
    kv = PagedKVCache(cfg, 2, 64, page_size=8, n_pages=3, device="cpu")
    with pytest.raises(PagesExhausted):
        kv.alloc(0, 24)
    assert kv.free_pages == 2 and kv.mapped_pages(0) == []
    with pytest.raises(ValueError):
        kv.alloc(0, 100)
    kv.alloc(0, 16)
    assert kv.free_pages == 0 and len(kv.mapped_pages(0)) == 2


def test_fork_shares_pages_in_place(tiny):
    cfg, _ = tiny
    kv = PagedKVCache(cfg, 2, 64, page_size=8, device="cpu")
    kv.alloc(0, 20)
    cache = kv.init_cache()
    pool = cache["pages_k0"]
    for j, pid in enumerate(kv.mapped_pages(0)):
        pool[pid] = float(j + 1)
    out = kv.fork(cache, 0, 1, 17)
    assert out is cache and out["pages_k0"] is pool        # in place
    src, dst = kv.mapped_pages(0), kv.mapped_pages(1)
    assert dst[:2] == src[:2] and dst[2] != src[2]
    assert kv.refcount(src[0]) == 2 and kv.refcount(dst[2]) == 1
    torch.testing.assert_close(pool[dst[2]], pool[src[2]])
    g = ref.gather_pages(pool, kv.device_block_tables())
    torch.testing.assert_close(g[0, :, :17], g[1, :, :17])
    kv.free(0)
    kv.free(1)
    assert kv.free_pages == kv.n_pages - 1
    assert kv.stats()["refcount_max"] >= 2


def test_truncate_copies_shared_partial_page(tiny):
    cfg, _ = tiny
    kv = PagedKVCache(cfg, 2, 64, page_size=8, device="cpu")
    kv.alloc(0, 20)
    cache = kv.init_cache()
    for j, pid in enumerate(kv.mapped_pages(0)):
        cache["pages_v1"][pid] = float(j + 1)
    kv.fork(cache, 0, 1, 16)
    src = kv.mapped_pages(0)
    free0 = kv.free_pages
    kv.truncate(cache, 0, 12)
    now = kv.mapped_pages(0)
    assert now[0] == src[0] and now[1] != src[1]
    torch.testing.assert_close(cache["pages_v1"][now[1]],
                               cache["pages_v1"][src[1]])
    assert kv.mapped_pages(1) == src[:2] and kv.free_pages == free0
    _consistent(kv)


def test_selfcheck_catches_double_release(tiny):
    cfg, _ = tiny
    kv = PagedKVCache(cfg, 2, 32, page_size=8, check=True, device="cpu")
    kv.alloc(0, 9)
    kv.free(0)
    with pytest.raises(PagedCacheCorruption):
        kv.free(0)


def test_slot_view_and_pool_layout(tiny):
    cfg, _ = tiny
    kv = PagedKVCache(cfg, 3, 32, page_size=8, kv_dtype="int8",
                      device="cpu")
    kv.alloc(1, 10)
    cache = kv.init_cache()
    assert cache["pages_k0"].shape == (kv.n_pages, cfg.n_kv_heads, 8,
                                       cfg.hd)
    assert cache["pages_k0"].dtype == torch.int8
    assert cache["pages_ks0"].shape == (kv.n_pages, cfg.n_kv_heads, 8)
    one = slot_view(cache, 1, length=5)
    assert one["pages_k0"] is cache["pages_k0"]
    assert one["block_tables"].shape == (1, kv.blocks_per_slot)
    assert one["len"].shape == () and int(one["len"]) == 5


def _run(b, prompts, max_news):
    rids = [b.submit(p, m) for p, m in zip(prompts, max_news)]
    out = b.run_until_done()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kw", [dict(), dict(n_pages=3, page_size=8),
                                dict(chunk_tokens=3, prefix_dedupe=True)])
def test_paged_batcher_matches_dense(tiny, kw):
    """Interleaved admit/release; a small pool forces preemption (swap
    mode saves copies of the pages, which later writes must not touch);
    chunked admission with prefix dedupe."""
    cfg, params = tiny
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, k))
               for k in (5, 9, 3, 7, 4)]
    prompts[3][:4] = prompts[1][:4]                 # a shared prefix
    max_news = [6, 4, 5, 3, 7]
    be = ResidentBackend(cfg, params, device="cpu")
    dense = _run(ContinuousBatcher(cfg, backend=be, max_slots=2,
                                   max_len=32), prompts, max_news)
    page_size = kw.pop("page_size", 4)
    pb = ContinuousBatcher(cfg, backend=be, max_slots=2, max_len=32,
                           paged=True, page_size=page_size, selfcheck=True,
                           **kw)
    assert _run(pb, prompts, max_news) == dense
    assert pb.kv.free_pages == pb.kv.n_pages - 1
    if "n_pages" in kw:
        assert pb.scheduler.preemptions > 0
    _consistent(pb.kv)
