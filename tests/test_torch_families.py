"""The scan-stacked families of the port against the JAX package, on the
same weights (JAX ``init_params`` through ``params_from_numpy``) and the
same seeded numpy inputs, at ``reduced()`` sizes:

* Gemma-2 (local/global layers with a window, attention and logit
  softcaps, sandwich ``(1+w)`` norms, scaled embeddings), MiniCPM3 (MLA
  over the compressed cache), Llama-4 Scout (every layer MoE with a
  shared expert), Maverick (dense/MoE alternation) and Zamba2 (a Mamba2
  trunk with the shared block, its per-site LoRA and the tail layers):
  prefill and decode logits within 1e-4 of the largest |logit| in fp32
  and 2e-2 in bf16, and identical greedy tokens from ``Generator``;
* MoE routing: expert indices and capacity drops identical at a group
  size where tokens are dropped, the layer's output and the whole
  model's logits within tolerance, and dropless decode;
* MLA's three steps against the JAX package's, layer by layer;
* ``ScanResidentBackend`` under ``ContinuousBatcher(cfg, params)`` and
  ``LLM(paged=False)`` against the JAX package's batcher, token for
  token, with chunked admissions and a priority preemption whose resume
  merges the slot along ``cache_batch_axis`` 1;
* every configuration the JAX package registers has the same fields in
  the port, and ``ASSIGNED_ARCHS`` is the same;
* what the port refuses as the JAX package does: the dense batcher takes
  no hybrid and no encoder-decoder, the scan-stacked cache no pages.

The zero-initialised parameters that would hide a mechanism (Gemma's
``(1+w)`` norm scales, Zamba2's LoRA ``b``) are drawn at random first, on
both sides alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config, list_archs, reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.serving.batcher import ContinuousBatcher as JCB
from repro.serving.engine import Generator as JGen
from repro_torch.configs import ASSIGNED_ARCHS as T_ASSIGNED_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops as K
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import ResidentBackend, ScanResidentBackend
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import Generator

FAMILIES = ["gemma2-2b", "minicpm3-4b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-a17b", "zamba2-1.2b"]
MOE = ["llama4-scout-17b-16e", "llama4-maverick-400b-a17b"]
BATCHED = ["gemma2-2b", "minicpm3-4b", "llama4-scout-17b-16e"]
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT = 20                          # SSD chunk 16 reduced: a scan prefill


def _cfg(name, dtype="float32", **kw):
    return dataclasses.replace(reduced(get_config(name)), dtype=dtype, **kw)


def _perturb(tree, rng):
    """Draw the leaves that start at zero and would hide a mechanism."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        a = np.asarray(t)
        norm = path[-1] == "scale" and not a.any()          # (1+w) norms
        lora_b = path[-2:] == ("shared_lora", "b")
        if norm or lora_b:
            r = rng.standard_normal(a.shape).astype(np.float32)
            return (0.2 * r if norm else 0.05 * r).astype(a.dtype)
        return a
    return walk(tree, ())


def _params(cfg, seed=0):
    tree = _perturb(jtu.tree_map(np.asarray,
                                 JM.init_params(cfg, jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed))
    return (jtu.tree_map(jnp.asarray, tree),
            TM.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg = _cfg(request.param)
    jp, tp = _params(cfg)
    return cfg, jp, tp


@pytest.fixture
def bf16_dots(monkeypatch):
    """This CPU's XLA has no bf16 x bf16 -> fp32 dot, which the JAX
    package's attention asks for (``preferred_element_type=float32``).
    Widen such operands to fp32 first: bf16 products are exact in fp32 and
    the sum is fp32 either way, so the arithmetic is the same."""
    einsum = jnp.einsum

    def widened(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return einsum(spec, *ops,
                      preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", widened)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list_archs())
def test_port_configs_mirror_the_jax_package(name):
    assert dataclasses.asdict(t_get_config(name)) \
        == dataclasses.asdict(get_config(name))
    assert dataclasses.asdict(t_reduced(t_get_config(name))) \
        == dataclasses.asdict(reduced(get_config(name)))


def test_port_registry_is_the_jax_packages():
    assert t_list_archs() == list_archs()
    assert T_ASSIGNED_ARCHS == ASSIGNED_ARCHS


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match(name, dtype, bf16_dots):
    cfg = _cfg(name, dtype)
    jp, tp = _params(cfg)
    rel = REL_TOL[dtype]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, PROMPT + 4)
    tc = TM.init_cache(cfg, 2, PROMPT + 4, device="cpu")
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
    jc, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, rel)
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jc, jl = JM.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tc, tl = TM.decode_step(cfg, tp, torch.from_numpy(tok), tc)
        _close(tl, jl, rel)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert int(tc["len"]) == int(jc["len"]) == PROMPT + 3
    for k in jc:                               # every cache leaf agrees
        if k != "len":
            _close(tc[k], jc[k], rel)


def test_greedy_tokens_match(family):
    cfg, jp, tp = family
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = JGen(cfg, jp).generate({"tokens": jnp.asarray(prompts)}, 6)
    got = Generator(cfg, tp).generate({"tokens": prompts}, 6)
    assert got.tokens == want.tokens
    with LLM(cfg, tp, device="cpu") as llm:
        out = llm.generate([list(r) for r in prompts], max_new=6)
        assert llm.last_executor == "generator"
    assert [o.tokens for o in out] == want.tokens


def test_init_params_tree_matches_the_jax_package(family):
    cfg, jp, _ = family
    mine = TM.init_params(cfg, 0, device="cpu")
    want = jtu.tree_map(np.asarray, jp)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert shapes(mine) == shapes(want)


def _jax_route(cfg, router, xg, cap):
    """The JAX package's top-1 routing of ``moe`` (layers.py), written out
    so that its indices and drops can be read."""
    logits = (xg @ router.astype(xg.dtype)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    idx = jnp.argmax(gates, axis=-1)
    onehot = jax.nn.one_hot(idx, cfg.n_experts, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=1) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    return np.asarray(idx), np.asarray(keep.any(-1))


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_routing_and_drops_match(name, dtype, bf16_dots):
    cfg = _cfg(name, dtype, capacity_factor=1.25, moe_group_size=8)
    jp, tp = _params(cfg)
    rel = REL_TOL[dtype]
    j = 1 if name.startswith("llama4-maverick") else 0      # the MoE slot
    jmoe = jtu.tree_map(lambda a: a[0], jp["blocks"][f"pos{j}"]["moe"])
    tmoe = TM._pick(tp["blocks"][f"pos{j}"]["moe"], 0)
    # tokens near one common direction crowd onto a few experts
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(cfg.d_model)
         + 0.5 * rng.standard_normal((2, 12, cfg.d_model))).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(TM.torch_dtype(cfg))
    gs, groups = 8, 3                                   # 24 tokens
    cap = int(np.ceil(gs * cfg.capacity_factor / cfg.n_experts))
    idx, gate, slot, keep = TL.moe_route(cfg, tmoe, tx.reshape(groups, gs, -1),
                                         capacity=cap)
    want_idx, want_keep = _jax_route(cfg, jmoe["router"],
                                     jx.reshape(groups, gs, -1), cap)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()                          # tokens were dropped
    _close(TL.moe(cfg, tmoe, tx), JL.moe(cfg, jmoe, jx), rel)
    # decode: dropless (capacity = batch), every token its expert
    _close(TL.moe(cfg, tmoe, tx[:, :1]), JL.moe(cfg, jmoe, jx[:, :1]), rel)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _, jl = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks)},
                       JM.init_cache(cfg, 2, 16))
    _, tl = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       TM.init_cache(cfg, 2, 16, device="cpu"))
    _close(tl, jl, rel)


def test_mla_steps_match():
    cfg = _cfg("minicpm3-4b")
    jp, tp = _params(cfg)
    ja = jtu.tree_map(lambda a: a[0], jp["blocks"]["pos0"]["attn"])
    ta = TM._pick(tp["blocks"]["pos0"]["attn"], 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    jq = JL.mla_project_q(cfg, ja, jx, jpos)
    tq = TL.mla_project_q(cfg, ta, tx, tpos)
    jkv = JL.mla_latent_kv(cfg, ja, jx, jpos)
    tkv = TL.mla_latent_kv(cfg, ta, tx, tpos)
    for got, want in zip(tq + tkv, jq + jkv):
        _close(got, want, 1e-5)
    kvpos = np.arange(7, dtype=np.int32)[None] + 3
    want = JL.mla_attend(cfg, ja, *jq, *jkv, q_positions=jpos,
                         kv_positions=jnp.asarray(kvpos), kv_len=10)
    got = TL.mla_attend(cfg, ta, *tq, *tkv, q_positions=tpos,
                        kv_positions=torch.from_numpy(kvpos),
                        kv_len=torch.tensor(10))
    _close(got, want, 1e-5)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, cfg.vocab_size, n)) for n in lens]


@pytest.mark.parametrize("name", BATCHED)
def test_scan_resident_batcher_matches_jax(name):
    cfg = _cfg(name)
    jp, tp = _params(cfg)
    p = _prompts(cfg, (5, 11, 8, 11), seed=7)
    kw = dict(max_slots=2, max_len=40, chunk_tokens=6)
    jb = JCB(cfg, jp, **kw)
    tb = ContinuousBatcher(cfg, tp, device="cpu", **kw)
    assert isinstance(tb.backend, ScanResidentBackend)
    assert tb.backend.cache_batch_axis == 1
    want = [jb.submit(pi, 5) for pi in p]
    got = [tb.submit(pi, 5) for pi in p]
    wo, go = jb.run_until_done(), tb.run_until_done()
    tb.close()
    assert [go[r] for r in got] == [wo[r] for r in want]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=40) as llm:
        outs = llm.generate(p, max_new=5)
        assert llm.last_executor == "batcher"
        assert isinstance(llm.backend, ScanResidentBackend)
    with JLLM(cfg, jp, max_slots=2, max_len=40) as jllm:
        jout = jllm.generate(p, max_new=5)
    assert [o.tokens for o in outs] == [o.tokens for o in jout]


@pytest.mark.parametrize("name", ["gemma2-2b", "minicpm3-4b"])
def test_stacked_slot_merge_under_preemption(name):
    """A priority arrival evicts a running request of the dense batcher;
    its recompute resume prefills a private stacked cache and merges that
    row into its new slot along axis 1.  Tokens equal an unpressed run's
    and the JAX package's under the same schedule."""
    cfg = _cfg(name)
    jp, tp = _params(cfg)
    p = _prompts(cfg, (6, 9, 7), seed=8)

    def serve(make, params, slots, **kw):
        b = make(cfg, params, max_slots=slots, max_len=40,
                 policy="priority", **kw)
        rids = [b.submit(p[0], 6), b.submit(p[1], 6)]
        b.step()
        b.step()
        rids.append(b.submit(p[2], 6, priority=5))
        out = b.run_until_done()
        pre = b.scheduler.preemptions
        b.close()
        return [out[r] for r in rids], pre

    pressed, n = serve(ContinuousBatcher, tp, 2, device="cpu")
    free, n0 = serve(ContinuousBatcher, tp, 3, device="cpu")
    jax_pressed, jn = serve(JCB, jp, 2)
    assert n > 0 and n0 == 0 and jn == n
    assert pressed == free == jax_pressed


def test_merge_honours_cache_batch_axis():
    """``_merge_dense`` writes the private cache's row into the slot along
    the backend's batch axis: the stacked cache's axis 1, the per-layer
    cache's axis 0."""
    cfg = _cfg("gemma2-2b")
    _, tp = _params(cfg)
    toks = torch.tensor([_prompts(cfg, (6,), seed=9)[0]], dtype=torch.int32)
    for be in (ScanResidentBackend(cfg, tp, device="cpu"),
               ResidentBackend(cfg, tp, device="cpu")):
        b = ContinuousBatcher(cfg, backend=be, max_slots=3, max_len=16)
        one, _ = be.prefill({"tokens": toks}, be.init_cache(1, 16))
        b._merge_dense(2, one)
        ax = be.cache_batch_axis
        for key, glob in b.cache.items():
            if key == "len":
                continue
            assert torch.equal(glob.select(ax, 2), one[key].select(ax, 0))
            assert not glob.select(ax, 0).any()


def test_paged_batcher_takes_a_paged_backend():
    """Without a backend the batcher builds the ScanResidentBackend, whose
    stacked cache does not page, as in the JAX package: paged serving
    raises there, and ``LLM(paged=True)`` hands the batcher a
    ResidentBackend, which serves the dense batcher's tokens."""
    cfg = _cfg("gemma2-2b")
    _, tp = _params(cfg)
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(cfg, tp, device="cpu", paged=True, page_size=8)
    p = _prompts(cfg, (5, 11, 8), seed=11)
    kw = dict(device="cpu", max_slots=2, max_len=40)
    with LLM(cfg, tp, paged=True, page_size=8, **kw) as llm:
        assert isinstance(llm.backend, ResidentBackend)
        paged = [o.tokens for o in llm.generate(p, max_new=5)]
    with LLM(cfg, tp, **kw) as llm:
        dense = [o.tokens for o in llm.generate(p, max_new=5)]
        assert isinstance(llm.backend, ScanResidentBackend)
    assert paged == dense


def test_unported_families_still_raise():
    # the batcher takes no encoder-decoder (its cross K/V are per request),
    # as the JAX package's refuses it
    cfg = _cfg("whisper-small")
    tp = TM.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        JCB(cfg, None)
    # the batcher takes transformer caches only; the hybrid serves one-shot
    cfg = _cfg("zamba2-1.2b")
    _, tp = _params(cfg)
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(cfg, tp, device="cpu")
    with LLM(cfg, tp, device="cpu") as llm:
        p = _prompts(cfg, (8, 8), seed=10)
        llm.generate(p, max_new=3)
        assert llm.last_executor == "generator"
        with pytest.raises(NotImplementedError):
            llm.generate([p[0], p[1][:5]], max_new=3)
    with pytest.raises(NotImplementedError):
        LLM(cfg, tp, device="cpu", paged=True)
    # the scan-stacked cache is not pageable
    cfg = _cfg("gemma2-2b")
    _, tp = _params(cfg)
    with pytest.raises(NotImplementedError):
        ScanResidentBackend(cfg, tp, device="cpu").init_paged_cache(2, 16)


def test_families_launch_no_kernel_on_the_cpu(family):
    cfg, _, tp = family
    K.reset_launch_counts()
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int32))
    TM.prefill(cfg, tp, {"tokens": toks},
               TM.init_cache(cfg, 1, PROMPT, device="cpu"))
    assert not any(K.launch_counts().values())
