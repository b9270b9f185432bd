"""The port's backend forward against the JAX package's: the same params
(JAX ``init_params`` through ``params_from_numpy``) and tokens give
prefill and decode logits within atol 1e-4 (fp32; the paged attention
runs the plain versions on the CPU on both sides), with a dense cache,
fp32 pages and int8 pages, on ``tiny`` (GQA group 2) and a reduced
OPT (MHA, learned positions, layernorm, biases, tied head).  The port's
own ``init_params`` must produce the JAX package's tree layout."""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.serving.kv_cache import PagedKVCache as JKV
from repro_torch.models import model as TM
from repro_torch.serving.kv_cache import PagedKVCache as TKV

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=["tiny", "opt-125m"])
def setup(request):
    cfg = get_config(request.param)
    if request.param != "tiny":
        cfg = reduced(cfg)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    jsh, jw, jb = JM.extract_backend_params(cfg, jp)
    tsh, tw, tb = TM.extract_backend_params(cfg, tp)

    def jlin(x, n):
        y = x @ jw[n]
        return y + jb[n] if n in jb else y

    # the reference forward jitted: one compile per shape instead of
    # JAX's eager per-op dispatch (same arithmetic)
    jfwd = jax.jit(lambda sh, batch, cache, all_logits=False:
                   JM.backend_prefill(cfg, sh, batch, cache, linear=jlin,
                                      all_logits=all_logits),
                   static_argnames=("all_logits",))

    def tlin(x, n):
        y = x @ tw[n]
        return y + tb[n] if n in tb else y

    return cfg, (jsh, jfwd), (tsh, tlin)


def _caches(cfg, kind, b, max_len):
    if kind == "dense":
        return (JM.init_backend_cache(cfg, b, max_len),
                TM.init_backend_cache(cfg, b, max_len, device="cpu"))
    kv_dtype = "int8" if kind == "int8" else None
    jkv = JKV(cfg, b, max_len, page_size=8, kv_dtype=kv_dtype)
    tkv = TKV(cfg, b, max_len, page_size=8, kv_dtype=kv_dtype, device="cpu")
    for kv in (jkv, tkv):
        kv.alloc(1, 20)              # slot 1 first: non-identity tables
        kv.alloc(0, 20)
    jc, tc = jkv.init_cache(), tkv.init_cache()
    jc["len"] = jnp.zeros((), jnp.int32)
    tc["len"] = torch.zeros((), dtype=torch.int32)
    return jc, tc


@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
def test_prefill_decode_logits_match(setup, kind):
    cfg, (jsh, jfwd), (tsh, tlin) = setup
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc, tc = _caches(cfg, kind, 2, 32)
    jc, jl = jfwd(jsh, {"tokens": jnp.asarray(toks)}, jc, all_logits=True)
    tc, tl = TM.backend_prefill(cfg, tsh, {"tokens": torch.from_numpy(toks)},
                                tc, linear=tlin, all_logits=True)
    assert tl.shape == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # decode at per-slot lengths (the continuous-batching shape)
    lens = np.asarray([9, 7], np.int32)
    jc["len"] = jnp.asarray(lens)
    tc["len"] = torch.from_numpy(lens)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jfwd(jsh, {"tokens": jnp.asarray(tok)[:, None]}, jc)
        tc, tl = TM.backend_decode(cfg, tsh, torch.from_numpy(tok), tc,
                                   linear=tlin)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if kind == "int8":
        # the written pages agree to one int8 step (k/v themselves differ
        # in the last fp32 bits), their scales to fp32 rounding
        for l in range(cfg.n_layers):
            diff = np.abs(tc[f"pages_k{l}"].numpy().astype(np.int32)
                          - np.asarray(jc[f"pages_k{l}"]).astype(np.int32))
            assert diff.max() <= 1
            np.testing.assert_allclose(tc[f"pages_vs{l}"].numpy(),
                                       np.asarray(jc[f"pages_vs{l}"]),
                                       rtol=1e-5, atol=0)


def test_chunked_prefill_offsets_match(setup):
    """A prompt prefilled in two chunks through a batch-1 view (scalar
    length > 0, the chunked-admission shape) gives the JAX logits."""
    cfg, (jsh, jfwd), (tsh, tlin) = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jc, tc = _caches(cfg, "paged", 2, 32)
    for c in (jc, tc):
        c["block_tables"] = c["block_tables"][1:2]
    for lo, hi in ((0, 5), (5, 13)):
        jc["len"] = jnp.asarray(lo, jnp.int32)
        tc["len"] = torch.tensor(lo, dtype=torch.int32)
        jc, jl = jfwd(jsh, {"tokens": jnp.asarray(toks[:, lo:hi])}, jc)
        tc, tl = TM.backend_prefill(cfg, tsh,
                                    {"tokens": torch.from_numpy(
                                        toks[:, lo:hi])},
                                    tc, linear=tlin)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_init_params_tree_layout(setup):
    cfg = setup[0]
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j_leaves = jtu.tree_flatten_with_path(jp)[0]
    t_flat = jtu.tree_flatten_with_path(
        jtu.tree_map(lambda t: t.numpy(), tp))[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in t_flat]
    for (_, a), (_, b) in zip(j_leaves, t_flat):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype
    assert np.isfinite(tp["embed"].numpy()).all()
