"""The port's dense layer math against the JAX package's, on the same
numpy inputs (atol 1e-5: fp32 on both sides, different summation
orders)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro_torch.kernels import ops as TK
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(name, **kw):
    cfg = get_config(name)
    if name != "tiny":
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **kw)


def _pair(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("plus_one", [False, True])
def test_norms(plus_one):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, 2, 5, 64)
    js, ts = _pair(rng, 64)
    jb, tb = _pair(rng, 64)
    _close(TK.rmsnorm(tx, ts, eps=1e-6, plus_one=plus_one),
           JL.rmsnorm(jx, js, 1e-6, plus_one))
    _close(TL.layernorm(tx, ts, tb, 1e-5), JL.layernorm(jx, js, jb, 1e-5))
    for name in ("tiny", "opt-125m"):
        cfg = _cfg(name, post_norm=plus_one)
        p_j = {"scale": js, "bias": jb}
        p_t = {"scale": ts, "bias": tb}
        _close(TL.apply_norm(cfg, p_t, tx), JL.apply_norm(cfg, p_j, jx))


def test_rope_and_softcap():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 300, (2, 7))
    _close(TL.rope(tx, torch.from_numpy(pos), 10_000.0),
           JL.rope(jx, jnp.asarray(pos), 10_000.0))
    jy, ty = _pair(rng, 3, 9, scale=40.0)
    _close(TL.softcap(ty, 30.0), JL.softcap(jy, 30.0))
    assert TL.softcap(ty, None) is ty


@pytest.mark.parametrize("name,window,cap", [
    ("tiny", None, None), ("tiny", 3, 20.0), ("opt-125m", None, None)])
def test_qkv_attention_out(name, window, cap):
    """gqa_qkv -> attention over a dense (B, T, Hkv, hd) cache with a
    per-slot kv_len -> attn_out, parameters through the ``p`` dicts."""
    cfg = _cfg(name)
    rng = np.random.default_rng(2)
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    names = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
             "wo": (hq * hd, d), "bq": (hq * hd,), "bk": (hkv * hd,),
             "bv": (hkv * hd,), "bo": (d,)}
    pj, pt = {}, {}
    for k, shp in names.items():
        pj[k], pt[k] = _pair(rng, *shp, scale=0.2)
    jx, tx = _pair(rng, 2, 5, d)
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    jq, jk, jv = JL.gqa_qkv(cfg, pj, jx, jnp.asarray(pos))
    tq, tk, tv = TL.gqa_qkv(cfg, pt, tx, torch.from_numpy(pos))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        _close(a, b)
    jkc, tkc = _pair(rng, 2, 12, hkv, hd)
    jvc, tvc = _pair(rng, 2, 12, hkv, hd)
    kv_len = np.asarray([8, 5], np.int32)
    kvpos = np.arange(12)[None]
    jo = JL.attention(jq, jkc, jvc, q_positions=jnp.asarray(pos),
                      kv_positions=jnp.asarray(kvpos),
                      kv_len=jnp.asarray(kv_len), window=window,
                      attn_softcap=cap)
    to = TL.attention(tq, tkc, tvc, q_positions=torch.from_numpy(pos),
                      kv_positions=torch.from_numpy(kvpos),
                      kv_len=torch.from_numpy(kv_len), window=window,
                      attn_softcap=cap)
    _close(to, jo)
    _close(TL.attn_out(cfg, pt, to), JL.attn_out(cfg, pj, jo))


@pytest.mark.parametrize("kind", ["gated_silu", "gated_gelu", "relu2",
                                  "gelu", "relu"])
def test_mlp_kinds(kind):
    cfg = _cfg("opt-125m", mlp_kind=kind)
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    pj, pt = {}, {}
    for k, shp in {"w_gate": (d, f), "w_up": (d, f), "w_in": (d, f),
                   "w_down": (f, d), "b_in": (f,), "b_down": (d,)}.items():
        pj[k], pt[k] = _pair(rng, *shp, scale=0.2)
    jx, tx = _pair(rng, 2, 3, d)
    _close(TL.mlp(cfg, pt, tx), JL.mlp(cfg, pj, jx))


@pytest.mark.parametrize("kv_format", ["bthd", "bhtd"])
def test_attention_chunks_queries_as_reference(kv_format):
    """Sq 4096 over Skv 2304 is past 4096 * 2048, so the reference scans
    four query chunks of 1024; the port loops over them.  Causal with a
    window of 512 and a softcap, fp32: within 1e-5 of the reference, and
    within 1e-6 of the port's own unchunked path (a chunk_q that does not
    divide Sq), the same arithmetic row by row."""
    rng = np.random.default_rng(7)
    b, sq, skv, h, d = 1, 4096, 2304, 2, 16
    jq, tq = _pair(rng, b, sq, h, d)
    kv_shape = (b, skv, h, d) if kv_format == "bthd" else (b, h, skv, d)
    jk, tk = _pair(rng, *kv_shape)
    jv, tv = _pair(rng, *kv_shape)
    qpos = (np.arange(sq) * 9 // 16)[None]          # 0 .. 2303
    kvpos = np.arange(skv)[None]
    kw = dict(causal=True, window=512, attn_softcap=20.0,
              kv_format=kv_format)
    want = JL.attention(jq, jk, jv, q_positions=jnp.asarray(qpos),
                        kv_positions=jnp.asarray(kvpos), **kw)
    args = dict(q_positions=torch.from_numpy(qpos),
                kv_positions=torch.from_numpy(kvpos), **kw)
    chunked = TL.attention(tq, tk, tv, **args)
    whole = TL.attention(tq, tk, tv, chunk_q=3000, **args)
    _close(chunked, want)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
