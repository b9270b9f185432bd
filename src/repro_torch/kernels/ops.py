"""Dispatch layer: one entry point per kernel.

The tensor decides the route, and nothing else does: a CPU tensor runs the
plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel (or the wrapper raises on what the
kernel does not take).  There is no fallback and no mode switch.

Each kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show
that its main path went through the kernels.  Beside them the model
counts, through :func:`count_plain`, the calls on a CUDA tensor that take
a plain branch by design: ``plain_dense_attention`` (dense-cache
attention for a chunk at a cache offset above 0, or decode in a windowed
layer) and ``plain_ssd_scan`` (a Mamba2 prefill whose length is not a
multiple of the SSD chunk, or not above one chunk).  A run that should
reach only kernels reads both as 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _dense_decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hete_matmul as _mm
from repro_torch.kernels import paged_attention as _decode
from repro_torch.kernels import paged_prefill as _prefill
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_chunk as _ssd


# the plain branches the model takes by design, counted on CUDA tensors
_PLAIN = {"plain_dense_attention": 0, "plain_ssd_scan": 0}


def count_plain(name: str, t: torch.Tensor) -> None:
    """Count one call of the plain branch ``name`` (a key of the counts
    :func:`launch_counts` reads) when ``t`` lies on the card."""
    if _route(t) == "cuda":
        _PLAIN[name] += 1


_WRAPPERS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
    "q8_matmul": _q8.q8_matmul,
    "decode_attention": _dense_decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "rmsnorm": _rms.rmsnorm,
    "ssd_chunk": _ssd.ssd_chunk,
    "matmul": _mm.matmul,
    "gated_matmul": _mm.gated_matmul,
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def launch_counts() -> Dict[str, int]:
    return {**{name: fn.launches for name, fn in _WRAPPERS.items()},
            **_PLAIN}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for name in _PLAIN:
        _PLAIN[name] = 0


def q8_matmul(x, q, scale):
    if _route(x) == "cpu":
        return _ref.q8_matmul(x, q, scale)
    return _q8.q8_matmul(x, q, scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len, *,
                           k_scale=None, v_scale=None, softcap=None):
    if _route(q) == "cpu":
        return _ref.paged_decode_attention(
            q, k_pages, v_pages, block_tables, kv_len,
            k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    return _decode.paged_decode_attention(
        q, k_pages, v_pages, block_tables, kv_len,
        k_scale=k_scale, v_scale=v_scale, softcap=softcap)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_offset, *,
                            k_scale=None, v_scale=None, softcap=None,
                            window=None):
    if _route(q) == "cpu":
        return _ref.paged_prefill_attention(
            q, k_pages, v_pages, block_tables, kv_offset,
            k_scale=k_scale, v_scale=v_scale, softcap=softcap, window=window)
    return _prefill.paged_prefill_attention(
        q, k_pages, v_pages, block_tables, kv_offset,
        k_scale=k_scale, v_scale=v_scale, softcap=softcap, window=window)


def decode_attention(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                     softcap=None):
    if _route(q) == "cpu":
        return _ref.decode_attention(q, k, v, kv_len, k_scale=k_scale,
                                     v_scale=v_scale, softcap=softcap)
    return _dense_decode.decode_attention(q, k, v, kv_len, k_scale=k_scale,
                                          v_scale=v_scale, softcap=softcap)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    if _route(q) == "cpu":
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)


def rmsnorm(x, scale, *, eps=1e-6, plus_one=False):
    if _route(x) == "cpu":
        return _ref.rmsnorm(x, scale, eps=eps, plus_one=plus_one)
    return _rms.rmsnorm(x, scale, eps=eps, plus_one=plus_one)


def ssd_chunk(x, dt, a, b, c, *, chunk):
    if _route(x) == "cpu":
        return _ref.ssd_chunk(x, dt, a, b, c, chunk=chunk)
    return _ssd.ssd_chunk(x, dt, a, b, c, chunk=chunk)


def matmul(x, w, bias=None, *, activation=None):
    if _route(x) == "cpu":
        return _ref.matmul(x, w, bias, activation=activation)
    return _mm.matmul(x, w, bias, activation=activation)


def gated_matmul(x, w_gate, w_up, *, activation="silu"):
    if _route(x) == "cpu":
        return _ref.gated_matmul(x, w_gate, w_up, activation=activation)
    return _mm.gated_matmul(x, w_gate, w_up, activation=activation)
