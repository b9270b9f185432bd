"""Dispatch layer: one entry point per kernel.

The tensor decides the route, and nothing else does: a CPU tensor runs the
plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel (or the wrapper raises on what the
kernel does not take).  There is no fallback and no mode switch.

Each kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show
that its main path went through the kernels.  Beside them,
``plain_dense_attention`` counts the dense-cache attention calls on a
CUDA tensor that take the plain path by design (a chunk at a cache offset
above 0, decode in a windowed layer): a run that should reach only
kernels reads it as 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _dense_decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _decode
from repro_torch.kernels import paged_prefill as _prefill
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms


def plain_dense_attention(q, k, v, **kw):
    """:func:`repro_torch.models.layers.attention` over a dense cache, for
    the shapes no kernel takes; a call on a CUDA tensor counts in
    ``plain_dense_attention.launches``."""
    from repro_torch.models import layers
    if _route(q) == "cuda":
        plain_dense_attention.launches += 1
    return layers.attention(q, k, v, **kw)


plain_dense_attention.launches = 0

_WRAPPERS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
    "q8_matmul": _q8.q8_matmul,
    "decode_attention": _dense_decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "rmsnorm": _rms.rmsnorm,
    "plain_dense_attention": plain_dense_attention,
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


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
