"""Dispatch layer: one entry point per kernel.

The tensor decides the route, and nothing else does: a CPU tensor runs the
plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel (or the wrapper raises on what the
kernel does not take).  There is no fallback and no mode switch.

Each kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import paged_attention as _decode
from repro_torch.kernels import paged_prefill as _prefill
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref as _ref

_WRAPPERS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
    "q8_matmul": _q8.q8_matmul,
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
