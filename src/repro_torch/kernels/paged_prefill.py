"""Paged flash-prefill on the card: the wrapper of
``csrc/paged_prefill_attention.cu``.

A chunk of S queries starting at ``kv_offset[b]`` attends causally over
the pages named by ``block_tables[b]`` (optionally within a sliding
``window``, optionally softcapped).  The chunk's own K/V must already be
written to the pages.  Pages are fp32 or bf16 under a q of their dtype;
with ``k_scale`` / ``v_scale`` they are int8 and are dequantized in fp32
inside the kernel.  Each q dtype has one kernel: a bf16 q runs on the
tensor cores at every head dim that is a multiple of 16 up to 256, with
16-byte aligned rows, an fp32 q on the CUDA cores at head dims that are a
multiple of 4 (of 16 over int8 pages) up to 256; any other shape raises
``ValueError``.  The plain version is
:func:`repro_torch.kernels.ref.paged_prefill_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPE_CODES,
                                                  check_bf16_operands)
from repro_torch.kernels.paged_attention import _ptr, check_operands

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            kv_offset: torch.Tensor, *,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, S, D) fp32 or bf16; pages (P, Hkv, ps, D) of q's dtype, or
    int8 with fp32 scales; block_tables (B, nb) int32; kv_offset (B,) int32
    -> (B, Hq, S, D) in q's dtype.  Launches the CUDA kernel
    on the current stream; every call counts in
    ``paged_prefill_attention.launches``.  Raises ``ValueError`` on a
    head dim or an alignment its kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hq, S, D), got {tuple(q.shape)}")
    check_operands(q, k_pages, v_pages, block_tables, kv_offset, k_scale,
                   v_scale)
    b, hq, s, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    if q.dtype == torch.bfloat16:
        check_bf16_operands(q, k_pages, v_pages)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    fn = build.c_function("paged_prefill_attention",
                          "paged_prefill_attention", _ARGTYPES)
    build.launch(fn, q.device.index,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
                 kv_offset.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
                 DTYPE_CODES[k_pages.dtype], b, hq, hkv, s, ps, d,
                 block_tables.shape[1], 1.0 / math.sqrt(d),
                 float(softcap or 0.0), int(window or 0))
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
