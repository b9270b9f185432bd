"""Paged flash-decode on the card: the wrapper of
``csrc/paged_decode_attention.cu``.

One query token per (batch, q-head) attends over the pages named by
``block_tables[b]``; pools are laid out (n_pages, Hkv, page_size, hd) as
:mod:`repro_torch.serving.kv_cache` mints them, in the model dtype (fp32
or bf16, with a q of that dtype).  With ``k_scale`` / ``v_scale``
(n_pages, Hkv, page_size) the pages are int8 and are dequantized in fp32
inside the kernel, under a q of either dtype.  A bf16 q runs a split-KV
kernel with one thread-block cluster per (batch, kv-head) at head dims in
multiples of 16 up to 256 with 16-byte aligned rows (any other bf16 shape is
refused, as in the dense decode); an fp32 q the same cluster layout on the
CUDA cores, at head dims in multiples of 4 (16 over int8 pages) up to 256
(:func:`check_operands`).  The plain version is
:func:`repro_torch.kernels.ref.paged_decode_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPE_CODES,
                                                  check_bf16_operands)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def check_operands(q, k_pages, v_pages, block_tables, lens, k_scale,
                   v_scale) -> None:
    """Raise on anything the paged attention kernels do not take.  An fp32
    q moves 16-byte chunks: head dims in multiples of 4 (16 over int8
    pages) up to 256, q and the pages 16-byte aligned."""
    tensors = [q, k_pages, v_pages, block_tables, lens]
    if k_scale is not None or v_scale is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("pass both k_scale and v_scale, or neither")
        tensors += [k_scale, v_scale]
    dev = q.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("all operands must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    want = torch.int8 if k_scale is not None else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pages must be {want}, got {k_pages.dtype}")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32
                                or k_scale.shape != k_pages.shape[:3]
                                or v_scale.shape != k_pages.shape[:3]):
        raise ValueError("scales must be float32 (n_pages, Hkv, page_size)")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("k/v pages must share one (P, Hkv, ps, D) shape")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    hq, d = q.shape[1], q.shape[-1]
    hkv = k_pages.shape[1]
    if d != k_pages.shape[3] or d > 256:
        raise ValueError(f"head dim {d} must match the pages and be <= 256")
    if hq % hkv:
        raise ValueError(f"{hq} q-heads are not a multiple of {hkv} kv-heads")
    if q.dtype == torch.float32:
        lanes = 16 if k_scale is not None else 4
        if d % lanes:
            raise ValueError(f"an fp32 q takes head dims in multiples of "
                             f"{lanes} over {k_pages.dtype} pages, got {d}")
        if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
            raise ValueError("q and the pages must be 16-byte aligned")
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lens.shape != (b,):
        raise ValueError("block_tables (B, nb) and lengths (B,) must match q")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D) fp32 (D a multiple of 4, of 16 over int8 pages) or
    bf16 (D a multiple of 16 up to 256), 16-byte aligned; pages (P, Hkv, ps,
    D) of q's dtype, or int8 with fp32 scales; block_tables (B, nb)
    int32; kv_len (B,) int32 -> (B, Hq, D) in q's dtype.  Launches the
    CUDA kernel on the current stream; every call counts in
    ``paged_decode_attention.launches``."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D), got {tuple(q.shape)}")
    check_operands(q, k_pages, v_pages, block_tables, kv_len, k_scale,
                   v_scale)
    if q.dtype == torch.bfloat16:
        check_bf16_operands(q, k_pages, v_pages)
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = build.c_function("paged_decode_attention",
                          "paged_decode_attention", _ARGTYPES)
    build.launch(fn, q.device.index,
                 q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
                 DTYPE_CODES[k_pages.dtype], b, hq, hkv, ps, d,
                 block_tables.shape[1], 1.0 / math.sqrt(d),
                 float(softcap or 0.0))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
