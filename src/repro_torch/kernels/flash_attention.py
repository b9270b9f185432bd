"""Flash attention (prefill) on the card: the wrapper of
``csrc/flash_attention.cu``.

Sq query rows attend over Skv key rows, query i at position i and key j
at position j: causal or not, optionally within a sliding ``window``, and
softcapped.  GQA maps q-head h to kv-head h // (Hq // Hkv).  Q, K, V and
the output are addressed through strides, so the first Skv positions of a
KV cache are passed as a view and the output is written straight into
the (B, Sq, Hq, D) layout the model's out-projection reads.  The plain
version is :func:`repro_torch.kernels.ref.flash_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPE_CODES,
                                                  check_bf16_operands,
                                                  check_device, check_rows)

_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p, _LL, _LL, _LL,
              ctypes.c_void_p, ctypes.c_void_p, _LL, _LL, _LL,
              ctypes.c_void_p, _LL, _LL, _LL]
             + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D); fp32 (D <= 256) or bf16 (D
    a multiple of 16 up to 256, 16-byte aligned rows), one
    dtype
    -> (B, Hq, Sq, D), a view whose ``transpose(1, 2)`` is contiguous.
    Launches the CUDA kernel on the current stream; every call counts in
    ``flash_attention.launches``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k/v (B, Hkv, Skv, "
                         f"D), got {tuple(q.shape)} and {tuple(k.shape)}")
    dev = check_device(q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d > 256 or hq % hkv:
        raise ValueError(f"head dim {d} must be <= 256 and {hq} q-heads a "
                         f"multiple of {hkv} kv-heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v must be {q.dtype}, got {k.dtype}/{v.dtype}")
    if k.stride() != v.stride():
        raise ValueError("k and v must share one layout (strides)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)
    if q.dtype == torch.bfloat16:
        check_bf16_operands(q, k, v)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if b == 0 or hq == 0 or sq == 0:
        return out
    fn = build.c_function("flash_attention", "flash_attention", _ARGTYPES)
    build.launch(fn, dev.index,
                 q.data_ptr(), *q.stride()[:3], k.data_ptr(), v.data_ptr(),
                 *k.stride()[:3], out.data_ptr(), *out.stride()[:3],
                 DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d,
                 1.0 / math.sqrt(d), float(softcap or 0.0), int(causal),
                 int(window or 0))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
