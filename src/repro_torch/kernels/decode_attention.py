"""Dense flash-decode on the card: the wrapper of
``csrc/decode_attention.cu``.

One query token per (batch, q-head) attends over the first ``kv_len[b]``
rows of a dense cache laid out (B, Hkv, T, D) — the stacked cache's
layer slice as it is, or the backend's (B, T, Hkv, D) buffer through
``transpose(1, 2)``: the kernel takes K/V strides, so neither layout is
copied.  With ``k_scale`` / ``v_scale`` (B, Hkv, T) the cache is int8 and
is dequantized inside the kernel in q's dtype, as the JAX package's
stacked whole model dequantizes its int8 cache in the model dtype.  A bf16
q over a bf16 or int8 cache runs a split-KV kernel with one thread-block
cluster per (batch, kv-head), at every head dim
:func:`bf16_head_dim_ok` takes (multiples of 16 up to 256) with 16-byte
aligned rows (any other bf16 shape is refused); an fp32 q a kernel
with one block per (batch, q-head).  Either is one launch.  The plain
version is :func:`repro_torch.kernels.ref.decode_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p, _LL, _LL, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, _LL, _LL, _LL, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, _LL, _LL, _LL,
              ctypes.c_void_p, ctypes.c_void_p, _LL, _LL, ctypes.c_void_p]
             + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])

# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_device(*tensors) -> torch.device:
    """The one CUDA device every tensor lies on; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("all operands must lie on one CUDA device")
    return dev


def check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels read rows through strides; the last dim must be dense."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride in its last dim")


def bf16_head_dim_ok(d: int) -> bool:
    """The head dims the bf16 tensor-core attention kernels (flash, the
    split decode, paged prefill and decode) are instantiated at: every
    multiple of 16 from 16 to 256, the width of their mma tiles."""
    return d % 16 == 0 and 16 <= d <= 256


def check_bf16_operands(q, k, v) -> None:
    """The bf16 tensor-core kernels move 16-byte chunks: their head dims
    pass :func:`bf16_head_dim_ok`, and every base pointer and stride but
    the last of q, k and v is a multiple of 16 bytes (a stride of a dim of
    size 1 is never used)."""
    d = q.shape[-1]
    if not bf16_head_dim_ok(d):
        raise ValueError(f"bf16 head dim {d} is not a multiple of 16 from "
                         f"16 to 256: no bf16 attention kernel is built "
                         f"for it")
    for name, x in (("q", q), ("k", k), ("v", v)):
        el = x.element_size()
        if x.data_ptr() % 16 or any(
                st * el % 16 for st, n in zip(x.stride()[:-1], x.shape[:-1])
                if n > 1):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"in multiples of 16 bytes, got strides "
                             f"{x.stride()} of {el}-byte elements")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     softcap: Optional[float] = None,
                     return_lse: bool = False):
    """q (B, Hq, D) fp32 or bf16 (D a multiple of 16 up to 256, 16-byte
    aligned rows); k/v (B, Hkv, T, D) of q's dtype, or int8 with
    ``k_scale``/``v_scale`` (B, Hkv, T) fp32 dequantized in q's dtype;
    kv_len (B,) int32
    -> (B, Hq, D) in q's dtype; with ``return_lse`` also each (row,
    q-head)'s natural log-sum-exp of its scores, (B, Hq) fp32 (-inf for a
    row with no key), written by the same launch.  Launches the CUDA
    kernel on the current stream; every call counts in
    ``decode_attention.launches``."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, Hq, D) and k/v (B, Hkv, T, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    q8 = k_scale is not None or v_scale is not None
    tensors = [q, k, v, kv_len] + ([k_scale, v_scale] if q8 else [])
    if q8 and (k_scale is None or v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    dev = check_device(*tensors)
    b, hq, d = q.shape
    _, hkv, t, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d > 256 or hq % hkv:
        raise ValueError(f"head dim {d} must be <= 256 and {hq} q-heads a "
                         f"multiple of {hkv} kv-heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    want = torch.int8 if q8 else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"k/v must be {want}, got {k.dtype}/{v.dtype}")
    if k.stride() != v.stride():
        raise ValueError("k and v must share one layout (strides)")
    if q8:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != (b, hkv, t)
                or v_scale.shape != (b, hkv, t)
                or k_scale.stride() != v_scale.stride()):
            raise ValueError("scales must be float32 (B, Hkv, T) with one "
                             "layout")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,) \
            or not kv_len.is_contiguous():
        raise TypeError("kv_len must be a contiguous (B,) int32 tensor")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)
    if q.dtype == torch.bfloat16:
        check_bf16_operands(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b == 0 or hq == 0:
        return (out, lse) if return_lse else out
    sst = k_scale.stride() if q8 else (0, 0, 0)
    fn = build.c_function("decode_attention", "decode_attention", _ARGTYPES)
    build.launch(fn, dev.index,
                 q.data_ptr(), q.stride(0), q.stride(1), DTYPE_CODES[q.dtype],
                 k.data_ptr(), v.data_ptr(), *k.stride()[:3],
                 DTYPE_CODES[k.dtype],
                 k_scale.data_ptr() if q8 else 0,
                 v_scale.data_ptr() if q8 else 0, *sst,
                 kv_len.data_ptr(), out.data_ptr(), out.stride(0),
                 out.stride(1), lse.data_ptr() if return_lse else 0,
                 b, hq, hkv, t, d, 1.0 / math.sqrt(d),
                 float(softcap or 0.0))
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
