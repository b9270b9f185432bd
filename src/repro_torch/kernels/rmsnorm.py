"""Row RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

``x * rsqrt(mean(x^2) + eps) * w`` over the last dim (``* (1 + w)`` with
``plus_one``), statistics in fp32, one read and one write of each row.
Rows are addressed through a row stride, so a slice such as ``x[:, -1:]``
is normalised in place of a copy.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPE_CODES, check_device

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """x (..., D) fp32 or bf16, scale (D,) of x's dtype -> x's shape and
    dtype.  Launches the CUDA kernel on the current stream; every call
    counts in ``rmsnorm.launches``."""
    dev = check_device(x, scale)
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"scale must be {x.dtype}, got {scale.dtype}")
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous ({d},) vector")
    x2 = x.reshape(-1, d)              # a view where the rows allow one
    if d > 1 and x2.stride(1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, d), dtype=x.dtype, device=dev)
    if rows == 0 or d == 0:
        return out.reshape(x.shape)
    fn = build.c_function("rmsnorm", "rmsnorm", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), x2.stride(0), scale.data_ptr(),
                 out.data_ptr(), out.stride(0), DTYPE_CODES[x.dtype], rows, d,
                 float(eps), int(plus_one),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm launch failed (cudaError {err})")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
