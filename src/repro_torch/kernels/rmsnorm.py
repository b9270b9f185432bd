"""Row RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

``x * rsqrt(mean(x^2) + eps) * w`` over the last dim (``* (1 + w)`` with
``plus_one``), statistics in fp32, one read and one write of each row.
At decode the device takes a few microseconds and the host's issue time
sets the call, so the wrapper does only its checks, the output's
allocation and one packed ``ctypes`` call.  Rows are addressed through a
row stride, so a slice such as ``x[:, -1:]`` is normalised in place of a
copy.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPE_CODES

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
_CODES = {t: DTYPE_CODES[t] for t in (torch.float32, torch.bfloat16)}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """x (..., D) fp32 or bf16, scale (D,) of x's dtype -> x's shape and
    dtype.  Launches the CUDA kernel on the current stream; every call
    counts in ``rmsnorm.launches``."""
    index = x.get_device()             # -1 on the CPU
    if index < 0 or scale.get_device() != index:
        raise ValueError("all operands must lie on one CUDA device")
    code = _CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"scale must be {x.dtype}, got {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous ({d},) vector")
    if x.is_contiguous():
        out = torch.empty_like(x)      # cheaper than torch.empty(shape, ...)
        x_rs = d
    else:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        x = x.reshape(-1, d)           # a view where the rows allow one
        if d > 1 and x.stride(1) != 1:
            x = x.contiguous()
        x_rs = x.stride(0)
    n = out.numel()
    if n == 0:
        return out
    build.launch(build.c_function("rmsnorm", "rmsnorm", _ARGTYPES), index,
                 x.data_ptr(), x_rs, scale.data_ptr(), out.data_ptr(), d,
                 code, n // d, d, eps, plus_one)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
