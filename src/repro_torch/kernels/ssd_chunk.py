"""Mamba2 SSD intra-chunk part on the card: the wrapper of
``csrc/ssd_chunk.cu``.

Per (batch, head, chunk) cell: the inclusive cumsum of ``dt * a``, the
chunk's own output ``y_intra`` and its state contribution ``state_c``
(the inter-chunk carry stays in :func:`repro_torch.models.ssm.ssd_chunked`).
x and b/c are read through (batch, position, head) strides, so b/c may be
stride-0 expands of (B, L, G, N) over the heads (then the bf16 kernel
computes C B^T once for a run of heads).  bf16 runs on the tensor cores,
fp32 on the CUDA cores.  The plain version is
:func:`repro_torch.kernels.ref.ssd_chunk`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPE_CODES, check_device,
                                                  check_rows)

MAX_DIM = 128          # chunk, P and N: the kernels' tiles
_LL = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p, _LL, _LL, _LL] * 2 + [ctypes.c_void_p]
             + [ctypes.c_void_p, _LL, _LL, _LL] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, L, H, P) fp32 or bf16; dt (B, L, H) fp32; a (H,) fp32; b/c
    (B, L, H, N) of x's dtype, any strides with a unit last one; L % chunk
    == 0, chunk, P and N at most 128.  Returns (y_intra (B, L, H, P),
    state_c (B, L // chunk, H, P, N), cum (B, L, H)), all fp32.  Launches
    the CUDA kernel on the current stream; every call counts in
    ``ssd_chunk.launches``."""
    dev = check_device(x, dt, a, b, c)
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x must be (B, L, H, P) and b/c (B, L, H, N), got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bs, ln, h, p = x.shape
    n = b.shape[3]
    if b.shape[:3] != x.shape[:3] or dt.shape != (bs, ln, h) \
            or a.shape != (h,):
        raise ValueError("dt (B, L, H), a (H,) and b/c must match x")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b/c must be {x.dtype}, got {b.dtype}/{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    if chunk < 1 or ln % chunk:
        raise ValueError(f"sequence {ln} is not a multiple of chunk {chunk}")
    if max(chunk, p, n) > MAX_DIM:
        raise ValueError(f"chunk {chunk}, P {p} and N {n} must each be at "
                         f"most {MAX_DIM}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        check_rows(name, t)
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    nc = ln // chunk
    y = torch.empty((bs, ln, h, p), dtype=torch.float32, device=dev)
    state = torch.empty((bs, nc, h, p, n), dtype=torch.float32, device=dev)
    cum = torch.empty((bs, ln, h), dtype=torch.float32, device=dev)
    if bs == 0 or ln == 0 or h == 0:
        return y, state, cum
    fn = build.c_function("ssd_chunk", "ssd_chunk", _ARGTYPES)
    build.launch(fn, dev.index, x.data_ptr(), *x.stride()[:3], dt.data_ptr(),
                 *dt.stride(), a.data_ptr(), b.data_ptr(), *b.stride()[:3],
                 c.data_ptr(), *c.stride()[:3], y.data_ptr(),
                 state.data_ptr(), cum.data_ptr(), DTYPE_CODES[x.dtype], bs,
                 ln, h, p, n, chunk)
    ssd_chunk.launches += 1
    return y, state, cum


ssd_chunk.launches = 0
