"""Dense matmul with a fused epilogue on the card: the wrappers of
``csrc/hete_matmul.cu``.

:func:`matmul` computes ``act(x @ w + bias)`` and :func:`gated_matmul`
``act(x @ w_gate) * (x @ w_up)`` in one pass over x, each summing in fp32
and rounding once to x's dtype, as the Pallas kernels do.  fp32 runs on
the CUDA cores (no TF32), bf16 on the tensor cores: above 48 rows a
persistent wgmma kernel fed by TMA in clusters of two that share the
weight tiles, its accumulator folded into fp32 totals every 512 of K and
its output stored by TMA (the gated MLP on an unfolded two-weight
kernel); at 48 rows or fewer ``matmul`` streams the weight
with K split across a thread-block cluster and reduced in a fixed order,
and ``gated_matmul`` runs mma.sync tiles.  Any M; K, N and
x's row stride in multiples of 16 bytes (8 bf16 or 4 fp32 elements), and
16-byte aligned operands, as every model width is: the kernels load and
store 16 bytes at a time (TMA needs the same), and the wrappers refuse
other operands.  The
plain versions are :func:`repro_torch.kernels.ref.matmul` and
:func:`repro_torch.kernels.ref.gated_matmul`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPE_CODES, check_device

# activation codes of the C entry points (``_apply_act`` of the Pallas kernels)
ACTIVATIONS = {None: 0, "none": 0, "relu": 1, "relu2": 2, "gelu": 3,
               "silu": 4}
_LL = ctypes.c_longlong
# (x, lda, w or w_gate, bias or w_up, y, dtype, m, n, k, act, stream)
_ARGTYPES = ([ctypes.c_void_p, _LL, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _activation(activation: Optional[str]) -> int:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    return ACTIVATIONS[activation]


def _check(x: torch.Tensor, ws) -> None:
    """x (M, K) fp32 or bf16 with unit column stride; each w (K, N)
    contiguous, of x's dtype; K, N and x's row stride multiples of 16
    bytes, x and each w 16-byte aligned."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 \
            or (x.shape[0] > 1 and x.stride(0) < x.shape[1]):
        raise ValueError(f"x must be (M, K) with a unit column stride and "
                         f"rows that do not overlap, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    for w in ws:
        if w.dtype != x.dtype:
            raise TypeError(f"weights must be {x.dtype}, got {w.dtype}")
        if w.dim() != 2 or w.shape[0] != x.shape[1]:
            raise ValueError(f"weights must be (K, N) with K = "
                             f"{x.shape[1]}, got {tuple(w.shape)}")
        if not w.is_contiguous():
            raise ValueError("weights must be contiguous")
    lanes = 16 // x.element_size()
    if any(v % lanes for v in (x.shape[1], ws[0].shape[1], _lda(x))):
        raise ValueError(f"K, N and x's row stride must be multiples of "
                         f"{lanes} for {x.dtype}, got K = {x.shape[1]}, "
                         f"N = {ws[0].shape[1]}, stride {_lda(x)}")
    if any(t.data_ptr() % 16 for t in (x, *ws)):
        raise ValueError("x and the weights must be 16-byte aligned")


def _lda(x: torch.Tensor) -> int:
    """x's row stride (a single row may carry any stride)."""
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: Optional[str] = None) -> torch.Tensor:
    """x (M, K) fp32 or bf16; w (K, N) and bias (N,) of x's dtype
    -> act(x @ w + bias) (M, N) in x's dtype.  Launches the CUDA kernel on
    the current stream; every call counts in ``matmul.launches``."""
    act = _activation(activation)
    dev = check_device(x, w, *(() if bias is None else (bias,)))
    _check(x, (w,))
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and (bias.dtype != x.dtype or bias.shape != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({n},) {x.dtype}")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return y
    fn = build.c_function("hete_matmul", "hete_matmul", _ARGTYPES)
    build.launch(fn, dev.index, x.data_ptr(), _lda(x), w.data_ptr(),
                 0 if bias is None else bias.data_ptr(), y.data_ptr(),
                 DTYPE_CODES[x.dtype], m, n, k, act)
    matmul.launches += 1
    return y


def gated_matmul(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 *, activation: str = "silu") -> torch.Tensor:
    """x (M, K) fp32 or bf16; w_gate, w_up (K, N) of x's dtype
    -> act(x @ w_gate) * (x @ w_up) (M, N) in x's dtype.  Launches the CUDA
    kernel on the current stream; every call counts in
    ``gated_matmul.launches``."""
    act = _activation(activation)
    dev = check_device(x, w_gate, w_up)
    _check(x, (w_gate, w_up))
    if w_up.shape != w_gate.shape:
        raise ValueError(f"w_gate {tuple(w_gate.shape)} and w_up "
                         f"{tuple(w_up.shape)} differ")
    m, k = x.shape
    n = w_gate.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return y
    fn = build.c_function("hete_matmul", "hete_gated_matmul", _ARGTYPES)
    build.launch(fn, dev.index,
                 x.data_ptr(), _lda(x), w_gate.data_ptr(), w_up.data_ptr(),
                 y.data_ptr(), DTYPE_CODES[x.dtype], m, n, k, act)
    gated_matmul.launches += 1
    return y


matmul.launches = 0
gated_matmul.launches = 0
