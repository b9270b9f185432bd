"""Int8-weight matmul with per-column scales — quantized weight streaming.

HeteGen is link-bound, so streaming weights as int8 + fp32 per-column
scales cuts the host-to-device bytes about 4x for fp32 weights and shifts
the alpha equilibrium toward the device.  :class:`HeteGenEngine` built
with ``wstream="q8"`` quantizes each offloaded column shard once at load
(:func:`quantize_weights_np`), stages the ``(q, scale)`` pair through the
pinned rings, copies the pair to the card and computes the device share
with :func:`q8_matmul` — the dequant happens inside the kernel
(``csrc/q8_matmul.cu``), so no fp copy of a streamed weight ever exists
in device memory.  One C entry picks the kernel by M: up to 16 rows (the
decode steps) a weight-streaming kernel split across a thread-block
cluster, above that a kernel on the bf16 tensor cores with x split
exactly into three bf16 terms (fp32 accuracy), also split across a
cluster; either is one launch.  The plain
version is :func:`repro_torch.kernels.ref.q8_matmul`, the per-element
limit between them :func:`repro_torch.kernels.ref.q8_matmul_limit`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def quantize_weights_np(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-column symmetric int8 quantization on the host — the
    wire format of ``wstream="q8"``, bit-identical to the JAX package's
    ``quantize_weights_np``."""
    w32 = np.asarray(w, dtype=np.float32)
    scale = np.max(np.abs(w32), axis=0) / np.float32(127.0) \
        + np.float32(1e-12)
    q = np.clip(np.round(w32 / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32 @ dequant(q (K, N) int8, scale (N,) fp32) -> (M, N).
    Launches the CUDA kernel on the current stream; every call counts in
    ``q8_matmul.launches``."""
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError("q8_matmul takes x (M, K), q (K, N), scale (N,)")
    m, k = x.shape
    k2, n = q.shape
    if k != k2 or scale.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if x.dtype != torch.float32 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("q8_matmul takes float32 x, int8 q, float32 scale")
    for t in (x, q, scale):
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError("all operands must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    fn = build.c_function("q8_matmul", "q8_matmul_f32", _ARGTYPES)
    build.launch(fn, x.device.index,
                 x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 m, n, k)
    q8_matmul.launches += 1
    return y


q8_matmul.launches = 0
