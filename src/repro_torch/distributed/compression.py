"""Gradient compression for slow-link collectives.

The port of the JAX package's ``distributed/compression.py``: int8
uniform quantization with per-chunk scales and **error feedback** (the
quantization residual is carried into the next step, which keeps SGD
convergence — Karimireddy et al. 2019):

    q, scale = quantize(g + e);   e' = (g + e) - dequantize(q, scale)

:func:`compressed_psum_mean` all-gathers the int8 payload and the fp32
scales over one process group and reduces locally: the collective itself
moves compressed data (wire bytes ~= 1/4 of fp32).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.shardings import is_dtensor
from repro_torch.train.optimizer import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor, chunk: int = 2048
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Uniform symmetric int8 quantization with per-chunk scales.

    Returns (q int8 (n_chunks, chunk), scales fp32 (n_chunks,), shape).
    """
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % chunk
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, chunk)
    scale = torch.amax(blocks.abs(), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale, shape


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = math.prod(shape) if shape else 1
    return flat[:n].reshape(shape)


def quantization_error(x: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    q, s, shp = quantize_int8(x, chunk)
    return x.float() - dequantize_int8(q, s, shp)


# ---------------------------------------------------------------------------
# Error-feedback state over a gradient tree
# ---------------------------------------------------------------------------

def ef_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_compress(grads, ef_state, chunk: int = 2048):
    """(grads, error) -> (quantized payloads, new error); a payload leaf
    is (q, scales, shape)."""
    payloads, errors = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef_state)):
        corrected = g.float() + e
        q, s, shp = quantize_int8(corrected, chunk)
        payloads.append((q, s, shp))
        errors.append(corrected - dequantize_int8(q, s, shp))
    it_p, it_e = iter(payloads), iter(errors)
    return (tree_map(lambda _: next(it_p), grads),
            tree_map(lambda _: next(it_e), grads))


def wire_bytes(n: int, chunk: int = 2048) -> Tuple[int, int]:
    """(compressed, fp32) bytes one member sends for n values: the int8
    payload plus an fp32 scale a chunk, against 4 bytes a value."""
    n_chunks = -(-n // chunk)
    return n_chunks * chunk + 4 * n_chunks, 4 * n


# ---------------------------------------------------------------------------
# Compressed mean-all-reduce over one process group
# ---------------------------------------------------------------------------

def compressed_psum_mean(x: torch.Tensor, group, chunk: int = 2048
                         ) -> torch.Tensor:
    """Mean of ``x`` over the members of ``group``, moving int8 on the
    wire: all-gather the int8 payload and the fp32 scales, dequantize each
    member's and average locally (in member order)."""
    import torch.distributed._functional_collectives as funcol
    q, scale, shape = quantize_int8(x, chunk)
    size = torch.distributed.get_world_size(group)
    qs = funcol.all_gather_tensor(q, 0, group).reshape(
        (size,) + tuple(q.shape))                   # (N, n_chunks, chunk)
    ss = funcol.all_gather_tensor(scale, 0, group).reshape(
        (size,) + tuple(scale.shape))
    deq = torch.stack([dequantize_int8(qs[i], ss[i], shape)
                       for i in range(size)])
    return torch.mean(deq, dim=0)


def make_compressed_allreduce(mesh, axis: str = "pod", chunk: int = 2048):
    """Gradient-tree mean-all-reduce over the mesh dim ``axis`` with an
    int8 wire format; returns grads -> fp32 grads.  A ``DTensor`` leaf
    reduces its local shard; its placements are kept."""
    group = mesh.get_group(axis)

    def one(g):
        if is_dtensor(g):
            out = compressed_psum_mean(g.to_local(), group, chunk)
            return DTensor.from_local(out, g.device_mesh,
                                      g.placements, run_check=False,
                                      shape=g.shape, stride=g.stride())
        return compressed_psum_mean(g, group, chunk)

    def reduce_tree(grads):
        return tree_map(one, grads)

    return reduce_tree
