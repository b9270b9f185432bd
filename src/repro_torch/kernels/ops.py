"""Dispatch layer: one entry point per kernel.

The tensor decides the route, and nothing else does: a CPU tensor runs the
plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel (or the wrapper raises on what the
kernel does not take).  There is no fallback and no mode switch.  A meta
tensor runs the plain version too: a shape-only trace (the dry-run's),
which computes nothing.  A ``DTensor`` raises: the sharded path calls the
wrappers on local shards (:mod:`repro_torch.distributed.local`).

Each kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show
that its main path went through the kernels.  Beside them the model
counts, through :func:`count_plain`, the calls on a CUDA tensor that take
a plain branch by design: ``plain_dense_attention`` (dense-cache
attention for a chunk at a cache offset above 0, or decode in a windowed
layer) and ``plain_ssd_scan`` (a Mamba2 prefill whose length is not a
multiple of the SSD chunk, or not above one chunk).  A run that should
reach only kernels reads both as 0.

No kernel has a backward.  On the CUDA route each wrapper raises when grad
mode is on and an input requires grad (:func:`_check_no_grad`): a launch
there would return a tensor without ``grad_fn`` and silently cut the
upstream weights out of the gradient.  Training runs the plain forms
(``plain=True`` in :mod:`repro_torch.models.layers`).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.shardings import is_dtensor
from repro_torch.kernels import decode_attention as _dense_decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hete_matmul as _mm
from repro_torch.kernels import paged_attention as _decode
from repro_torch.kernels import paged_prefill as _prefill
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_chunk as _ssd


# the plain branches the model takes by design, counted on CUDA tensors
_PLAIN = {"plain_dense_attention": 0, "plain_ssd_scan": 0}


def count_plain(name: str, t: torch.Tensor) -> None:
    """Count one call of the plain branch ``name`` (a key of the counts
    :func:`launch_counts` reads) when ``t`` lies on the card."""
    if t.device.type == "cuda":
        _PLAIN[name] += 1


# the per-call observer, None by default: an object whose
# ``kernel_call(name, fn, ref_fn, route, args, kwargs)`` makes the call
# (``fn``) and returns its result.  The dry-run's cost counter
# (repro_torch.analysis.hlo_cost.CostMode) sets itself here while it is on
_observer = None


def set_observer(obs):
    """Make ``obs`` (or None) the per-call observer; returns the one it
    replaces, for the caller to restore."""
    global _observer
    prev, _observer = _observer, obs
    return prev


_WRAPPERS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
    "q8_matmul": _q8.q8_matmul,
    "decode_attention": _dense_decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "rmsnorm": _rms.rmsnorm,
    "ssd_chunk": _ssd.ssd_chunk,
    "matmul": _mm.matmul,
    "gated_matmul": _mm.gated_matmul,
}


def _route(t: torch.Tensor) -> str:
    if is_dtensor(t):
        raise TypeError(
            "a DTensor reached a kernel wrapper: call it on the local "
            "shards (repro_torch.distributed.local)")
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def _check_no_grad(name: str, *tensors) -> None:
    """Refuse a kernel launch that autograd would have to see through."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            "grad under grad mode; run the plain form (plain=True) or "
            "call it under torch.no_grad()")


def _run(name: str, ref_fn, kern_fn, *args, **kwargs):
    """One wrapper call: the plain version on a CPU tensor (and on a meta
    tensor: a shape-only trace), the kernel on a CUDA tensor.  With an
    observer set (:func:`set_observer`) the call goes through it."""
    route = _route(args[0])
    fn = ref_fn
    if route == "cuda":
        _check_no_grad(name, *args, *kwargs.values())
        fn = kern_fn
    if _observer is None:
        return fn(*args, **kwargs)
    return _observer.kernel_call(name, fn, ref_fn, route, args, kwargs)


def launch_counts() -> Dict[str, int]:
    return {**{name: fn.launches for name, fn in _WRAPPERS.items()},
            **_PLAIN}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for name in _PLAIN:
        _PLAIN[name] = 0


def q8_matmul(x, q, scale):
    return _run("q8_matmul", _ref.q8_matmul, _q8.q8_matmul, x, q, scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len, *,
                           k_scale=None, v_scale=None, softcap=None):
    return _run("paged_decode_attention", _ref.paged_decode_attention,
                _decode.paged_decode_attention, q, k_pages, v_pages,
                block_tables, kv_len, k_scale=k_scale, v_scale=v_scale,
                softcap=softcap)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_offset, *,
                            k_scale=None, v_scale=None, softcap=None,
                            window=None):
    return _run("paged_prefill_attention", _ref.paged_prefill_attention,
                _prefill.paged_prefill_attention, q, k_pages, v_pages,
                block_tables, kv_offset, k_scale=k_scale, v_scale=v_scale,
                softcap=softcap, window=window)


def decode_attention(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                     softcap=None, return_lse=False):
    """With ``return_lse``, also each (row, q-head)'s log-sum-exp of its
    scaled (and softcapped) scores, fp32 (B, Hq): -inf for a row with no
    key — what ranks holding parts of one row's keys combine."""
    return _run("decode_attention", _ref.decode_attention,
                _dense_decode.decode_attention, q, k, v, kv_len,
                k_scale=k_scale, v_scale=v_scale, softcap=softcap,
                return_lse=return_lse)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    return _run("flash_attention", _ref.flash_attention,
                _flash.flash_attention, q, k, v, causal=causal,
                window=window, softcap=softcap)


def rmsnorm(x, scale, *, eps=1e-6, plus_one=False):
    return _run("rmsnorm", _ref.rmsnorm, _rms.rmsnorm, x, scale, eps=eps,
                plus_one=plus_one)


def ssd_chunk(x, dt, a, b, c, *, chunk):
    return _run("ssd_chunk", _ref.ssd_chunk, _ssd.ssd_chunk, x, dt, a, b, c,
                chunk=chunk)


def matmul(x, w, bias=None, *, activation=None):
    return _run("matmul", _ref.matmul, _mm.matmul, x, w, bias,
                activation=activation)


def gated_matmul(x, w_gate, w_up, *, activation="silu"):
    return _run("gated_matmul", _ref.gated_matmul, _mm.gated_matmul, x,
                w_gate, w_up, activation=activation)
