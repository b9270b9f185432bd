"""Token sampling for the port: greedy only, for now.

:class:`SamplingParams` is the JAX package's per-request parameter object
(same fields and validation), so requests carry the same description in
both packages.  Only ``kind="greedy"`` is served; the stochastic kinds need
request-owned random streams, which are not ported yet, and raise at
submission (:func:`require_greedy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_KINDS = ("greedy", "temperature", "topk", "topp")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling parameters (the serving front door's unit)."""

    kind: str = "greedy"        # greedy | temperature | topk | topp
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    logprobs: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError("logprobs must be None or >= 0")


def require_greedy(params: SamplingParams) -> None:
    """Raise for what the port does not serve yet."""
    if params.kind != "greedy":
        raise NotImplementedError(
            f"sampling kind {params.kind!r} is not ported yet (greedy only)")
    if params.logprobs is not None:
        raise NotImplementedError("logprobs are not ported yet")


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax (first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
