"""Assigned input shapes and ``input_specs`` (stand-ins on the meta device).

Each LM-family architecture is paired with four shapes:

    train_4k      seq 4,096   global_batch 256   -> train_step
    prefill_32k   seq 32,768  global_batch 32    -> prefill_step
    decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                   KV cache of seq_len)
    long_500k     seq 524,288 global_batch 1     -> serve_step; requires a
                  sub-quadratic trunk: run for SSM/hybrid archs only

``input_specs`` allocates nothing by default: every leaf is a tensor on
``device="meta"`` (shape and dtype, no storage), the port's form of the
JAX package's ``ShapeDtypeStruct``; ``spec_only=False`` gives zeros on
``device``.  Same shapes, dtypes and tree as the JAX package's
``repro.configs.shapes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache, torch_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    s = SHAPES[shape]
    if s.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention trunk: 500k-token decode requires a "
                       "sub-quadratic architecture")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, *,
                batch_override: Optional[int] = None,
                spec_only: bool = True, device=None) -> Dict:
    """Step-function inputs for one (arch, shape) cell.

    train   -> {"batch": {"tokens" or "embeds", "labels"} (+ "enc_embeds")}
    prefill -> {"batch": {...}, "cache": zero cache sized to seq}
    decode  -> {"token", "cache" (full)}

    ``spec_only`` puts every leaf on the meta device (nothing allocated);
    otherwise they are zeros on ``device`` (cuda unless given)."""
    s = SHAPES[shape]
    b = batch_override or s.batch
    dev = torch.device("meta") if spec_only else resolve_device(device)
    i32, f = torch.int32, torch_dtype(cfg)

    def mk(shp, dt):
        return torch.zeros(shp, dtype=dt, device=dev)

    def inputs(batch: Dict) -> Dict:
        if cfg.embeds_input:
            batch["embeds"] = mk((b, s.seq, cfg.d_model), f)
        else:
            batch["tokens"] = mk((b, s.seq), i32)
        if cfg.family == "encdec":
            batch["enc_embeds"] = mk((b, cfg.encoder_seq, cfg.d_model), f)
            if "tokens" not in batch:
                batch["tokens"] = mk((b, s.seq), i32)
        return batch

    if s.kind == "train":
        batch = inputs({})
        batch["labels"] = mk((b, s.seq), i32)
        return {"batch": batch}
    cache = init_cache(cfg, b, s.seq, device=dev)
    if s.kind == "prefill":
        return {"batch": inputs({}), "cache": cache}
    # decode: one new token against a cache of length seq
    return {"token": mk((b,), i32), "cache": cache}
