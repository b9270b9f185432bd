"""Analytic per-device memory footprint for a (config, shape, mesh) cell.

The port of the JAX package's ``analysis/memory_model.py``, term for term:

  train:   params + grads(fp32, param-sharded) + optimizer moments
           + remat-saved layer inputs (one per layer, microbatch tokens,
             sharded per the activation rules) x 2 (double buffer)
           + attention workspace (fp32 score chunk x 2)
           + logits buffer (micro tokens x vocab shard, fp32 x 2)
  serve:   params + cache + attention workspace + logits
  all:     x 1.5 slack on the modeled activation term only

Exactness: parameter/optimizer/cache terms are exact (leaf-by-leaf bytes
divided by their PartitionSpec shard factors); activation terms are a
model.  The fit flag is against one H100's memory: ``fits_80GB`` holds
the total to ``H100_HBM_BYTES`` = 80e9 bytes, the card's 80 GB in decimal
units (below the 85,017,493,504 bytes ``torch.cuda.get_device_properties``
reports for an H100 80GB HBM3, which leaves room for the CUDA context and
the allocator's pools).
``launch/dryrun.py --device cuda`` measures the peak beside it.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.distributed.shardings import ShardingRules
from repro_torch.distributed.specs import flatten_with_path
from repro_torch.models.config import ModelConfig

H100_HBM_BYTES = 80e9


def _shard_factor(spec, rules: ShardingRules) -> int:
    f = 1
    for part in spec:
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        for a in axes:
            f *= rules.mesh_shape.get(a, 1)
    return f


def tree_bytes_per_device(shapes, specs, rules: ShardingRules) -> int:
    """Bytes one device holds of a tree whose leaves carry ``specs``
    (shape and dtype are read; meta tensors will do)."""
    spec_of = dict(flatten_with_path(specs))
    total = 0
    for path, leaf in flatten_with_path(shapes):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n * leaf.element_size() \
            // max(_shard_factor(spec_of[path], rules), 1)
    return total


def estimate(cfg: ModelConfig, *, kind: str, batch: int, seq: int,
             rules: ShardingRules, accum: int = 1, accum_dtype_bytes: int = 4,
             param_shapes=None, param_spec=None,
             opt_shapes=None, opt_spec=None,
             cache_shapes=None, cache_spec=None) -> Dict[str, float]:
    ms = rules.mesh_shape.get("model", 1)
    batch_shards = 1
    for a in ("pod", "data"):
        batch_shards *= rules.mesh_shape.get(a, 1)
    dt = cfg.dtype_bytes()

    out: Dict[str, float] = {}
    if param_shapes is not None:
        out["params"] = tree_bytes_per_device(param_shapes, param_spec, rules)
    if opt_shapes is not None:
        out["optimizer"] = tree_bytes_per_device(opt_shapes, opt_spec, rules)
    if cache_shapes is not None:
        out["cache"] = tree_bytes_per_device(cache_shapes, cache_spec, rules)

    d, v = cfg.d_model, cfg.vocab_size
    hq_loc = max(cfg.n_heads // ms, 1) if cfg.n_heads else 1
    v_loc = v // ms if v % ms == 0 else v

    if kind == "train":
        micro_rows = max(batch // max(accum, 1), 1)
        rows_loc = max(micro_rows // batch_shards, 1)
        seq_shards = ms if (rules.table.get("seq") and seq % ms == 0) else 1
        tok_loc = rows_loc * (seq // seq_shards)
        n_saved = cfg.n_layers
        saved = n_saved * tok_loc * d * dt * 2          # x2 double buffer
        out["grads_accum"] = out.get("params", 0) * (accum_dtype_bytes / dt)
        chunk_q = min(1024, seq)
        attn_ws = rows_loc * hq_loc * chunk_q * seq * 4 * 2
        logits = tok_loc * v_loc * 4 * 2
        # per-layer live set during bwd: x, normed h, ff activations
        ff_loc = max(cfg.d_ff // ms, 1) if cfg.d_ff else cfg.d_inner // ms \
            if cfg.ssm_state else d
        layer_live = tok_loc * (3 * d + 2 * ff_loc) * 4
        out["activations"] = saved + attn_ws + logits + layer_live
    else:
        rows_loc = max(batch // batch_shards, 1)
        attn_ws = rows_loc * hq_loc * min(1024, max(seq // 32, 1)) * 4 * 2 \
            if kind == "prefill" else rows_loc * hq_loc * seq * 4
        logits = rows_loc * v_loc * 4 * 2
        out["activations"] = attn_ws + logits

    # slack only on the modeled activation term; params/opt/cache/grads
    # are exact per-spec byte counts
    act = out.get("activations", 0.0)
    out["total"] = sum(v for k, v in out.items() if k != "activations") \
        + 1.5 * act
    out["activations"] = act
    out["fits_80GB"] = out["total"] <= H100_HBM_BYTES
    return out
