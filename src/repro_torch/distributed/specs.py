"""PartitionSpec trees for params / optimizer state / caches / batches, and
their placement on a ``DeviceMesh``.

The port of the JAX package's ``distributed/specs.py``.  Specs are
assigned by leaf *path* (the parameter's role, in JAX's ``keystr`` form:
``['blocks']['pos0']['attn']['wq']``) and guarded by the leaf *shape* (a
mesh axis is never assigned to a dim it does not divide): Megatron-style TP
+ EP with batch data-parallel over ("pod", "data").

Trees are the port's nested dicts (and lists / tuples) of tensors; a spec
tree has the same structure with a :class:`PartitionSpec` per leaf.
:func:`distribute` places a tree as ``DTensor``s (the JAX package's
``named`` + ``device_put``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.shardings import (PartitionSpec as P,
                                               ShardingRules)
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Trees with keystr paths
# ---------------------------------------------------------------------------

def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order (dict keys
    sorted).  A :class:`PartitionSpec` is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree (and like trees),
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 prefix=f"{prefix}[{k!r}]") for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        prefix=f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


# (path regex, logical axes per dim — right-aligned against leaf shape)
# first match wins
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings: vocab-sharded (so tied lm_head logits shard over vocab)
    (r"\['embed'\]$",            ("vocab", None)),
    (r"\['lm_head'\]$",          (None, "vocab")),
    (r"\['pos'\]$",              (None, None)),
    (r"\['enc_pos'\]$",          (None, None)),
    # attention projections (leading stack dims absorbed as None)
    (r"\['wq'\]$",               (None, "qkv")),
    (r"\['wk'\]$",               (None, "qkv")),
    (r"\['wv'\]$",               (None, "qkv")),
    (r"\['wo'\]$",               ("qkv", None)),
    (r"\['bq'\]$",               ("qkv",)),
    (r"\['bk'\]$",               ("qkv",)),
    (r"\['bv'\]$",               ("qkv",)),
    # MLA factors: head-expanded matrices shard on the head dim
    (r"\['wq_b'\]$",             (None, "qkv")),
    (r"\['wk_b'\]$",             (None, "qkv")),
    (r"\['wv_b'\]$",             (None, "qkv")),
    (r"\['wq_a'\]$",             (None, None)),
    (r"\['wkv_a'\]$",            (None, None)),
    # MLP
    (r"\['w_gate'\]$",           (None, "ff")),
    (r"\['w_up'\]$",             (None, "ff")),
    (r"\['w_in'\]$",             (None, "ff")),
    (r"\['b_in'\]$",             ("ff",)),
    (r"\['w_down'\]$",           ("ff", None)),
    # MoE experts (EP on the expert dim)
    (r"\['we_\w+'\]$",           ("experts", None, None)),
    (r"\['ws_gate'\]$",          (None, "ff")),
    (r"\['ws_up'\]$",            (None, "ff")),
    (r"\['ws_down'\]$",          ("ff", None)),
    (r"\['router'\]$",           (None, None)),
    # mamba2 (heads on model axis; B/C small -> replicated)
    (r"\['w_z'\]$",              (None, "ff")),
    (r"\['w_x'\]$",              (None, "ff")),
    (r"\['w_dt'\]$",             (None, "ssm_heads")),
    (r"\['w_bc'\]$",             (None, None)),
    (r"\['conv_x_w'\]$",         (None, "ff")),
    (r"\['conv_x_b'\]$",         ("ff",)),
    (r"\['conv_bc_\w'\]$",       (None, None)),
    (r"\['A_log'\]$",            ("ssm_heads",)),
    (r"\['D'\]$",                ("ssm_heads",)),
    (r"\['dt_bias'\]$",          ("ssm_heads",)),
    (r"\['gnorm'\]$",            ("ff",)),
    (r"\['out_proj'\]$",         ("ff", None)),
    # shared-block lora
    (r"\['shared_lora'\]\['a'\]$", (None, None, None)),
    (r"\['shared_lora'\]\['b'\]$", (None, None, "qkv")),
    (r"\['proj'\]$",             (None, None)),
)

_FSDP_IN = re.compile(
    r"\['(wq|wk|wv|w_gate|w_up|w_in|w_z|w_x)'\]$")   # shard input dim (d)
_FSDP_OUT = re.compile(r"\['(wo|w_down|out_proj)'\]$")  # shard output dim
# experts: gate/up shard the OUTPUT dim (f) so the d-contraction stays
# local; down shards its INPUT dim (f) to match
_FSDP_EXPERT_OUT = re.compile(r"\['we_(gate|up|in)'\]$")
_FSDP_EXPERT_IN = re.compile(r"\['we_down'\]$")
# fsdp only pays when the model-sharded leaf is still large; below this
# the weight all-gathers it induces cost more than the memory it saves
FSDP_MIN_BYTES_PER_CHIP = 512 * 2**20


def _one(axes: Optional[Tuple[str, ...]]):
    return None if axes is None else (axes[0] if len(axes) == 1 else axes)


def _spec_for_param(path: str, shape: Tuple[int, ...],
                    rules: ShardingRules, fsdp: bool = False,
                    kv_divisible: bool = True) -> P:
    # GQA with kv_heads < TP: replicate K/V projections across the model
    # axis; q heads carry the TP
    if not kv_divisible and re.search(r"\['(wk|wv|bk|bv)'\]$", path):
        parts = [None] * len(shape)
        # a >=100B arch stores their input dim data-sharded instead
        if fsdp and len(shape) >= 2 and "data" in rules.mesh_axes:
            dp = rules.mesh_shape.get("data", 1)
            if shape[-2] % dp == 0:
                parts[-2] = "data"
        return P(*parts)
    for pat, logical in _PARAM_RULES:
        if not re.search(pat, path):
            continue
        # right-align logical axes against the shape (stack dims -> None)
        pad = (None,) * (len(shape) - len(logical))
        logical = pad + tuple(logical)[-len(shape):] \
            if len(logical) <= len(shape) else logical[-len(shape):]
        parts = [_one(rules._axes_for(ax, dim))
                 for dim, ax in zip(shape, logical)]
        if fsdp and "data" in rules.mesh_axes:
            dp = rules.mesh_shape.get("data", 1)
            # bytes/chip after the base (model/expert) sharding
            shard_f = 1
            for part in parts:
                for a in (part if isinstance(part, tuple)
                          else (part,) if part else ()):
                    shard_f *= rules.mesh_shape.get(a, 1)
            n_elems = 1
            for dsz in shape:
                n_elems *= dsz
            per_chip = n_elems * 2 / max(shard_f, 1)     # bf16
            tgt = None
            if per_chip >= FSDP_MIN_BYTES_PER_CHIP:
                if _FSDP_IN.search(path) and len(shape) >= 2:
                    tgt = len(shape) - 2       # input dim
                elif _FSDP_OUT.search(path) and len(shape) >= 2:
                    tgt = len(shape) - 1       # output dim
                elif _FSDP_EXPERT_OUT.search(path) and len(shape) >= 3:
                    tgt = len(shape) - 1       # per-expert output dim
                elif _FSDP_EXPERT_IN.search(path) and len(shape) >= 3:
                    tgt = len(shape) - 2       # down: input dim (f)
            if tgt is not None and parts[tgt] is None \
                    and shape[tgt] % dp == 0:
                parts[tgt] = "data"
        return P(*parts)
    return P(*([None] * len(shape)))    # norms, scalars, biases: replicated


def param_shapes(cfg: ModelConfig) -> Dict:
    """``init_params(cfg)``'s tree on the meta device (shapes and dtypes,
    nothing allocated)."""
    from repro_torch.models.model import init_params
    return init_params(cfg, 0, device="meta")


def param_specs(cfg: ModelConfig, rules: ShardingRules,
                params_shape: Optional[Any] = None, *,
                serve: bool = False):
    """PartitionSpec tree matching ``init_params(cfg)``.

    ``serve``: serving keeps wk/wv TP-sharded even at sub-head granularity
    (the cache is seq-sharded); training replicates them when
    kv_heads < TP to keep attention math head-local.
    """
    if params_shape is None:
        params_shape = param_shapes(cfg)
    ms = rules.mesh_shape.get("model", 1)
    kv_div = True if serve else \
        ((cfg.n_kv_heads % ms == 0) if cfg.n_kv_heads else True)
    return map_with_path(
        lambda path, leaf: _spec_for_param(path, tuple(leaf.shape), rules,
                                           fsdp=cfg.fsdp,
                                           kv_divisible=kv_div),
        params_shape)


def opt_state_specs(cfg: ModelConfig, rules: ShardingRules, opt_shape,
                    pspecs) -> Any:
    """Optimizer-state specs mirroring the parameter layout.

    adamw m/v inherit the param spec; adafactor vr/vc drop the reduced dim.
    Scalars replicate.
    """
    pflat = dict(flatten_with_path(pspecs))

    def one(path, leaf):
        spec = None
        m = re.match(r"\['(m|v)'\](.*)$", path)
        if m:
            spec = pflat.get(m.group(2))
        m2 = re.match(r"\['s'\](.*)\['(vr|vc|v)'\]$", path)
        if m2:
            base = pflat.get(m2.group(1))
            if base is not None:
                parts = list(base)
                if m2.group(2) == "vr":      # mean over last dim
                    parts = parts[:-1]
                elif m2.group(2) == "vc":    # mean over second-to-last dim
                    parts = parts[:-2] + parts[-1:]
                spec = P(*parts)
        if spec is None or len(spec) != len(leaf.shape):
            spec = P(*([None] * len(leaf.shape)))
        return spec

    return map_with_path(one, opt_shape)


def _batch_axes_spec(rules: ShardingRules, dim: int):
    keep, prod = [], 1
    for a in (a for a in ("pod", "data") if a in rules.mesh_axes):
        n = rules.mesh_shape[a]
        if dim % (prod * n) == 0:
            keep.append(a)
            prod *= n
    return tuple(keep) or None if len(keep) != 1 else keep[0]


def cache_specs(cfg: ModelConfig, rules: ShardingRules, cache_shape) -> Any:
    """Specs for the KV/state cache.

    Batch shards over ("pod","data") where divisible; heads shard over
    "model" when the head count divides it, otherwise the sequence dim
    takes the model axis (long-context small-head caches).
    """
    ms = rules.mesh_shape.get("model", 1)

    def bspec(dim):
        return _batch_axes_spec(rules, dim)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"\['(ks|vs)\d+'\]$", path):
            st, b, hkv, t = shape
            if hkv % ms == 0 and ms > 1:
                return P(None, bspec(b), "model", None)
            if t % ms == 0 and ms > 1:
                return P(None, bspec(b), None, "model")
            return P(None, bspec(b), None, None)
        if re.search(r"\['(k|v|shared_k|shared_v)\d*'\]$", path):
            # (stack, B, Hkv, T, hd) — attention-native layout
            st, b, hkv, t, hd = shape
            if hkv % ms == 0 and ms > 1:
                return P(None, bspec(b), "model", None, None)
            if t % ms == 0 and ms > 1:
                return P(None, bspec(b), None, "model", None)
            return P(None, bspec(b), None, None, None)
        if re.search(r"\['(lat|kr)\d+'\]$", path):
            st, b, t, r = shape
            return P(None, bspec(b), "model" if t % ms == 0 else None, None)
        if re.search(r"\['cross_[kv]'\]$", path):
            st, b, t, hkv, hd = shape
            return P(None, bspec(b), None,
                     "model" if hkv % ms == 0 else None, None)
        if re.search(r"\['ssm(_tail)?'\]$", path):
            # (..., B, H, P, N)
            h = shape[-3]
            lead = [None] * (len(shape) - 4)
            return P(*lead, bspec(shape[-4]),
                     "model" if h % ms == 0 else None, None, None)
        if re.search(r"\['conv_(x|bc)(_tail)?'\]$", path):
            ch = shape[-1]
            lead = [None] * (len(shape) - 3)
            return P(*lead, bspec(shape[-3]), None,
                     "model" if ch % ms == 0 else None)
        return P(*([None] * len(shape)))     # "len" scalar etc.

    return map_with_path(one, cache_shape)


def batch_specs(cfg: ModelConfig, rules: ShardingRules, batch_shape) -> Any:
    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        return P(_batch_axes_spec(rules, shape[0]),
                 *([None] * (len(shape) - 1)))

    return map_with_path(one, batch_shape)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def local_shape(shape: Tuple[int, ...], spec, rules: ShardingRules
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``
    (every split even: the spec tables guard divisibility)."""
    from repro_torch.distributed.shardings import spec_axes
    out = list(shape)
    for d, part in enumerate(spec):
        for a in spec_axes(part):
            n = rules.mesh_shape.get(a, 1)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {a} ({n})")
            out[d] //= n
    return tuple(out)


def distribute(tree, mesh, spec_tree, *, local_fn: Optional[Callable] = None):
    """Place every leaf of ``tree`` on ``mesh`` as a ``DTensor`` with the
    placements of its spec in ``spec_tree`` (the JAX package's ``named``
    + ``device_put``).

    A leaf on the meta device, or any leaf when ``local_fn`` is given, is
    not scattered: this rank's shard is made by ``local_fn(path, leaf,
    local_shape)`` (a meta tensor of the local shape by default) and
    wrapped with ``DTensor.from_local`` — the way to place a model no rank
    could hold whole, in a world whose collectives move no data."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    names = tuple(mesh.mesh_dim_names)
    rules = ShardingRules(mesh_axes=names,
                          mesh_shape=dict(zip(names, mesh.shape)), mesh=mesh)

    def one(path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl = rules.placements(spec)
        if local_fn is None and leaf.device.type != "meta":
            return distribute_tensor(leaf, mesh, pl)
        shp = local_shape(tuple(leaf.shape), spec, rules)
        if local_fn is not None:
            local = local_fn(path, leaf, shp)
        else:
            local = torch.empty(shp, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape,
                                  stride=_contiguous_stride(leaf.shape))

    return map_with_path(one, tree, spec_tree)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))
