"""Optimizers: AdamW, Adafactor and SGD over a param tree, the port of the
JAX package's ``train/optimizer.py``.

Each is the JAX package's update written out in PyTorch — not
``torch.optim``, which updates a bf16 param in bf16 and orders the decay
and the step differently.  Both halves keep the JAX package's state trees:

    init, update = make_optimizer(cfg)
    state = init(params)
    new_params, new_state = update(grads, state, params, lr)

Every update runs in fp32 and is cast back to the param's dtype once;
moments are kept in ``moment_dtype``; no weight decay on leaves with
fewer than two dims (norms, biases).  Adafactor keeps factored second
moments (``vr`` over rows, ``vc`` over columns) for leaves whose last two
dims are both at least ``min_dim_factored``.

``update`` writes the new values into ``params`` and ``state`` in place
and returns those same trees — the JAX step donates its state, so the old
values are dead there too, and a model whose moments are as large as
Gemma-2-2B's (21 GB in fp32) cannot hold a second copy beside them.  The
arithmetic is the out-of-place one, operation by operation.  Grad clipping
by the global norm is applied leaf by leaf inside the update, so no
clipped copy of the whole gradient tree is made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # bfloat16 halves optimizer memory
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128


def tree_leaves(tree) -> List:
    """Leaves in the JAX package's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the like trees ``rest``, in
    :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = 0.0
    for x in tree_leaves(tree):
        xf = x.float()
        total = total + torch.sum(xf * xf)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), cast back to each leaf's
    dtype; norm)."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale).to(g.dtype), grads), norm


def _clipped(g: torch.Tensor, scale) -> torch.Tensor:
    """One leaf of :func:`clip_by_global_norm` in fp32 (rounded through
    the leaf's dtype as the clipped tree holds it)."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


def _update_scale(cfg: "OptimizerConfig", grads):
    return _clip_scale(grads, cfg.grad_clip)[0] if cfg.grad_clip else None


def _decayed_step(cfg, p, step):
    """step + weight_decay * p on leaves of two or more dims, in place."""
    if cfg.weight_decay and p.dim() >= 2:
        step.add_(p.float() * cfg.weight_decay)
    return step


def _apply(p, step, lr) -> None:
    """p <- (p - lr * step) in fp32, cast to p's dtype once."""
    p32 = p.float()
    p2 = p32 - step.mul_(lr)
    p.copy_(p2)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def make_adamw(cfg: OptimizerConfig):
    mdt = _DTYPES[cfg.moment_dtype]

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(grads, state, params, lr):
        scale = _update_scale(cfg, grads)
        count = state["count"] + 1
        cf = count.float()
        b1c = 1.0 - torch.pow(cfg.b1, cf)
        b2c = 1.0 - torch.pow(cfg.b2, cf)

        def upd(p, g, m, v):
            g32 = _clipped(g, scale)
            m2 = m.float()
            m2 = (m2 * cfg.b1 if m2 is m else m2.mul_(cfg.b1)) \
                .add_(g32 * (1 - cfg.b1))
            v2 = v.float()
            v2 = (v2 * cfg.b2 if v2 is v else v2.mul_(cfg.b2)) \
                .add_(g32.mul((1 - cfg.b2)).mul_(g32))
            del g32
            denom = (v2 / b2c).sqrt_().add_(cfg.eps)
            step = (m2 / b1c).div_(denom)
            del denom
            _apply(p, _decayed_step(cfg, p, step), lr)
            m.copy_(m2)
            v.copy_(v2)

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            upd(p, g, m, v)
        state["count"] = count
        return params, state

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, first moment omitted)
# ---------------------------------------------------------------------------

def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def make_adafactor(cfg: OptimizerConfig):
    mdt = _DTYPES[cfg.moment_dtype]

    def init(params):
        def st(p):
            z = dict(dtype=mdt, device=p.device)
            if _factored(p.shape, cfg.min_dim_factored):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"s": tree_map(st, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(grads, state, params, lr):
        scale = _update_scale(cfg, grads)
        count = state["count"] + 1
        beta = 1.0 - count.float() ** (-cfg.decay_rate)

        def upd(p, g, s):
            g32 = _clipped(g, scale)
            g2 = g32 * g32 + 1e-30
            if "vr" in s:
                vr = beta * s["vr"].float() \
                    + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"].float() \
                    + (1 - beta) * torch.mean(g2, dim=-2)
                del g2
                rfac = torch.rsqrt(vr / torch.mean(vr, dim=-1, keepdim=True)
                                   + 1e-30)
                cfac = torch.rsqrt(vc + 1e-30)
                step = g32 * rfac[..., None] * cfac[..., None, :]
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"].float() + (1 - beta) * g2
                step = g32 * torch.rsqrt(v + 1e-30)
                s["v"].copy_(v)
            # relative step size (Adafactor update clipping)
            rms = torch.sqrt(torch.mean(step * step) + 1e-30)
            step = step / torch.clamp(rms, min=1.0)
            _apply(p, _decayed_step(cfg, p, step), lr)

        for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                           _state_leaves(state["s"])):
            upd(p, g, s)
        state["count"] = count
        return params, state

    return init, update


def _state_leaves(tree) -> List[Dict]:
    """Adafactor's per-param state dicts ({"vr", "vc"} or {"v"}), in the
    params' leaf order."""
    if isinstance(tree, dict) and not ({"v"} == set(tree)
                                       or {"vr", "vc"} == set(tree)):
        return [x for k in sorted(tree) for x in _state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _state_leaves(v)]
    return [tree]


def make_sgd(cfg: OptimizerConfig):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(grads, state, params, lr):
        scale = _update_scale(cfg, grads)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_(p.float() - lr * _clipped(g, scale))
        state["count"] = state["count"] + 1
        return params, state

    return init, update


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return make_adamw(cfg)
    if cfg.name == "adafactor":
        return make_adafactor(cfg)
    if cfg.name == "sgd":
        return make_sgd(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def lr_schedule(step, *, base: float, warmup: int = 100,
                total: int = 10_000, kind: str = "cosine") -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then cosine decay to 0 at
    ``total`` (or constant with ``kind`` "constant"), in fp32 on
    ``step``'s device (a tensor or an int)."""
    s = step.float() if isinstance(step, torch.Tensor) \
        else torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    if kind == "cosine":
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return base * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base * warm
