"""Training loop: loss, the grad-accumulated train step and the Trainer — the
port of the JAX package's ``train/loop.py``.

``make_train_step`` builds the step: cross entropy (+ the MoE
load-balancing term, + an optional z-loss) through
:func:`repro_torch.models.model.forward_train`, gradients from
``torch.autograd.grad`` over the param tree's leaves, accumulation over
``accum_steps`` microbatches in ``accum_dtype`` (activation memory scales
with the microbatch), then the optimizer (global-norm clipping inside).

The ``Trainer`` adds checkpoint/restart, preemption handling, straggler
monitoring and metrics, and resumes from the newest checkpoint of its
directory on construction.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptimizerConfig, lr_schedule,
                                         make_optimizer, tree_leaves,
                                         tree_map)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    accum_dtype: str = "float32"       # bf16 halves the grad buffer
    aux_loss_weight: float = 0.01      # MoE load-balance coefficient
    z_loss_weight: float = 0.0         # logit norm regularizer (optional)
    optimizer: OptimizerConfig = OptimizerConfig()
    warmup: int = 100
    total_steps: int = 10_000


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            aux_weight: float = 0.01,
            z_weight: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """Causal LM cross entropy over the batch (labels = next-token ids),
    fp32 logsumexp minus the gold logit, averaged.  Returns (loss,
    {"nll", "aux"})."""
    logits, aux = M.forward_train(cfg, params, batch, return_aux=True)
    labels = batch["labels"].long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.mean(logz - gold)
    metrics = {"nll": loss, "aux": aux}
    if aux_weight and cfg.n_experts:
        loss = loss + aux_weight * aux
    if z_weight:
        loss = loss + z_weight * torch.mean(torch.square(logz))
    return loss, metrics


def loss_and_grads(cfg: ModelConfig, params: Dict, batch: Dict,
                   aux_weight: float = 0.01, z_weight: float = 0.0):
    """(loss, metrics, grads): ``grads`` is a tree like ``params`` whose
    leaves are ``torch.autograd.grad``'s — None for a leaf the loss does
    not reach.  ``params`` is left as it was (its leaves are read through
    detached views that require grad)."""
    leaves, rebuild = _flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, rebuild(live), batch, aux_weight,
                                z_weight)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, rebuild(list(grads))


def _flatten(tree):
    """(leaves in sorted-key order, rebuild(leaves) -> a like tree)."""
    leaves = tree_leaves(tree)

    def rebuild(new: List):
        it = iter(new)
        return tree_map(lambda _: next(it), tree)
    return leaves, rebuild


def _batch_on(batch: Dict, device) -> Dict:
    """Numpy or tensor batch leaves as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics) with grad accumulation.

    ``state`` = {"params", "opt", "step"}.  ``batch`` leaves have leading
    dim ``global_batch``; microbatch i is rows [i B/a, (i+1) B/a), run in
    order, gradients summed in ``accum_dtype`` and averaged, one optimizer
    update applied (in place: the returned state holds the same tensors).
    As in the JAX package, the accumulating step reports ``aux`` as 0."""
    opt_init, opt_update = make_optimizer(tcfg.optimizer)

    def grads_of(params, mb):
        loss, metrics, grads = loss_and_grads(
            cfg, params, mb, tcfg.aux_loss_weight, tcfg.z_loss_weight)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None
                         else g, grads, params)
        return grads, loss, metrics

    def train_step(state, batch):
        params = state["params"]
        batch = _batch_on(batch, state["step"].device)
        a = tcfg.accum_steps
        if a <= 1:
            grads, loss, metrics = grads_of(params, batch)
        else:
            adt = _DTYPES[tcfg.accum_dtype]
            rows = next(iter(batch.values())).shape[0] // a
            g_sum, loss = None, 0.0
            for i in range(a):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                g, l, _ = grads_of(params, mb)
                if g_sum is None:
                    g_sum = tree_map(lambda x: x.to(adt), g)
                else:
                    tree_map(lambda s, x: s.add_(x.to(adt)), g_sum, g)
                del g
                loss = loss + l
            grads = tree_map(lambda s: s.div_(a).float(), g_sum)
            del g_sum
            loss = loss / a
            metrics = {"nll": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        lr = lr_schedule(state["step"], base=tcfg.optimizer.lr,
                         warmup=tcfg.warmup, total=tcfg.total_steps)
        new_params, new_opt = opt_update(grads, state["opt"], params, lr)
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step, opt_init


def init_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, *,
               device=None) -> Dict:
    """{"params", "opt", "step"}: random params from ``seed`` on
    ``device``, the optimizer's zero state, step 0 (int32)."""
    dev = resolve_device(device)
    params = M.init_params(cfg, seed, device=dev)
    _, opt_init = make_train_step(cfg, tcfg)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# The Trainer, with fault tolerance
# ---------------------------------------------------------------------------

class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50,
                 keep: int = 3,
                 async_checkpoint: bool = True,
                 seed: int = 0,
                 device=None):
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.distributed.fault_tolerance import (
            PreemptionHandler, StragglerDetector, retry)

        self.cfg, self.tcfg = cfg, tcfg
        self._step, _ = make_train_step(cfg, tcfg)
        self.state = init_state(cfg, tcfg, seed, device=device)
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=keep,
                                       async_save=async_checkpoint)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.preemption = PreemptionHandler()
        self.straggler = StragglerDetector()
        self._retry = retry
        self.metrics_log: list = []
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.state)
            if restored is not None:
                self.state = restored

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def run(self, batches, steps: int) -> Dict:
        it = iter(batches)
        last = {}
        for _ in range(steps):
            batch = next(it)
            t0 = time.perf_counter()
            self.state, metrics = self._retry(
                lambda: self._step(self.state, batch))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.straggler.update("host0", dt)
            metrics["step_time_s"] = dt
            metrics["step"] = self.step
            self.metrics_log.append(metrics)
            last = metrics
            if self.ckpt is not None and \
                    (self.step % self.checkpoint_every == 0
                     or self.preemption.triggered):
                self.ckpt.save(self.step, self.state)
                if self.preemption.triggered:
                    break
        if self.ckpt is not None:
            self.ckpt.wait()
        return last
