"""One-shot generation over the dense KV cache or an SSM state.

:class:`Generator` runs a rectangular batch to completion: one prefill,
then a decode loop.  It has two executions of the same layer
math, as in the JAX package:

* **resident whole model** (``Generator(cfg, params)``):
  :func:`repro_torch.models.model.prefill` /
  :func:`~repro_torch.models.model.decode_step` over the stacked cache of
  :func:`~repro_torch.models.model.init_cache` (fp or int8), or over the
  recurrent state of an SSM model (Mamba2);
* **through a backend** (``Generator(cfg, backend=...)``): the backend's
  ``prefill`` / ``decode`` over its per-layer dense cache —
  :class:`repro_torch.serving.backends.ResidentBackend` or the offloaded
  :class:`~repro_torch.serving.backends.HeteGenBackend`, whose placement
  plan is retuned to the real batch first.

On the card the prefill attends through the flash-attention kernel and
every decode step through the flash-decode kernel
(:func:`repro_torch.models.model.attention_route`); a Mamba2 prefill runs
the SSD chunk kernel (:mod:`repro_torch.models.ssm`).  The loop samples on
the device and reads nothing back to the host until the batch is done (an
offload backend's own host share aside).  Without request-level
``sampling`` the constructor's whole-batch sampler runs (greedy by
default); with it every row draws under its own
:class:`repro_torch.serving.sampling.SamplingParams` from its request's
own random stream — the streams the continuous batcher consumes, so
one-shot and batched execution of the same requests give the same
tokens.

Request-level serving fronts this class through
:class:`repro_torch.serving.api.LLM`, which uses it as the one-shot
executor for rectangular batches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.distributed.shardings import (NO_RULES, ShardingRules,
                                               is_dtensor)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import (SamplerConfig, SamplingParams,
                                          fold_in, greedy, make_sampler,
                                          pack_sampling, request_key,
                                          sample_rows, seed_key, step_key)


@dataclasses.dataclass
class GenerateResult:
    tokens: list                        # (B, n_new) python ints
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def wait_for(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (host timing needs it)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Generator:
    """Batched generation over the stacked resident model or a backend
    (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 rules: ShardingRules = NO_RULES,
                 sampler: SamplerConfig = SamplerConfig(),
                 backend=None):
        if backend is None and params is None:
            raise ValueError("Generator needs params or a backend")
        if backend is not None and rules is not NO_RULES:
            raise ValueError(
                "sharding rules are owned by the backend; construct the "
                "backend with its own sharding instead of passing rules")
        self.cfg = cfg
        self.params = params
        self.rules = rules
        self.backend = backend
        self.sample = make_sampler(sampler)

    def _device(self) -> torch.device:
        if self.backend is not None:
            return self.backend.device
        return self.params["embed"].device

    # ------------------------------------------------------------------
    def generate(self, batch: Dict, max_new_tokens: int, *,
                 max_len: Optional[int] = None,
                 seed: int = 0,
                 sampling: Optional[List[SamplingParams]] = None,
                 request_keys: Optional[List[int]] = None
                 ) -> GenerateResult:
        """Generate ``max_new_tokens`` per row of ``batch["tokens"]``
        (B, S), or of the VLM's ``batch["embeds"]`` (B, S, d) in their
        place; an encoder-decoder's ``batch["enc_embeds"]`` (B,
        encoder_seq, d) go beside the tokens to the prefill.  Every leaf
        moves to the model's device (tokens as int32).

        ``sampling`` switches to request-level sampling: one
        :class:`SamplingParams` per row, drawn under per-request random
        streams (``request_keys``, derived from ``seed`` and the row index
        when omitted).  Without it the constructor's whole-batch sampler
        runs, keyed by ``seed``."""
        cfg = self.cfg
        if "tokens" in batch:
            b, s = batch["tokens"].shape
        else:
            b, s = batch["embeds"].shape[:2]
        packed = None
        all_greedy = False
        if sampling is not None:
            if len(sampling) != b:
                raise ValueError(f"{len(sampling)} SamplingParams for "
                                 f"batch {b}")
            # greedy rows draw nothing: an all-greedy batch keeps the
            # plain argmax instead of the full-vocab sort
            all_greedy = all(p.kind == "greedy" for p in sampling)
            if not all_greedy and request_keys is None:
                base = seed_key(seed)
                request_keys = [request_key(base, i, sp)
                                for i, sp in enumerate(sampling)]
        total = max_len or (s + max_new_tokens)
        be = self.backend
        dev = self._device()
        feed = {k: torch.as_tensor(v, device=dev,
                                   dtype=torch.int32 if k == "tokens"
                                   else None)
                for k, v in batch.items()}
        if sampling is not None and not all_greedy:
            packed = pack_sampling(sampling, device=dev)
        key = seed_key(seed)

        def sample(logits: torch.Tensor, step: int) -> torch.Tensor:
            if packed is not None:
                return sample_rows(logits, [step_key(k, step)
                                            for k in request_keys], packed)
            if all_greedy:
                return greedy(logits)
            return self.sample(logits, fold_in(key, step))
        if be is not None and hasattr(be, "retune"):
            be.retune(b)       # plan follows the real decode batch
        cache = M.init_cache(cfg, b, total, device=dev) if be is None \
            else be.init_cache(b, total)

        t0 = time.perf_counter()
        if be is None:
            cache, logits = M.prefill(cfg, self.params, feed, cache,
                                      self.rules)
        else:
            cache, logits = be.prefill(feed, cache)
        tok = sample(logits, 0)
        wait_for(tok)
        t1 = time.perf_counter()

        out = [tok]
        for i in range(1, max_new_tokens):
            if be is None:
                cache, logits = M.decode_step(cfg, self.params, tok, cache,
                                              self.rules)
            else:
                cache, logits = be.decode(tok, cache)
            tok = sample(logits, i)
            out.append(tok)
        wait_for(tok)
        t2 = time.perf_counter()

        dec = max(t2 - t1, 1e-9)
        return GenerateResult(
            tokens=torch.stack(out, dim=1).tolist(),
            prefill_s=t1 - t0,
            decode_s=dec,
            tokens_per_s=b * max(max_new_tokens - 1, 1) / dec,
        )


# ---------------------------------------------------------------------------
# serve_step / prefill_step entry points
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, rules: ShardingRules = NO_RULES):
    """One decode step: (params, token (B,), cache) -> (cache, next (B,)),
    greedy, with nothing read back to the host.  Under ``rules`` over
    ``DTensor``s the argmax runs over the vocab-sharded logits (a
    reduction across ``model``)."""

    def serve_step(params, token, cache):
        cache, logits = M.decode_step(cfg, params, token, cache, rules)
        return cache, _greedy(logits, rules)

    return serve_step


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules = NO_RULES):
    def prefill_step(params, batch, cache):
        cache, logits = M.prefill(cfg, params, batch, cache, rules)
        return cache, _greedy(logits, rules)

    return prefill_step


def _greedy(logits: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """:func:`greedy` over logits placed by ``rules``: the vocab shards
    gathered (each rank's rows whole), the argmax taken locally and the
    tokens placed on the batch axes."""
    if not rules.active or not is_dtensor(logits):
        return greedy(logits)
    from torch.distributed.tensor import Replicate
    rows = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in logits.placements]
    return rules.act(greedy(logits.redistribute(logits.device_mesh, rows)),
                     "batch")
