"""The paper's runtime: offloaded one-shot generation with hybrid
heterogeneous parallelism (HeteGen §4).

Weights live in host memory.  Each linear executes under the scheduler's
placement plan (resident / hetegen-split / streamed) through
:class:`repro_torch.core.engine.HeteGenEngine`; everything else (norms,
rope, the attention kernels, sampling) runs on the device.  The forward
is eager per layer, exactly how offloading runtimes execute, since
weights arrive layer by layer.

The decoder math is not defined here: the generator drives the shared
layer functions (:func:`repro_torch.models.model.decoder_layer`) through
:class:`repro_torch.serving.backends.HeteGenBackend` over the dense
per-layer cache, whose prefill runs the flash-attention kernel and whose
decode steps run the flash-decode kernel on the card.  The placement plan
is tuned for the real decode batch (§4.1's cost model shifts the optimal
alpha with compute intensity).  One whole-batch sampler
(:func:`repro_torch.serving.sampling.make_sampler`, greedy by default)
draws every row, keyed by ``generate``'s ``seed``.

For request-level serving drive the backend through
:class:`repro_torch.serving.api.LLM` instead; this generator is the
phase-aware one-shot executor kept for stats-rich offload benchmarking.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.hw import H100_HOST, HardwareSpec
from repro_torch.models.config import ModelConfig
from repro_torch.serving.backends import HeteGenBackend
from repro_torch.serving.engine import wait_for
from repro_torch.serving.sampling import (SamplerConfig, fold_in,
                                          make_sampler, seed_key)


class OffloadGenerator:
    """HeteGen-scheduled offloaded generation for dense GQA decoders.

    ``batch`` sizes the initial placement plan; by default the plan is
    re-tuned when :meth:`generate` is called with a different batch size
    (``auto_retune=False`` pins the constructed plan).  ``hw`` defaults to
    :data:`repro_torch.core.hw.H100_HOST`.
    """

    def __init__(self, cfg: ModelConfig, params: Dict, *,
                 hw: HardwareSpec = H100_HOST,
                 budget_bytes: Optional[float] = None,
                 use_alpha_benchmark: bool = True,
                 use_module_scheduler: bool = True,
                 alpha_override: Optional[float] = None,
                 sampler: SamplerConfig = SamplerConfig(),
                 batch: int = 1,
                 auto_retune: bool = True,
                 device=None):
        self.cfg = cfg
        self.backend = HeteGenBackend(
            cfg, params, hw=hw, budget_bytes=budget_bytes, batch=batch,
            use_alpha_benchmark=use_alpha_benchmark,
            use_module_scheduler=use_module_scheduler,
            alpha_override=alpha_override, device=device)
        self.auto_retune = auto_retune
        self.sample = make_sampler(sampler)

    @property
    def policy(self):
        return self.backend.policy

    @property
    def engine(self):
        return self.backend.engine

    # ------------------------------------------------------------------
    def generate(self, tokens: np.ndarray, max_new_tokens: int,
                 *, max_len: Optional[int] = None, seed: int = 0) -> Dict:
        """Generate ``max_new_tokens`` per row of ``tokens`` (B, S)."""
        b, s = tokens.shape
        if self.auto_retune:
            self.backend.retune(b)
        total = max_len or (s + max_new_tokens)
        cache = self.backend.init_cache(b, total)
        self.backend.reset_stats()
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.backend.device)
        t0 = time.perf_counter()
        cache, logits = self.backend.prefill({"tokens": toks}, cache)
        key = seed_key(seed)
        tok = self.sample(logits, key)
        wait_for(tok)
        t1 = time.perf_counter()
        out = [tok]
        for i in range(max_new_tokens - 1):
            key = fold_in(key, i)
            cache, logits = self.backend.decode(out[-1], cache)
            out.append(self.sample(logits, key))
        wait_for(out[-1])
        t2 = time.perf_counter()
        # stream stats aggregate over the backend's phase engines (the
        # prefill partition ran the prompt, the decode partition the loop)
        stats = self.backend.finish_stats()
        prefill_policy = self.backend.policies.get("prefill")
        return {
            "tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_s": t1 - t0,
            "decode_s": t2 - t1,
            "tokens_per_s": b * max(max_new_tokens - 1, 1)
            / max(t2 - t1, 1e-9),
            "stream_stats": stats,
            "alpha": self.policy.alpha,
            "prefill_alpha": (None if prefill_policy is None
                              else prefill_policy.alpha),
            "batch": self.backend.batch,
            "resident_bytes": self.backend.device_resident_bytes(),
            "pinned_overhead_bytes": self.backend.pinned_overhead_bytes(),
        }

    def close(self):
        self.backend.close()
