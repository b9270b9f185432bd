"""Serving backends — the surface the batcher schedules over.

The dense GQA decoder math is written once
(:func:`repro_torch.models.model.decoder_layer` /
:func:`repro_torch.models.model.backend_prefill`) with every weight
matmul routed through an injected ``linear(x, name)`` callable.  This
module provides the concrete executions of that seam, and the
scan-stacked whole model behind the same surface:

    ScanResidentBackend  the stacked whole model (:func:`repro_torch.models.
                      model.prefill` / ``decode_step``) over the stacked
                      cache: every transformer family the whole model runs
                      (Gemma-2's local/global layers, MLA, MoE, int8 KV,
                      the VLM, the encoder-decoder), its linears not
                      pluggable.  The batcher's default.

    ResidentBackend   weights live in device memory; the forward runs
                      eagerly layer by layer, each MLP's first stage
                      fused through the matmul kernels as in the stacked
                      whole model.
    HeteGenBackend    weights live in host memory; linears execute through
                      :class:`repro_torch.core.engine.HeteGenEngine` under a
                      batch- and phase-aware placement plan (resident /
                      alpha-split / streamed).

All expose the same serving surface — ``init_cache`` / ``prefill`` /
``decode`` / ``verify`` — and the two linear backends also ``linear`` and
``init_paged_cache``, so
:class:`repro_torch.serving.batcher.ContinuousBatcher` schedules over any
of them interchangeably; ``cache_batch_axis`` names the axis of the batch
in every cache leaf (the batcher's slot-merge axis).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.alpha import resolve_phase_tokens
from repro_torch.core.engine import HeteGenEngine, ModulePlan, StreamStats
from repro_torch.core.hw import H100_HOST, HardwareSpec
from repro_torch.core.policy import LinearSpec, PolicyResult, build_policy
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.telemetry.recalibrate import recalibrate_alpha
from repro_torch.telemetry.tracer import NULL_TRACER, Tracer


def enumerate_linears(cfg: ModelConfig,
                      wstream: str = "fp") -> List[LinearSpec]:
    """The model's offloadable linears with size groups (paper §4.3).

    ``wstream`` stamps the streamed wire format on every spec so the
    policy layer prices the link in wire bytes while compute stays in fp
    bytes."""
    by = cfg.dtype_bytes()
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    d, f = cfg.d_model, cfg.d_ff

    def spec(name, n_in, n_out, group):
        return LinearSpec(name, n_in, n_out, group, by, wire=wstream)

    out = []
    for l in range(cfg.n_layers):
        out += [
            spec(f"blk{l}.wq", d, hq * hd, "attn"),
            spec(f"blk{l}.wk", d, hkv * hd, "attn_kv"),
            spec(f"blk{l}.wv", d, hkv * hd, "attn_kv"),
            spec(f"blk{l}.wo", hq * hd, d, "attn"),
        ]
        if cfg.mlp_kind.startswith("gated"):
            out += [spec(f"blk{l}.w_gate", d, f, "mlp"),
                    spec(f"blk{l}.w_up", d, f, "mlp"),
                    spec(f"blk{l}.w_down", f, d, "mlp_down")]
        else:
            out += [spec(f"blk{l}.w_in", d, f, "mlp"),
                    spec(f"blk{l}.w_down", f, d, "mlp_down")]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


class ResidentBackend:
    """Device-resident weights; the shared forward runs eagerly.  Each
    layer's small-param dict also holds its MLP's first-stage weights, so
    that stage runs fused (:func:`repro_torch.models.layers.mlp`), which
    HeteGenBackend, whose linears split every weight, leaves out."""

    cache_batch_axis = 0

    def __init__(self, cfg: ModelConfig, params: Dict, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shared, weights, biases = M.extract_backend_params(cfg, params)
        self.shared = M.tree_to(shared, self.device)
        self.weights = {k: v.to(self.device) for k, v in weights.items()}
        self.biases = {k: v.to(self.device) for k, v in biases.items()}
        for l, small in enumerate(self.shared["layers"]):
            for nm in ("w_gate", "w_up", "w_in"):
                if f"blk{l}.{nm}" in self.weights:
                    small["mlp"][nm] = self.weights[f"blk{l}.{nm}"]
            if f"blk{l}.w_in" in self.biases:
                small["mlp"]["b_in"] = self.biases[f"blk{l}.w_in"]
        self._ops = M.make_backend_ops(cfg)

    # -- LinearBackend surface -----------------------------------------
    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = x @ self.weights[name]
        b = self.biases.get(name)
        return y if b is None else y + b

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return M.init_backend_cache(self.cfg, batch, max_len,
                                    device=self.device)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         page_size: int = 16,
                         n_pages: Optional[int] = None,
                         kv_dtype: Optional[str] = None,
                         check: bool = False) -> PagedKVCache:
        return PagedKVCache(self.cfg, batch, max_len, page_size=page_size,
                            n_pages=n_pages, kv_dtype=kv_dtype, check=check,
                            device=self.device)

    def prefill(self, batch: Dict, cache: Dict
                ) -> Tuple[Dict, torch.Tensor]:
        return M.backend_prefill(self.cfg, self.shared, batch, cache,
                                 linear=self.linear, ops=self._ops)

    def decode(self, token: torch.Tensor, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        return M.backend_decode(self.cfg, self.shared, token, cache,
                                linear=self.linear, ops=self._ops)

    def verify(self, batch: Dict, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        """Score all positions of a draft run: (B, S) tokens in, logits
        (B, S, V) out — one prefill-shaped step replaces S decode steps."""
        return M.backend_prefill(self.cfg, self.shared, batch, cache,
                                 linear=self.linear, ops=self._ops,
                                 all_logits=True)

    def close(self) -> None:
        pass


class ScanResidentBackend:
    """The scan-stacked resident path behind the backend serving surface.

    Runs :func:`repro_torch.models.model.prefill` /
    :func:`~repro_torch.models.model.decode_step` over the stacked params —
    the whole model the one-shot :class:`repro_torch.serving.engine.Generator`
    runs.  Unlike :class:`ResidentBackend` it serves every transformer
    family (Gemma-2's local/global layers, MLA, MoE, int8 KV, the VLM's
    patch embeddings, the encoder-decoder's frames and cross K/V), but its
    per-linear execution is not pluggable and its cache is not pageable;
    the batch axis of its cache leaves is 1 (stack-major).  The params are
    used as they are (moved to ``device`` only where they lie elsewhere).
    """

    cache_batch_axis = 1

    def __init__(self, cfg: ModelConfig, params: Dict, *, device=None):
        M._check_whole_model(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.tree_to(params, self.device)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return M.init_cache(self.cfg, batch, max_len, device=self.device)

    def init_paged_cache(self, batch: int, max_len: int, **kw):
        raise NotImplementedError(
            "the scan-stacked cache is not pageable; use ResidentBackend "
            "or HeteGenBackend for paged serving")

    def prefill(self, batch: Dict, cache: Dict
                ) -> Tuple[Dict, torch.Tensor]:
        return M.prefill(self.cfg, self.params, batch, cache)

    def decode(self, token: torch.Tensor, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        return M.decode_step(self.cfg, self.params, token, cache)

    def verify(self, batch: Dict, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        """Score all positions of a draft run: (B, S) tokens in, logits
        (B, S, V) out."""
        return M.prefill(self.cfg, self.params, batch, cache,
                         all_logits=True)

    def close(self) -> None:
        pass


class HeteGenBackend:
    """HeteGen-scheduled offloaded execution of the shared layer math.

    Weights live in host memory; every ``linear`` runs through a threaded
    :class:`HeteGenEngine` under a placement plan built for the real
    workload, one plan and engine partition per serving phase: decode
    moves every weight byte to produce ``batch`` tokens (small alpha),
    prefill computes ``batch * prompt`` positions against the same traffic
    (alpha -> 1), and a speculative verify scores ``batch * (k + 1)``
    positions against one weight stream (its own "verify" plan, between
    the two).  The prefill and verify plans are (re)tuned lazily from the
    observed shape, with a multiplicative hysteresis
    (``prefill_retune_factor``).  Engines share device-resident module
    copies through a common ``resident_store``.

    ``tile`` is the column granularity of every alpha split (128 by
    default, as in the JAX package).  ``hw`` defaults to
    :data:`repro_torch.core.hw.H100_HOST`, one host's
    measured speeds.  ``recalibrate=`` adapts the decode and verify plans
    to the host it runs on: every ``recalibrate_every`` decode or verify
    steps the stream speeds measured from each phase's spans re-solve the
    alpha law, and that phase's engine is rebuilt when its refined alpha
    moved by more than ``recalibrate`` (absolute).  It needs a tracer
    (``set_tracer``, or ``LLM(trace=True)``).  Every fit's alpha is kept
    in ``fit_alphas``; each rebuild is a ``replan`` span carrying the
    phase and the new ``alpha``.
    """

    cache_batch_axis = 0

    def __init__(self, cfg: ModelConfig, params: Dict, *,
                 hw: HardwareSpec = H100_HOST,
                 budget_bytes: Optional[float] = None,
                 batch: int = 1,
                 use_alpha_benchmark: bool = True,
                 use_module_scheduler: bool = True,
                 alpha_override: Optional[float] = None,
                 phase_plans: bool = True,
                 prefill_retune_factor: float = 2.0,
                 tracer: Tracer = NULL_TRACER,
                 recalibrate: Optional[float] = None,
                 recalibrate_every: int = 16,
                 wstream: str = "fp",
                 tile: int = 128,
                 device=None):
        if wstream not in ("fp", "q8"):
            raise ValueError(f"unknown wire format {wstream!r} "
                             "(expected 'fp' or 'q8')")
        self.cfg = cfg
        self.device = resolve_device(device)
        shared, weights, biases = M.extract_backend_params(cfg, params)
        self.shared = M.tree_to(shared, self.device)
        self._host_weights = {k: _host(v) for k, v in weights.items()}
        self._host_biases = {k: _host(v) for k, v in biases.items()}
        self._ops = M.make_backend_ops(cfg)
        self.wstream = wstream
        self.linears = enumerate_linears(cfg, wstream=wstream)
        self.hw = hw
        self.budget_bytes = budget_bytes
        self.use_alpha_benchmark = use_alpha_benchmark
        self.use_module_scheduler = use_module_scheduler
        self.alpha_override = alpha_override
        self.phase_plans = phase_plans
        self.tile = tile
        self.prefill_retune_factor = max(float(prefill_retune_factor), 1.0)
        self.batch: Optional[int] = None
        self.policies: Dict[str, PolicyResult] = {}
        self.engines: Dict[str, HeteGenEngine] = {}
        self._resident_store: Dict[str, torch.Tensor] = {}
        self._stats_tally = StreamStats()   # closed engines' busy seconds
        self._phase = "decode"
        self.step_prefetches = 0            # cross-step prefetch nudges
        self.tracer = tracer
        self.recalibrate = recalibrate
        self.recalibrate_every = max(int(recalibrate_every), 1)
        self.recalibrations = 0
        self.last_fit = None                # most recent trace FitResult
        self.fit_alphas: List[float] = []   # every fit's alpha, in order
        self._recal_steps = 0
        self._recal_mark = tracer.mark() if tracer else 0.0
        self.retune(batch)

    # -- phase/batch-aware planning ------------------------------------
    @property
    def policy(self) -> Optional[PolicyResult]:
        """The decode-phase plan."""
        return self.policies.get("decode")

    @property
    def engine(self) -> Optional[HeteGenEngine]:
        """The decode-phase engine."""
        return self.engines.get("decode")

    def retune(self, batch: int, phase: str = "decode", *,
               tokens_per_seq: Optional[int] = None) -> PolicyResult:
        """(Re)build ``phase``'s placement plan and engine for ``batch``.
        No-op when the phase already holds a plan for exactly this
        (batch, tokens_per_seq)."""
        batch = max(int(batch), 1)
        tokens_per_seq = resolve_phase_tokens(phase, tokens_per_seq)
        cur = self.policies.get(phase)
        if cur is not None and cur.batch == batch \
                and cur.tokens_per_seq == tokens_per_seq:
            return cur
        pol = build_policy(
            self.linears, self.hw, budget_bytes=self.budget_bytes,
            batch=batch, phase=phase, tokens_per_seq=tokens_per_seq,
            use_alpha_benchmark=self.use_alpha_benchmark,
            use_module_scheduler=self.use_module_scheduler, tile=self.tile)
        if self.alpha_override is not None:
            pol.plan = [
                ModulePlan(p.name, p.group, p.mode,
                           self.alpha_override if p.mode == "hetegen"
                           else p.alpha)
                for p in pol.plan]
        self._close_engine(phase)
        self.policies[phase] = pol
        keep = {p.name for r in self.policies.values()
                for p in r.plan if p.mode == "resident"}
        for name in list(self._resident_store):
            if name not in keep:
                del self._resident_store[name]
        self._open_engine(phase)
        if phase == "decode":
            self.batch = batch
        return pol

    def _close_engine(self, phase: str) -> None:
        """Close ``phase``'s engine, if any: its pools drain and its copy
        stream is synchronized, so no ring slot it owns has a copy in
        flight."""
        old = self.engines.pop(phase, None)
        if old is not None:
            # a replaced partition's busy seconds still happened
            self._stats_tally = self._stats_tally + old.finish_stats()
            old.close()

    def _open_engine(self, phase: str) -> None:
        """Build ``phase``'s engine for its current plan and stage the
        first module of each group."""
        eng = HeteGenEngine(self._host_weights, self.policies[phase].plan,
                            biases=self._host_biases, tile=self.tile,
                            device=self.device,
                            resident_store=self._resident_store,
                            tracer=self.tracer, trace_phase=phase,
                            wstream=self.wstream)
        eng.warm_prefetch()
        self.engines[phase] = eng

    def _ensure_prefill_plan(self, batch: int, seq: int) -> None:
        """Tune the prefill plan to the observed prompt shape; rebuild only
        when the intensity leaves [cur/f, cur*f]."""
        cur = self.policies.get("prefill")
        intensity = max(batch, 1) * max(seq, 1)
        if cur is not None:
            f = self.prefill_retune_factor
            if cur.intensity / f <= intensity <= cur.intensity * f:
                return
        self.retune(batch, phase="prefill", tokens_per_seq=seq)

    def _ensure_verify_plan(self, batch: int, seq: int) -> None:
        """Tune the verify plan to the observed draft-run shape.  Verify
        is a phase of its own: admission prefills run at batch x prompt
        (hundreds of tokens), verify at batch x (k + 1) (a handful), and
        one shared plan would thrash between them.  Same multiplicative
        hysteresis, so adaptive-k wobble does not rebuild the engine."""
        cur = self.policies.get("verify")
        intensity = max(batch, 1) * max(seq, 1)
        if cur is not None:
            f = self.prefill_retune_factor
            if cur.intensity / f <= intensity <= cur.intensity * f:
                return
        self.retune(batch, phase="verify", tokens_per_seq=seq)

    # -- tracing + trace-driven recalibration --------------------------
    def set_tracer(self, tracer: Tracer) -> None:
        """Attach a tracer to the backend and every live phase engine."""
        self.tracer = tracer
        self._recal_mark = tracer.mark() if tracer else 0.0
        for phase, eng in self.engines.items():
            eng.set_tracer(tracer, trace_phase=phase)

    def recalibrate_from_trace(self, phase: str = "decode"):
        """Refine ``phase``'s alpha from the spans recorded since the
        last recalibration; returns the ``FitResult`` (or None if the
        trace has no measurable spans for that phase — an all-resident
        plan, or tracing disabled)."""
        pol = self.policies.get(phase)
        if pol is None or not self.tracer:
            return None
        spans = self.tracer.spans(since=self._recal_mark or None)
        try:
            fit = recalibrate_alpha(spans, pol.alpha, phase=phase)
        except ValueError:
            return None
        self.last_fit = fit
        self.fit_alphas.append(fit.alpha)
        return fit

    def _apply_alpha(self, phase: str, alpha: float) -> None:
        """Rebuild ``phase``'s engine with a new hetegen alpha, keeping
        the residency/streaming decisions of the existing plan; the old
        engine closes before the new one is built."""
        pol = self.policies[phase]
        pol.plan = [ModulePlan(p.name, p.group, p.mode,
                               alpha if p.mode == "hetegen" else p.alpha)
                    for p in pol.plan]
        pol.alpha = float(alpha)
        self._close_engine(phase)
        self._open_engine(phase)

    def _maybe_recalibrate(self) -> None:
        """Periodic trace-driven re-tune, called at the top of a decode or
        verify step — the engines are idle there, so swapping a phase's
        partition is safe.  Opt-in (``recalibrate=``), with the drift
        threshold acting as hysteresis: a plan is only rebuilt when
        |refined - current| exceeds it.  Each phase with a plan ("decode",
        then "verify") fits its own spans recorded since the last fit;
        each rebuild is a ``replan`` span."""
        if self.recalibrate is None or not self.tracer:
            return
        self._recal_steps += 1
        if self._recal_steps % self.recalibrate_every:
            return
        mark = self.tracer.mark()
        fitted = False
        for phase in ("decode", "verify"):
            if phase not in self.policies:
                continue
            fit = self.recalibrate_from_trace(phase)
            if fit is None:
                continue
            fitted = True
            if abs(fit.alpha - self.policies[phase].alpha) \
                    > self.recalibrate:
                with self.tracer.span("replan", track="replan", phase=phase,
                                      alpha=float(fit.alpha)):
                    self._apply_alpha(phase, fit.alpha)
                self.recalibrations += 1
        if fitted:
            self._recal_mark = mark

    # -- LinearBackend surface -----------------------------------------
    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        eng = self.engines.get(self._phase) or self.engines["decode"]
        return eng.linear(x, name)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return M.init_backend_cache(self.cfg, batch, max_len,
                                    device=self.device)

    def init_paged_cache(self, batch: int, max_len: int, *,
                         page_size: int = 16,
                         n_pages: Optional[int] = None,
                         kv_dtype: Optional[str] = None,
                         check: bool = False) -> PagedKVCache:
        return PagedKVCache(self.cfg, batch, max_len, page_size=page_size,
                            n_pages=n_pages, kv_dtype=kv_dtype, check=check,
                            device=self.device)

    def prefill(self, batch: Dict, cache: Dict
                ) -> Tuple[Dict, torch.Tensor]:
        """A prompt's forward under the "prefill" phase plan, tuned to its
        (B, S): of ``batch["tokens"]``, or of the VLM's patch embeddings
        ``batch["embeds"]`` (B, S, d), which then take the HeteGen split
        like any prompt."""
        if self.phase_plans:
            if "tokens" in batch:
                b, s = batch["tokens"].shape
            else:
                b, s = batch["embeds"].shape[:2]
            self._ensure_prefill_plan(b, s)
            self._phase = "prefill"
        try:
            return M.backend_prefill(self.cfg, self.shared, batch, cache,
                                     linear=self.linear, ops=self._ops)
        finally:
            self._phase = "decode"

    def decode(self, token: torch.Tensor, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        self._maybe_recalibrate()
        return M.backend_decode(self.cfg, self.shared, token, cache,
                                linear=self.linear, ops=self._ops)

    def verify(self, batch: Dict, cache: Dict
               ) -> Tuple[Dict, torch.Tensor]:
        """Speculative scoring pass under the "verify" phase plan —
        intensity batch x (k + 1), the prefill-like regime, though the
        step advances the decode frontier.  Logits (B, S, V)."""
        self._maybe_recalibrate()
        if self.phase_plans:
            b, s = batch["tokens"].shape
            self._ensure_verify_plan(b, s)
            self._phase = "verify"
        try:
            return M.backend_prefill(self.cfg, self.shared, batch, cache,
                                     linear=self.linear, ops=self._ops,
                                     all_logits=True)
        finally:
            self._phase = "decode"

    def prefetch_next_step(self) -> None:
        """Drive step N+1's pins while step N's host tail drains: by the
        time the batcher calls this every slot has been released, so
        re-issuing the first-of-each-group prefetch lands.  Idempotent
        and non-blocking."""
        eng = self.engines.get("decode")
        if eng is not None:
            eng.warm_prefetch()
            self.step_prefetches += 1

    # -- stats over all phase engines ----------------------------------
    def reset_stats(self) -> None:
        self._stats_tally = StreamStats()
        for eng in self.engines.values():
            eng.reset_stats()

    def finish_stats(self) -> StreamStats:
        out = self._stats_tally
        for eng in self.engines.values():
            out = out + eng.finish_stats()
        return out

    def device_resident_bytes(self) -> int:
        seen: Dict[str, int] = {}
        for eng in self.engines.values():
            for name, t in eng._resident.items():
                seen[name] = t.numel() * t.element_size()
        return sum(seen.values())

    def pinned_overhead_bytes(self) -> int:
        return sum(eng.pinned_overhead_bytes()
                   for eng in self.engines.values())

    def close(self) -> None:
        for eng in self.engines.values():
            eng.close()
        self.engines.clear()
        self._resident_store.clear()
