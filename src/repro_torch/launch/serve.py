"""Serving launcher — the paper's deployment shape, on the port.

Every mode is flag parsing over ONE front door,
:class:`repro_torch.serving.api.LLM`:

    resident       one-shot generation, weights on the device
    offload        HeteGen: weights in host memory, alpha-split linears,
                   pinned-ring streaming (``--budget-frac`` sets the device
                   memory available for residency promotion), one
                   placement plan per serving phase
    batch          continuous batching over N synthetic requests
    batch-offload  continuous batching over HeteGen-offloaded weights

The modes differ only in which backend is handed to the facade and
whether requests arrive together (one-shot executor) or staggered
(continuous batcher).  ``--policy fcfs|priority|fair_share`` picks the
scheduler policy (with ``priority`` request i carries priority ``i %% 2``),
``--async`` serves through the event-loop
:class:`repro_torch.serving.api.AsyncLLM` (no caller-driven ``step()``),
``--n-pages`` shrinks the paged pool to provoke preemption, ``--paged``
swaps the batch modes to the paged KV cache, ``--sampler`` picks the
per-request sampling and ``--stream`` prints the first request's tokens
as they decode.  ``--spec ngram|model`` turns on speculative decoding
(host drafting, one batched verify a step) with ``--spec-k`` draft tokens
a step and ``--spec-adaptive`` per-request k control; ``--trace OUT.json``
writes a Chrome trace and ``--overlap-report`` prints the overlap of the
four streams.  Weights are random, from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --mode batch-offload --paged --spec ngram --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-6.7b \\
        --mode batch-offload --paged --requests 4

``--device`` defaults to ``cuda`` and ``--hw`` to ``h100`` (the port's
fitted host spec).  ``--dryrun`` (with ``--shape``/``--mesh``) runs
:func:`repro_torch.launch.dryrun.run_cell` for ``--arch`` on that cell
instead, on ``--device`` (``meta`` for a shape-only trace), and returns
its record.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--mode", choices=("resident", "offload", "batch",
                                       "batch-offload"),
                    default="offload")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda | cpu)")
    ap.add_argument("--budget-frac", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache for the batch modes")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--policy", choices=("fcfs", "priority", "fair_share"),
                    default="fcfs", help="scheduler admission/preemption "
                    "policy for the batch modes")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the event-loop AsyncLLM "
                    "(no caller-driven step())")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="shrink the paged pool to provoke preemption")
    ap.add_argument("--selfcheck", action="store_true",
                    help="paged-allocator self-check: validate the "
                    "free-list/ref-count/block-table invariants every "
                    "step and audit for leaked pages at close")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: admit long prompts at most "
                    "this many tokens a step")
    ap.add_argument("--no-prefix-dedupe", action="store_true",
                    help="disable admission-time page-aligned prompt "
                    "prefix sharing (paged mode only)")
    ap.add_argument("--spec", choices=("ngram", "model"), default=None,
                    help="speculative decoding: host drafting (prompt "
                    "lookup or a draft model) with one batched verify "
                    "a step on the target")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative step")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="adapt k per request from its acceptance")
    ap.add_argument("--sampler", choices=("greedy", "temperature", "topk",
                                          "topp"), default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="stream the first request token by token")
    ap.add_argument("--hw", default="h100", help="hardware model for the "
                    "alpha law (h100 | a10 | v5e)")
    ap.add_argument("--wstream", choices=("fp", "q8"), default="fp",
                    help="wire format of streamed weights in the offload "
                    "modes: fp streams shards as they are, q8 streams "
                    "int8 + per-column fp32 scales")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record spans across the run and write a "
                    "Chrome trace JSON")
    ap.add_argument("--overlap-report", action="store_true",
                    help="print the per-step I/O-hidden fraction, stream "
                    "utilization and critical path from the trace "
                    "(implies tracing)")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    return ap


def make_prompts(vocab: int, n: int, length: int,
                 repetitive: bool) -> List[List[int]]:
    """``n`` prompts of ``length`` tokens from seed 0; with
    ``repetitive`` each repeats a 4-token motif, so the prompt-lookup
    drafter has something to look up."""
    import numpy as np
    rng = np.random.default_rng(0)
    if repetitive:
        motif = [list(rng.integers(0, vocab, 4)) for _ in range(n)]
        return [(m * length)[:length] for m in motif]
    return [list(rng.integers(0, vocab, length)) for _ in range(n)]


def serve(args: argparse.Namespace, params: Optional[Dict] = None) -> Dict:
    """Serve ``args.requests`` requests as the flags say and print the
    run's summary; returns ``{"outputs", "stats"}`` (with ``--dryrun``,
    the dry-run cell's record, or exit 1 when the cell failed).  ``params`` replaces
    the random weights (made on ``args.device`` from seed 0 when None)."""
    if args.dryrun:
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell(args.arch, args.shape, args.mesh, device=args.device)
        if rec["status"] == "error":
            raise SystemExit(1)
        return rec
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.hw import HARDWARE
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM
    from repro_torch.serving.sampling import SamplingParams

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if params is None:
        params = M.init_params(cfg, 0, device=device)
    prompts = make_prompts(cfg.vocab_size, args.requests, args.prompt_len,
                           args.spec is not None)
    sampling = SamplingParams(
        kind=args.sampler, temperature=args.temperature,
        top_k=40 if args.sampler == "topk" else 0,
        top_p=0.9 if args.sampler == "topp" else 1.0)
    print(f"serving {cfg.name} ({cfg.param_count()/1e6:.1f}M) "
          f"mode={args.mode} sampler={args.sampler} device={device}")

    # the one difference between modes: which backend the facade drives.
    # The slot count is the decode width the facade schedules, and so the
    # batch the offload plan is built for
    slots = args.requests if args.mode == "offload" else 4
    backend = None
    if args.mode in ("offload", "batch-offload"):
        from repro_torch.serving.backends import (HeteGenBackend,
                                                  enumerate_linears)
        total = sum(s.nbytes for s in enumerate_linears(cfg))
        backend = HeteGenBackend(cfg, params, hw=HARDWARE[args.hw],
                                 batch=slots,
                                 budget_bytes=args.budget_frac * total,
                                 wstream=args.wstream, device=device)
        if args.wstream == "q8":
            print(f"  wstream=q8: int8+scale wire format, "
                  f"decode alpha={backend.policy.alpha:.3f}")

    spec = None
    if args.spec is not None:
        from repro_torch.serving.speculative import (ModelDrafter,
                                                     NgramDrafter,
                                                     SpecConfig)
        drafter = NgramDrafter() if args.spec == "ngram" else \
            ModelDrafter(cfg, params, device=device,
                         max_len=args.prompt_len + args.max_new + 8)
        spec = SpecConfig(drafter=drafter, k=args.spec_k,
                          adaptive=args.spec_adaptive)

    tracing = bool(args.trace or args.overlap_report)
    llm_kw = dict(sampling=sampling, max_slots=slots,
                  max_len=args.prompt_len + args.max_new + 8,
                  paged=args.paged, page_size=args.page_size,
                  n_pages=args.n_pages, policy=args.policy,
                  chunk_tokens=args.chunk_tokens,
                  prefix_dedupe=False if args.no_prefix_dedupe else None,
                  spec=spec, selfcheck=args.selfcheck, trace=tracing)
    if backend is None:
        llm_kw["device"] = device

    def prio(i: int) -> int:
        # give the priority policy something to schedule
        return i % 2 if args.policy == "priority" else 0

    if args.use_async:
        from repro_torch.serving.api import AsyncLLM
        with AsyncLLM(cfg, params, backend=backend, own_backend=True,
                      **llm_kw) as allm:
            facade = allm.llm
            if args.stream:
                for tok in allm.stream(prompts[0], args.max_new):
                    print(f"  stream> {tok}", flush=True)
                prompts = prompts[1:]
            handles = [allm.submit(p, args.max_new, priority=prio(i))
                       for i, p in enumerate(prompts)]
            outs = [h.result() for h in handles]
            st = allm.stats()
    else:
        with LLM(cfg, params, backend=backend, own_backend=True,
                 **llm_kw) as llm:
            facade = llm
            if args.stream:
                for tok in llm.stream(prompts[0], args.max_new):
                    print(f"  stream> {tok}", flush=True)
                prompts = prompts[1:]
            if args.mode in ("resident", "offload"):
                # requests arrive together: one-shot
                outs = llm.generate(prompts, args.max_new) \
                    if prompts else []
            else:
                # staggered arrivals: continuous batching
                rids = [llm.submit(p, args.max_new, priority=prio(i))
                        for i, p in enumerate(prompts)]
                done = llm.drain()
                outs = [done[r] for r in rids]
            st = llm.stats()

    total_toks = sum(len(o.tokens) for o in outs)
    print(f"{len(outs)} requests, {total_toks} tokens "
          f"via executor={st['executor']}, "
          f"{st.get('tokens_per_s', 0.0):.1f} tok/s")
    if "scheduler" in st:
        sc = st["scheduler"]
        print(f"scheduler: policy={sc['policy']} "
              f"preemptions={sc['preemptions']} "
              f"chunks={sc['chunks_planned']} "
              f"dedupe_hits={sc['dedupe_hits']} "
              f"(+{sc['dedupe_tokens']} tokens shared)")
    if "phase_alpha" in st:
        al = st["phase_alpha"]
        print("phase plans: " + "  ".join(
            f"{ph}: alpha={a:.3f}" for ph, a in sorted(al.items())))
        print(f"resident={st['resident_bytes']/1e6:.0f}MB")
    if "stream" in st:
        s = st["stream"]
        print(f"stream busy (s): cpu={s.cpu:.3f} pin={s.pin:.3f} "
              f"trans={s.trans:.3f} dev={s.dev:.3f}")
    if "paged" in st:
        pg = st["paged"]
        print(f"paged KV: page_size={pg['page_size']} "
              f"pool={pg['pool_pages']} pages, "
              f"{pg['mapped_pages']} still mapped")
    if "spec" in st:
        sp = st["spec"]
        print(f"speculative: drafter={args.spec} k={args.spec_k} "
              f"drafted={sp['drafted']} accepted={sp['accepted']} "
              f"rolled_back={sp['rolled_back']} "
              f"(acceptance {sp['acceptance_rate']:.2f})")
    if tracing:
        # the tracer's buffers are host memory and outlive close()
        if args.trace:
            doc = facade.write_trace(args.trace)
            print(f"trace: {args.trace} "
                  f"({len(doc['traceEvents'])} events)")
        if args.overlap_report:
            print(facade.overlap_report().render())
    return {"outputs": outs, "stats": st}


def main(argv: Optional[Sequence[str]] = None) -> None:
    serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
