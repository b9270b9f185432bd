"""Cell 3's fp serving run, timed, from one checkout of the port: the A/B
harness for changes to the offload engine's streams.

    python3 tools/serve_ab.py --src DIR [--trace] [--spec placeholder]

imports ``repro_torch`` from ``DIR/src``, makes OPT-6.7B's weights at full
width from a seed on the card, and serves ``chip_smoke.py``'s cell 3
through the public entry points: ``HeteGenBackend`` (fp wire, decode batch
4, the prefill plan at the 32-token chunk) under ``LLM(paged=True)`` with
fp32 pages, four prompts of 50-63 tokens, 8 new tokens each.  It prints
one JSON line: serve seconds, tok/s, each stream's busy seconds from the
engines' counters, and the planned alphas.

``--spec placeholder`` plans with the ``H100_HOST`` host and link fields
the port had before they were fitted, so checkouts with different
defaults plan the same split.  ``--trace`` serves with ``trace=True``
(checkouts that have it).  Run it on the card, one process a run, and
alternate checkouts within one machine to compare them (hosts differ from
call to call).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


# H100_HOST's host and link fields before they were fitted
PLACEHOLDER = dict(host_flops=1.0e12, host_mem_bw=50e9, host_mem_bytes=1e12,
                   link_bw=25e9, link_bw_unpinned=10e9, pin_bw=20e9)
SEED = 0
CHUNK = 32
PAGE_SIZE = 16
MAX_NEW = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="checkout whose src/repro_torch is served")
    ap.add_argument("--label", default="")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--spec", choices=("default", "placeholder"),
                    default="default")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.hw import H100_HOST
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM
    from repro_torch.serving.backends import HeteGenBackend

    cfg = dataclasses.replace(get_config("opt-6.7b"), n_layers=args.layers)
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
    host_params = M.tree_to(params, "cpu")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in (50, 56, 60, 63)]
    hw = H100_HOST if args.spec == "default" else dataclasses.replace(
        H100_HOST, **PLACEHOLDER)
    be = HeteGenBackend(cfg, host_params, hw=hw, wstream="fp", batch=4,
                        device="cuda")
    be.retune(1, phase="prefill", tokens_per_seq=CHUNK)
    kw = {"trace": True} if args.trace else {}
    t0 = time.perf_counter()
    with LLM(cfg, backend=be, own_backend=True, paged=True,
             page_size=PAGE_SIZE, max_slots=4, max_len=256,
             chunk_tokens=CHUNK, wstream="fp", **kw) as llm:
        rids = [llm.submit(p, max_new=MAX_NEW) for p in prompts]
        outs = llm.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = llm.stats()
        alphas = {ph: pol.alpha for ph, pol in be.policies.items()}
    toks = [outs[r].tokens for r in rids]
    if not all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                         for x in t) for t in toks):
        print("serve_ab: incomplete or out-of-vocab tokens", file=sys.stderr)
        return 1
    s = st["stream"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "src": args.src, "trace": args.trace,
        "spec": args.spec, "layers": args.layers, "card": smi,
        "serve_s": wall, "tok_s": sum(map(len, toks)) / wall,
        "busy_s": {"cpu": s.cpu, "pin": s.pin, "trans": s.trans,
                   "dev": s.dev},
        "alpha": alphas, "tokens": toks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
