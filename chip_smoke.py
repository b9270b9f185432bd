"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--layers 32]

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the ``-Xptxas -v``
   register / shared-memory summary;
3. the main path: OPT-6.7B at full width (d 4096, 32 heads, FFN 16384,
   vocab 50272, fp32; ``--layers`` of 32, random weights from a seed)
   served by ``LLM(paged=True, backend=HeteGenBackend(...))`` with
   ``submit`` + ``drain``: four greedy requests with ``chunk_tokens`` set
   so the prefill kernel sees ``kv_offset > 0`` — once with fp32 weights
   on the wire and fp32 pages, once with ``wstream="q8"`` and int8 pages.
   Kernel launch counters are zeroed just before and read just after each
   run.  The fp run's prefill logits are held against the port's
   ``ResidentBackend`` on the card;
4. every kernel against its plain PyTorch version on the same card
   inputs at the main path's shapes (these launches come after the
   counters were read, so they do not count), with CUDA-event times of kernel,
   plain version and (where one exists) a single PyTorch library call,
   beside the least time the card could take (bytes over 3.35 TB/s or
   fp32 FLOPs over 67 TFLOP/s, whichever is larger);
5. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.alpha import split_columns  # noqa: E402
from repro_torch.core.hw import H100_HOST  # noqa: E402
from repro_torch.core.policy import build_policy  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k_decode  # noqa: E402
from repro_torch.kernels import paged_prefill as k_prefill  # noqa: E402
from repro_torch.kernels import q8_matmul as k_q8  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.backends import (HeteGenBackend,  # noqa: E402
                                          ResidentBackend,
                                          enumerate_linears)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM data sheet, fp32 without TC
PAGE_SIZE = 16
MAX_NEW = 8                        # new tokens per request
CHUNK = 32                         # chunk_tokens of the chunked prefill
SEED = 0
LOGIT_TOL = 2e-3                   # relative to the logits' max |value|


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` launches (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_prompts(vocab: int, seed: int):
    """Four prompts of two chunks each (with the default 32-token chunk):
    the second chunks (18-31 tokens) stay within the prefill plan's 2x
    retune hysteresis of the first, so the plan is built once."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, n)) for n in (50, 56, 60, 63)]


def run_main_path(cfg, host_params, prompts, *, wstream, kv_dtype):
    """One serving run through the public entry points; returns tokens,
    the launch counts it caused and its stats."""
    t0 = time.perf_counter()
    be = HeteGenBackend(cfg, host_params, wstream=wstream, batch=4,
                        device="cuda")
    # load: partition (and, for q8, quantize) both phase plans up front,
    # the prefill one at the chunk shape the run admits at
    be.retune(1, phase="prefill", tokens_per_seq=CHUNK)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with LLM(cfg, backend=be, own_backend=True, paged=True,
             page_size=PAGE_SIZE, kv_dtype=kv_dtype, max_slots=4,
             max_len=256, chunk_tokens=CHUNK, wstream=wstream) as llm:
        rids = [llm.submit(p, max_new=MAX_NEW) for p in prompts]
        outs = llm.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        st = llm.stats()
    toks = [outs[r].tokens for r in rids]
    check(all(len(t) == MAX_NEW for t in toks), f"{wstream}: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          f"{wstream}: token out of vocab")
    s = st["stream"]
    log(f"main path wstream={wstream} kv_dtype={kv_dtype or 'float32'}: "
        f"load {load_s:.3f} s, {sum(map(len, toks))} tokens in {wall:.3f} s "
        f"({sum(map(len, toks)) / wall:.3f} tok/s, drain "
        f"{st['tokens_per_s']:.3f} tok/s), steps={st['steps']}, "
        f"chunks={st['scheduler']['chunks_planned']}, "
        f"phase_alpha={st['phase_alpha']}, "
        f"busy_s cpu={s.cpu:.3f} pin={s.pin:.3f} trans={s.trans:.3f} "
        f"dev={s.dev:.3f} wall={s.wall:.3f}, "
        f"peak_device_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, launches={launches}")
    return toks, launches, st


def compare_prefill_logits(cfg, params, host_params, prompts):
    """The fp backend's prefill logits against ResidentBackend's."""
    toks = torch.tensor([p[:32] for p in prompts], dtype=torch.int32,
                        device="cuda")

    def prefill(be):
        kv = be.init_paged_cache(len(prompts), 64, page_size=PAGE_SIZE)
        for i in range(len(prompts)):
            kv.alloc(i, 32)
        cache = kv.init_cache()
        cache["len"] = torch.zeros((), dtype=torch.int32, device="cuda")
        _, logits = be.prefill({"tokens": toks}, cache)
        return logits

    want = prefill(ResidentBackend(cfg, params, device="cuda"))
    hb = HeteGenBackend(cfg, host_params, batch=4, device="cuda")
    try:
        got = prefill(hb)
    finally:
        hb.close()
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"prefill logits HeteGen(fp) vs Resident: max_abs_err={err:.3e} "
        f"max|logit|={scale:.3e} tol={LOGIT_TOL:.0e} relative")
    check(err <= LOGIT_TOL * max(scale, 1.0), "prefill logits disagree")


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(gen, b, hq, hkv, d, lens, q8):
    nb = max(-(-n // PAGE_SIZE) for n in lens)
    n_pages = 1 + b * nb
    shape = (n_pages, hkv, PAGE_SIZE, d)
    if q8:
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
        vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
    else:
        kp = torch.randn(shape, generator=gen, device="cuda")
        vp = torch.randn(shape, generator=gen, device="cuda")
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.reshape(b, nb).to(torch.int32).contiguous()
    return kp, vp, ks, vs, bt


def kv_bytes(lens, hkv, d, q8):
    per_tok = hkv * (2 * d * (1 if q8 else 4) + (8 if q8 else 0))
    return sum(lens) * per_tok


def kernel_entry(name, source, replaces, launches, err, tol, kernel_fn,
                 plain_fn, library_fn, nbytes, flops):
    check(err <= tol, f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn)
    library_ms = None if library_fn is None else time_ms(library_fn)
    b_ms, b_by = bound(nbytes, flops)
    log(f"kernel {name}: max_abs_err={err:.3e} (tol {tol:.1e}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={'none' if library_ms is None else f'{library_ms:.4f}'} "
        f"bound_ms={b_ms:.4f} ({b_by}) launches={launches}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def check_kernels(cfg, launches, q8_cols):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    b, hq, hkv, d = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    entries = []

    # paged decode: B 4, kv_len up to a few thousand, fp32 and int8 pages
    lens = [512, 1100, 2048, 3001]
    for q8 in (False, True):
        kp, vp, ks, vs, bt = paged_inputs(gen, b, hq, hkv, d, lens, q8)
        q = torch.randn((b, hq, d), generator=gen, device="cuda")
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(k_scale=ks, v_scale=vs)
        got = k_decode.paged_decode_attention(q, kp, vp, bt, kl, **kw)
        want = ref.paged_decode_attention(q, kp, vp, bt, kl, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        nbytes = q.numel() * 4 * 2 + kv_bytes(lens, hkv, d, q8) \
            + bt.numel() * 4 + 16
        flops = 4 * hq * d * sum(lens)
        entries.append(kernel_entry(
            "paged_decode_attention" + ("_q8" if q8 else ""),
            "src/repro_torch/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention.py:160",
            launches["paged_decode_attention"][q8], err, 2e-4 if q8 else 2e-5,
            lambda: k_decode.paged_decode_attention(q, kp, vp, bt, kl, **kw),
            lambda: ref.paged_decode_attention(q, kp, vp, bt, kl, **kw),
            None, nbytes, flops))

    # paged prefill: 4 chunks of 64 queries at kv offsets past page edges
    s = 64
    offs = [0, 64, 517, 1500]
    for q8 in (False, True):
        kp, vp, ks, vs, bt = paged_inputs(gen, b, hq, hkv, d,
                                          [o + s for o in offs], q8)
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda")
        ko = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = dict(k_scale=ks, v_scale=vs)
        got = k_prefill.paged_prefill_attention(q, kp, vp, bt, ko, **kw)
        want = ref.paged_prefill_attention(q, kp, vp, bt, ko, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        nbytes = q.numel() * 4 * 2 + kv_bytes([o + s for o in offs], hkv, d,
                                              q8) + bt.numel() * 4 + 16
        flops = 4 * hq * d * sum((o + r + 1) for o in offs for r in range(s))
        entries.append(kernel_entry(
            "paged_prefill_attention" + ("_q8" if q8 else ""),
            "src/repro_torch/csrc/paged_prefill_attention.cu",
            "src/repro/kernels/paged_prefill.py:197",
            launches["paged_prefill_attention"][q8], err,
            2e-4 if q8 else 2e-5,
            lambda: k_prefill.paged_prefill_attention(q, kp, vp, bt, ko,
                                                      **kw),
            lambda: ref.paged_prefill_attention(q, kp, vp, bt, ko, **kw),
            None, nbytes, flops))

    # q8 matmul: decode M = 4 and prefill M = 4 chunks x 32, K = d_model,
    # N = the decode plan's device columns of the widest linear
    k = cfg.d_model
    n = q8_cols
    for m in (4, 4 * 32):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        qw, sc = (torch.from_numpy(a).cuda() for a in
                  k_q8.quantize_weights_np(w.cpu().numpy()))
        got = k_q8.q8_matmul(x, qw, sc)
        want = ref.q8_matmul(x, qw, sc)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        lib = library_q8(x, qw, sc)
        entries.append(kernel_entry(
            f"q8_matmul_m{m}", "src/repro_torch/csrc/q8_matmul.cu",
            "src/repro/kernels/q8_matmul.py:85", launches["q8_matmul"], err,
            tol, lambda: k_q8.q8_matmul(x, qw, sc),
            lambda: ref.q8_matmul(x, qw, sc), lib,
            m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * n * k))
    return entries


def library_q8(x, qw, sc):
    """PyTorch's own int8-weight matmul (``_weight_int8pack_mm``: x @ w.T
    * scales with w (N, K) int8) as the yardstick, where this build has
    it for CUDA fp32 activations; None otherwise."""
    op = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    if op is None:
        return None
    wt = qw.t().contiguous()
    try:
        y = op(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"library q8: _weight_int8pack_mm unavailable here ({e!s:.80})")
        return None
    if not torch.allclose(y, ref.q8_matmul(x, qw, sc), rtol=1e-3, atol=1e-3):
        log("library q8: _weight_int8pack_mm disagrees; not used")
        return None
    return lambda: op(x, wt, sc)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of OPT-6.7B to run (of 32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # fp32 everywhere: no TF32 in matmuls, so the plain versions and the
    # ResidentBackend reference are full-precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = kbuild.build()
    for name, out in logs.items():
        summary = " | ".join(line.strip() for line in out.splitlines()
                             if "registers" in line or "Compiling" in line)
        log(f"build {name}: {summary}")
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} kernels")

    full = get_config("opt-6.7b")
    check(1 <= args.layers <= full.n_layers, "bad --layers")
    import dataclasses
    cfg = dataclasses.replace(full, n_layers=args.layers)
    log(f"model: opt-6.7b at full width, {cfg.n_layers} of "
        f"{full.n_layers} layers, d={cfg.d_model} heads={cfg.n_heads} "
        f"ffn={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
    host_params = M.tree_to(params, "cpu")
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(cfg.vocab_size, SEED)

    compare_prefill_logits(cfg, params, host_params, prompts)
    del params
    torch.cuda.empty_cache()

    _, l_fp, _ = run_main_path(cfg, host_params, prompts, wstream="fp",
                               kv_dtype=None)
    _, l_q8, _ = run_main_path(cfg, host_params, prompts, wstream="q8",
                               kv_dtype="int8")
    for run, counts in (("fp", l_fp), ("q8", l_q8)):
        check(counts["paged_decode_attention"] > 0,
              f"{run} run never launched paged_decode_attention")
        check(counts["paged_prefill_attention"] > 0,
              f"{run} run never launched paged_prefill_attention")
    check(l_q8["q8_matmul"] > 0, "q8 run never launched q8_matmul")
    launches = {
        "paged_decode_attention": {False: l_fp["paged_decode_attention"],
                                   True: l_q8["paged_decode_attention"]},
        "paged_prefill_attention": {False: l_fp["paged_prefill_attention"],
                                    True: l_q8["paged_prefill_attention"]},
        "q8_matmul": l_q8["q8_matmul"],
    }

    pol = build_policy(enumerate_linears(cfg, "q8"), H100_HOST, batch=4,
                       phase="decode")
    q8_cols = split_columns(pol.alpha, cfg.d_ff)
    entries = check_kernels(cfg, launches, q8_cols)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
