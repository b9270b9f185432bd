"""Compare builds of the port's kernels on one card, in one process: host
time per call, device time per call, and whole runs of ``chip_smoke.py``'s
cells with each build in turn.  The kernels: ``decode_attention`` and
``q8_matmul`` at their decode shapes, ``q8_matmul`` at cell 3's prefill
shapes (M 18 and 32), bf16 ``flash_attention`` at 3b's prefill,
``gated_matmul`` at 3b's and 3e's prefill (2048, 500 and 512 rows) and
at 3b's, 3j's and 3l's decode (4 and 2 rows) and at K 18432 (2048 and
130 rows, N 2048), bf16 ``matmul`` at 3l's Whisper and Nemotron shapes,
``paged_decode_attention`` under a bf16 q at 3e's decode (bf16 and int8
pages) and under an fp32 q at cell 3's two most frequent decode shapes
and the long-context shape (fp32 and int8 pages), fp32
``flash_attention`` at 3c's and 3f's prefill,
``paged_prefill_attention`` at 3e's prefill (bf16 and int8 pages), at
cell 3's two chunk shapes and at the long-context shape (fp32 and int8
pages), fp32 ``matmul`` at 3f's fc1 shapes, and bf16 ``ssd_chunk`` at
3d's prefill.

    python tools/ab_kernels.py --other parent=.archive_check/parent \\
        [--other name=DIR ...] [--pairs 10] [--runs 3d,3e,3f] \\
        [--shapes q8,flash] [--out FILE]

``DIR`` is another checkout of the repo, such as a ``git archive`` of a
commit unpacked in a gitignored directory.  Its sources are built with
the port's nvcc flags beside the tree's, and every build is called through
the tree's own wrappers: the wrapper's entry in ``build``'s table of C
functions is swapped, so the argument layout is the wrapper's (the builds'
C signatures must agree).  ``--variant NAME=LIB:FILE`` builds one source
file (with ``csrc/`` on the include path) in place of library ``LIB`` and
takes the tree's build for the others, for a design variant such as
``tools/flash_f32_3xtf32.cu``; a shape whose call a build refuses is
logged and left out for that build.

Per kernel shape (those whose name holds one of ``--shapes``' words, or
all), builds in turns, forward then backward, ``--rounds``
times (medians printed): ``wrapper_us``, the host's time to issue one
wrapper call (100 calls back to back, timed before the device is waited
for); ``entry_us``, the same for the C entry alone, called with one call's
packed arguments; ``device_ms``, 20 calls in a CUDA graph
(``chip_smoke.device_ms``).  Then ``--pairs`` pairs of each run in
``--runs``, the first ``--other`` build against the tree's in alternating
order (other, tree; tree, other; ...): 3b, Mistral-NeMo-12B's resident
one-shot over a bf16 and an int8 cache (prefill s, decode tok/s); 3e, the same
weights through the paged batcher over bf16 and int8 pages (tok/s of the
whole run); 3f, OPT-6.7B resident in fp32 (prefill s and decode tok/s);
3d, Mamba2-2.7B resident in bf16 (prefill s and decode tok/s).
Prints a line per reading and a JSON line of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as k_dense  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import hete_matmul as k_mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k_paged  # noqa: E402
from repro_torch.kernels import paged_prefill as k_prefill  # noqa: E402
from repro_torch.kernels import q8_matmul as k_q8  # noqa: E402
from repro_torch.kernels import ssd_chunk as k_ssd  # noqa: E402

# (library, C symbol) -> the wrapper's argument types
ENTRIES = {("decode_attention", "decode_attention"): k_dense._ARGTYPES,
           ("q8_matmul", "q8_matmul_f32"): k_q8._ARGTYPES,
           ("flash_attention", "flash_attention"): k_flash._ARGTYPES,
           ("hete_matmul", "hete_gated_matmul"): k_mm._ARGTYPES,
           ("hete_matmul", "hete_matmul"): k_mm._ARGTYPES,
           ("paged_prefill_attention", "paged_prefill_attention"):
               k_prefill._ARGTYPES,
           ("paged_decode_attention", "paged_decode_attention"):
               k_paged._ARGTYPES,
           ("ssd_chunk", "ssd_chunk"): k_ssd._ARGTYPES}
LIBRARIES = sorted({lib for lib, _ in ENTRIES})
CALLS = 100


def build_others(others) -> dict:
    """The libraries of each checkout in ``others`` ({name: DIR}), built
    into ``_build/ab/<name>`` (one nvcc each, all started together), their
    entries looked up like ``build.c_function``.  A build that fails is
    logged and left out."""
    procs = {}
    for name, tree in others.items():
        out = build.BUILD_DIR / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        for lib in LIBRARIES:
            src = os.path.join(tree, "src", "repro_torch", "csrc",
                               lib + ".cu")
            so = out / f"lib{lib}.so"
            procs[name, lib] = (so, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    builds, failed = {}, set()
    for (name, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.log(f"nvcc failed for {name}/{lib}, build left out:\n{log}")
            failed.add(name)
            continue
        dll = ctypes.CDLL(str(so))
        for (elib, symbol), argtypes in ENTRIES.items():
            if elib != lib:
                continue
            c = getattr(dll, symbol)
            c.argtypes = [ctypes.c_char_p]
            c.restype = ctypes.c_int
            builds.setdefault(name, {})[elib, symbol] = build.CFunction(
                c, symbol, argtypes)
    return {n: fns for n, fns in builds.items() if n not in failed}


def build_variants(variants, tree) -> dict:
    """The builds of ``variants`` ({name: (LIB, FILE)}): FILE compiled as
    library LIB into ``_build/ab/<name>`` (one nvcc each, all started
    together), the tree's entries for every other library.  A build that
    fails is logged and left out."""
    procs = {}
    for name, (lib, path) in variants.items():
        out = build.BUILD_DIR / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        so = out / f"lib{lib}.so"
        procs[name] = (lib, so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(so), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    builds = {}
    for name, (lib, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.log(f"nvcc failed for {name}, build left out:\n{log}")
            continue
        dll = ctypes.CDLL(str(so))
        fns = dict(tree)
        for (elib, symbol), argtypes in ENTRIES.items():
            if elib == lib:
                c = getattr(dll, symbol)
                c.argtypes = [ctypes.c_char_p]
                c.restype = ctypes.c_int
                fns[elib, symbol] = build.CFunction(c, symbol, argtypes)
        builds[name] = fns
    return builds


def use(fns: dict) -> None:
    """Route the wrappers to one build's C functions."""
    for key in ENTRIES:
        build._fns[key] = fns[key]


def packed_call(call):
    """The C function and packed arguments of one wrapper call."""
    seen = {}
    launch = build.launch

    def grab(fn, index, *args):
        seen["fn"] = fn
        seen["buf"] = fn.pack(*args, torch._C._cuda_getCurrentRawStream(index))
        return launch(fn, index, *args)

    build.launch = grab
    try:
        call()
    finally:
        build.launch = launch
    fn, buf = seen["fn"], seen["buf"]
    return lambda: fn.fn(buf)


def host_us(fn) -> float:
    """The host's time to issue one call: ``CALLS`` calls back to back,
    timed before the device is waited for (fewer calls than the launch
    queue holds, so a device slower than the host does not stall them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / CALLS * 1e6


def shapes(gen):
    """(name, wrapper call) at 3b's decode shapes, phase 3's q8 decode
    shapes and its prefill shapes at M 18 and 32, 3b's bf16 prefill shape
    of flash attention, the gated MLP at 3b's and 3e's prefill, fp32 flash
    attention at 3c's and 3f's prefill, the paged decode at 3e's and cell
    3's, the paged prefill at 3e's shape and cell 3's, fp32 fc1 at 3f's,
    and the SSD kernel at 3d's prefill."""
    cfg = cs.get_config("mistral-nemo-12b")
    b, t = 4, cs.ONESHOT_PROMPT + cs.ONESHOT_NEW
    kl = torch.full((b,), t - 1, dtype=torch.int32, device="cuda")
    out = []
    for kv_dt in (torch.bfloat16, torch.int8):
        k, v, ks, vs = cs.dense_cache(gen, b, cfg.n_kv_heads, t, cfg.hd,
                                      kv_dt, "bhtd")
        q = torch.randn((b, cfg.n_heads, cfg.hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out.append((f"decode {str(kv_dt)[6:]} cache",
                    lambda q=q, k=k, v=v, ks=ks, vs=vs: k_dense.decode_attention(
                        q, k, v, kl, k_scale=ks, v_scale=vs)))
    for m, k, n in ((4, 4096, 2560), (4, 4096, 10112), (4, 16384, 2560),
                    *((m, k, n) for m in (18, 32)
                      for k, n in ((4096, 2944), (4096, 11776),
                                   (16384, 2944)))):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(n, generator=gen, device="cuda") * 0.01
        out.append((f"q8 {m}x{k}x{n}",
                    lambda x=x, w=w, s=s: k_q8.q8_matmul(x, w, s)))
    s = cs.ONESHOT_PROMPT
    q = torch.randn((b, s, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(torch.bfloat16).transpose(1, 2)
    kv = torch.randn((b, s, cfg.n_kv_heads, cfg.hd), generator=gen,
                     device="cuda").to(torch.bfloat16).transpose(1, 2)
    out.append((f"flash bf16 S {s}",
                lambda q=q, kv=kv: k_flash.flash_attention(q, kv, kv,
                                                          causal=True)))
    opt = cs.get_config("opt-6.7b")
    s = cs.OFFLOAD_PROMPT
    t = s + cs.OFFLOAD_NEW
    q = torch.randn((b, s, opt.n_heads, opt.hd), generator=gen,
                    device="cuda").transpose(1, 2)
    kv = torch.randn((b, t, opt.n_kv_heads, opt.hd), generator=gen,
                     device="cuda").transpose(1, 2)[:, :, :s]
    out.append((f"flash f32 S {s}",
                lambda q=q, kv=kv: k_flash.flash_attention(q, kv, kv,
                                                          causal=True)))
    x = torch.randn((b * cs.ONESHOT_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    wg, wu = (torch.randn((cfg.d_model, cfg.d_ff), generator=gen,
                          device="cuda").mul(0.02).to(torch.bfloat16)
              for _ in range(2))
    for m in (len(x), cs.PAGED_PROMPTS[0], cs.PAGED_PROMPTS[-1]):
        out.append((f"gated bf16 {m}x{cfg.d_model}x{cfg.d_ff}",
                    lambda x=x[:m]: k_mm.gated_matmul(x, wg, wu,
                                                      activation="silu")))
    out += paged_decode_shapes(gen)
    out += prefill_shapes(gen)
    w = torch.randn((opt.d_model, opt.d_ff), generator=gen,
                    device="cuda") / opt.d_model ** 0.5
    bias = torch.randn(opt.d_ff, generator=gen, device="cuda")
    for m in (b * cs.OFFLOAD_PROMPT, b):
        x = torch.randn((m, opt.d_model), generator=gen, device="cuda")
        out.append((f"matmul f32 {m}x{opt.d_model}x{opt.d_ff}",
                    lambda x=x: k_mm.matmul(x, w, bias, activation="relu")))
    mamba = cs.get_config("mamba2-2.7b")
    x, dt, a, bm, cm, _ = cs.ssd_inputs(gen, 4, cs.MAMBA_PROMPT, mamba,
                                        torch.bfloat16)
    out.append(("ssd bf16 3d", lambda: k_ssd.ssd_chunk(
        x, dt, a, bm, cm, chunk=mamba.ssm_chunk)))
    return out + arch_matmul_shapes(gen)


def arch_matmul_shapes(gen):
    """bf16 ``matmul`` at 3l's shapes (Whisper-small's MLP, 768 -> 3072
    with bias and GELU over 6000, 16 and 4 rows; Nemotron-4-340B's, 18432
    -> 73728 with the squared ReLU over 2048 and 4 rows) and the gated MLP
    at the decode shapes of 3b (4 x 5120 -> 14336), 3l's LLaVA (2 x
    4096 -> 14336) and 3j's Gemma-2 (GELU), MiniCPM3, Scout and Zamba2,
    and at K 18432 (2048 and 130 rows -> 2048; no main path: the
    two-weight kernel's unfolded sums at Nemotron-4's width)."""
    out = []
    for k, n, act, bias, rows in ((768, 3072, "gelu", True, (6000, 16, 4)),
                                  (18432, 73728, "relu2", False, (2048, 4))):
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / k ** 0.5).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16) \
            if bias else None
        x = torch.randn((max(rows), k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for m in rows:
            out.append((f"matmul bf16 {m}x{k}x{n} {act}",
                        lambda x=x[:m], w=w, b=b, act=act:
                        k_mm.matmul(x, w, b, activation=act)))
    for m, k, n, act in ((4, 5120, 14336, "silu"), (2, 4096, 14336, "silu"),
                         (4, 2304, 9216, "gelu"), (4, 2560, 6400, "silu"),
                         (4, 5120, 8192, "silu"), (4, 4096, 8192, "silu")):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        wg, wu = ((torch.randn((k, n), generator=gen, device="cuda")
                   / k ** 0.5).to(torch.bfloat16) for _ in range(2))
        out.append((f"gated bf16 {m}x{k}x{n} decode",
                    lambda x=x, wg=wg, wu=wu, act=act: k_mm.gated_matmul(
                        x, wg, wu, activation=act)))
    k, n = 18432, 2048
    x = torch.randn((2048, k), generator=gen, device="cuda").to(torch.bfloat16)
    wg, wu = ((torch.randn((k, n), generator=gen, device="cuda")
               / k ** 0.5).to(torch.bfloat16) for _ in range(2))
    for m in (2048, 130):
        out.append((f"gated bf16 {m}x{k}x{n} long K",
                    lambda x=x[:m], wg=wg, wu=wu: k_mm.gated_matmul(
                        x, wg, wu, activation="silu")))
    return out


def paged_decode_shapes(gen):
    """``paged_decode_attention`` under a bf16 q at 3e's last decode step
    (B 4, Mistral's heads, kv_len 507-519, page 16) over bf16 and int8
    pages, and under an fp32 q with OPT-6.7B's heads (B 4, page 16) at cell
    3's two most frequent decode shapes (kv 56-69 and 57-70) and at the
    long-context shape of ``chip_smoke.py``'s row (kv 512-3001), over fp32
    and int8 pages."""
    mis, opt = cs.get_config("mistral-nemo-12b"), cs.get_config("opt-6.7b")
    rows = [("3e", mis, torch.bfloat16,
             [n + cs.PAGED_NEW - 1 for n in cs.PAGED_PROMPTS]),
            ("cell 3 kv 56-69", opt, torch.float32, [56, 62, 66, 69]),
            ("cell 3 kv 57-70", opt, torch.float32, [57, 63, 67, 70]),
            ("long context", opt, torch.float32, [512, 1100, 2048, 3001])]
    out = []
    for label, cfg, dtype, lens in rows:
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for q8 in (False, True):
            kp, vp, ks, vs, bt = cs.paged_inputs(
                gen, len(lens), cfg.n_heads, cfg.n_kv_heads, cfg.hd, lens,
                q8, dtype)
            q = torch.randn((len(lens), cfg.n_heads, cfg.hd), generator=gen,
                            device="cuda").to(dtype)
            pages = "int8" if q8 else str(dtype)[6:]
            out.append((f"paged decode {label} {pages} pages",
                        lambda q=q, kp=kp, vp=vp, bt=bt, ks=ks, vs=vs, kl=kl:
                        k_paged.paged_decode_attention(
                            q, kp, vp, bt, kl, k_scale=ks, v_scale=vs)))
    return out


def prefill_shapes(gen):
    """``paged_prefill_attention`` at 3e's prefill (B 1, S 512, Mistral's
    heads) over bf16 and int8 pages, and with OPT-6.7B's heads in fp32
    over fp32 and int8 pages at cell 3's two chunk shapes (a first chunk
    of 32 rows at offset 0, a second of 31 rows at offset 32) and at the
    long-context shape of ``chip_smoke.py``'s row (4 chunks of 64 rows at
    offsets 0, 64, 517, 1500)."""
    mis, opt = cs.get_config("mistral-nemo-12b"), cs.get_config("opt-6.7b")
    rows = [("3e", mis, torch.bfloat16, 1, 512, (0,)),
            ("cell 3 S 32", opt, torch.float32, 1, cs.CHUNK, (0,)),
            ("cell 3 S 31 at 32", opt, torch.float32, 1, cs.CHUNK - 1,
             (cs.CHUNK,)),
            ("long context", opt, torch.float32, 4, 64, (0, 64, 517, 1500))]
    out = []
    for label, cfg, dtype, b, s, offs in rows:
        for q8 in (False, True):
            kp, vp, ks, vs, bt = cs.paged_inputs(
                gen, b, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                [o + s for o in offs], q8, dtype)
            q = torch.randn((b, cfg.n_heads, s, cfg.hd), generator=gen,
                            device="cuda").to(dtype)
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            pages = "int8" if q8 else str(dtype)[6:]
            out.append((f"prefill {label} {pages} pages",
                        lambda q=q, kp=kp, vp=vp, bt=bt, off=off, ks=ks,
                        vs=vs: k_prefill.paged_prefill_attention(
                            q, kp, vp, bt, off, k_scale=ks, v_scale=vs)))
    return out


def time_kernels(builds, rounds, words=None):
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for name, call in shapes(gen):
        if words and not any(w in name for w in words):
            continue
        got = {b: {"wrapper_us": [], "entry_us": [], "device_ms": []}
               for b in builds}
        refused = set()
        for r in range(rounds):
            order = list(builds) if r % 2 == 0 else list(builds)[::-1]
            for b in order:
                if b in refused:
                    continue
                use(builds[b])
                try:
                    entry = packed_call(call)
                except RuntimeError as e:
                    cs.log(f"{name:28s} {b:10s} refused: {e}")
                    refused.add(b)
                    continue
                got[b]["wrapper_us"].append(host_us(call))
                got[b]["entry_us"].append(host_us(entry))
                got[b]["device_ms"].append(cs.device_ms(call)[0])
        for b, d in got.items():
            if b in refused:
                continue
            row = {"shape": name, "build": b,
                   **{key: float(np.median(vals)) for key, vals in d.items()},
                   "all": d}
            rows.append(row)
            cs.log(f"{name:28s} {b:10s} wrapper {row['wrapper_us']:.2f} us, "
                   f"C entry {row['entry_us']:.2f} us, device "
                   f"{row['device_ms']:.4f} ms")
    return rows


def _alternate(builds, other, pairs, label, run):
    """``pairs`` pairs of ``run()`` (a dict of readings), ``other`` and
    the tree's build in alternating order, after one warm-up run of each."""
    for b in (other, "tree"):
        use(builds[b])
        run()
    out = []
    for i in range(pairs):
        for b in ((other, "tree") if i % 2 == 0 else ("tree", other)):
            use(builds[b])
            got = {"run": label, "pair": i, "build": b, **run()}
            out.append(got)
            cs.log(f"{label} pair {i} {b:10s} " + ", ".join(
                f"{k} {v:.4f}" for k, v in got.items()
                if isinstance(v, float)))
    return out


def mistral_pairs(builds, other, pairs, runs):
    """3b's one-shot generate (decode tok/s) over a bf16 and an int8
    cache, and 3e's paged batcher (tok/s of the run) over bf16 and int8
    pages, with Mistral-NeMo-12B's weights made once."""
    cfg = cs.get_config("mistral-nemo-12b")
    params = cs.M.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(cs.SEED), device="cuda")
    rng = np.random.default_rng(cs.SEED)
    prompts = [list(rng.integers(0, cfg.vocab_size, cs.ONESHOT_PROMPT))
               for _ in range(4)]
    paged = [list(rng.integers(0, cfg.vocab_size, n))
             for n in cs.PAGED_PROMPTS]
    out = []
    for kv_dtype in (None, "int8"):
        run_cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        kv = kv_dtype or "bf16"

        def oneshot():
            with cs.LLM(run_cfg, params) as llm:
                ops.reset_launch_counts()
                llm.generate(prompts, max_new=cs.ONESHOT_NEW)
                m = llm.last_metrics
                return {"prefill_s": m["prefill_s"],
                        "decode_tok_s": m["tokens_per_s"],
                        "decode_s": m["decode_s"],
                        "decode_attention_launches":
                            ops.launch_counts()["decode_attention"]}

        def batcher():
            with cs.LLM(cfg, params, paged=True, kv_dtype=kv_dtype,
                        max_slots=4, page_size=cs.PAGE_SIZE,
                        max_len=max(cs.PAGED_PROMPTS) + cs.PAGED_NEW) as llm:
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                outs = llm.generate(paged, max_new=cs.PAGED_NEW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                return {"tok_s": sum(len(o.tokens) for o in outs) / wall,
                        "wall_s": wall,
                        "paged_prefill_launches":
                            ops.launch_counts()["paged_prefill_attention"],
                        "paged_decode_launches":
                            ops.launch_counts()["paged_decode_attention"]}

        if "3b" in runs:
            out += _alternate(builds, other, pairs, f"3b {kv} cache", oneshot)
        if "3e" in runs:
            out += _alternate(builds, other, pairs, f"3e {kv} pages", batcher)
    del params
    torch.cuda.empty_cache()
    return out


def opt_pairs(builds, other, pairs):
    """3f: OPT-6.7B resident one-shot in fp32 (fc1 on ``matmul``),
    prefill s and decode tok/s."""
    cfg = cs.get_config("opt-6.7b")
    params = cs.M.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(cs.SEED), device="cuda")
    prompts = cs.offload_prompts(cfg.vocab_size, cs.SEED)

    def oneshot():
        with cs.LLM(cfg, params) as llm:
            ops.reset_launch_counts()
            llm.generate(prompts, max_new=cs.OFFLOAD_NEW)
            m = llm.last_metrics
            return {"prefill_s": m["prefill_s"],
                    "decode_tok_s": m["tokens_per_s"],
                    "matmul_launches": ops.launch_counts()["matmul"]}

    out = _alternate(builds, other, pairs, "3f fp32", oneshot)
    del params
    torch.cuda.empty_cache()
    return out


def mamba_pairs(builds, other, pairs):
    """3d: Mamba2-2.7B resident one-shot in bf16 (one ``ssd_chunk`` a
    layer in the prefill), prefill s and decode tok/s."""
    cfg = cs.get_config("mamba2-2.7b")
    params = cs.M.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(cs.SEED), device="cuda")
    rng = np.random.default_rng(cs.SEED + 3)
    prompts = [list(rng.integers(0, cfg.vocab_size, cs.MAMBA_PROMPT))
               for _ in range(4)]

    def oneshot():
        with cs.LLM(cfg, params) as llm:
            ops.reset_launch_counts()
            llm.generate(prompts, max_new=cs.MAMBA_NEW)
            m = llm.last_metrics
            return {"prefill_s": m["prefill_s"],
                    "decode_tok_s": m["tokens_per_s"],
                    "ssd_chunk_launches": ops.launch_counts()["ssd_chunk"]}

    out = _alternate(builds, other, pairs, "3d bf16", oneshot)
    del params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="name=DIR of another checkout (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=LIB:FILE, one source built in place of a "
                         "library (repeatable)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--runs", default="3e,3f",
                    help="cells to alternate, of 3b, 3d, 3e, 3f")
    ap.add_argument("--shapes", default="",
                    help="comma-separated words; time only the kernel "
                         "shapes whose name holds one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    build.build(LIBRARIES)
    others = dict(o.split("=", 1) for o in args.other)
    builds = {"tree": {key: build.c_function(*key, argtypes)
                       for key, argtypes in ENTRIES.items()},
              **build_others(others)}
    variants = {}
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants[name] = tuple(spec.split(":", 1))
    builds.update(build_variants(variants, builds["tree"]))
    words = [w for w in args.shapes.split(",") if w]
    result = {"kernels": time_kernels(builds, args.rounds, words)}
    first = next(iter(others), None)
    runs = set(args.runs.split(",")) if args.runs else set()
    if first in builds and args.pairs:
        result["pairs"] = []
        if runs & {"3b", "3e"}:
            result["pairs"] += mistral_pairs(builds, first, args.pairs, runs)
        if "3f" in runs:
            result["pairs"] += opt_pairs(builds, first, args.pairs)
        if "3d" in runs:
            result["pairs"] += mamba_pairs(builds, first, args.pairs)
    use(builds["tree"])
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
