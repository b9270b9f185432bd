"""Time design variants of the fp32 matmul kernels (``tools/matmul_variants.cu``)
against each other, the port's ``matmul`` kernel and cuBLAS, on one card in
one process, at OPT-6.7B's fc1: relu(x @ w + b) with K 4096, N 16384, at
3f's prefill rows (256; the M > 8 variants) and decode rows (4; the M <= 8
variants).

    python tools/matmul_variants.py [--rounds 5] [--out FILE]

Each variant is first held to ``ref.matmul_limit``; then, in ``--rounds``
rounds that visit the variants in turn, each is timed as 20 calls in a CUDA
graph (``chip_smoke.device_ms``).  Prints the card's name and power limit,
the name of the kernel cuBLAS runs for the library call (from
``torch.profiler``), a line per variant (median device ms and the rounds'
spread) and a JSON line of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import hete_matmul as k_mm  # noqa: E402

# the order of kFns in matmul_variants.cu: (rows, name)
VARIANTS = [
    (256, "x along K, 8x8, BK 32, ring 3"),
    (256, "x along K, 8x8, BK 16, ring 4"),
    (256, "x along K, 8x16 of 128 threads, BK 16, ring 3"),
    (256, "x by registers transposed, BK 8, weights ring 4"),
    (256, "x by registers transposed, BK 16, weights ring 4"),
    (256, "x by registers transposed, BK 32, weights ring 3"),
    (256, "x by registers transposed, BK 32, warps 32x64"),
    (256, "x by registers transposed, BK 32, warps 64x32"),
    (256, "x by cp.async transposed in smem, BK 16, ring 4"),
    (256, "x by cp.async transposed in smem, BK 16, ring 3"),
    (256, "x by cp.async transposed in smem, BK 32, ring 2"),
    (256, "x by cp.async, BK 16, ring 4, fragments double-buffered"),
    (256, "x by cp.async, BK 16, ring 3, general form"),
    (256, "x by cp.async, 256x128 a block, 16x8 a thread"),
    (256, "x by cp.async, 128 threads, 8x16 a thread"),
    (256, "x by cp.async, 256x128 a block, 8x16 a thread"),
    (256, "x by cp.async, 128x256 a block, 8x16 a thread"),
    (256, "x by cp.async, 256x64 a block, 8x8 a thread"),
    (256, "x by cp.async, 128x256 a block, 8x16 a thread, ring 4"),
    (256, "x by cp.async, 128x256 a block, 8x16 a thread, BK 32, ring 3"),
    (256, "x by cp.async, 128x256 a block, 8x16 a thread, BK 32, ring 2"),
    (256, "x by cp.async, 128x256 a block, 8x16 a thread, BK 8, ring 4"),
    (256, "x by cp.async, 128x256, 8x16, warps of 64x64"),
    (256, "x by cp.async, 128x256, 8x16, warps of 64x64, BK 8, ring 4"),
    (4, "loads, 64 columns a block"),
    (4, "loads, 128 columns a block"),
    (4, "loads, 32 columns a block"),
    (4, "loads, 16 columns a block"),
    (4, "loads, 8 columns a block"),
    (4, "loads, 16 columns a block, 8 rows a batch"),
    (4, "cp.async ring, 64 columns a block"),
    (4, "cp.async ring, 32 columns a block"),
    (4, "cp.async ring, 16 columns a block"),
]


def library():
    """The variants' shared library, built with the port's nvcc flags."""
    out = build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libmatmul_variants.so"
    src = os.path.join(ROOT, "tools", "matmul_variants.cu")
    p = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), src],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"nvcc failed:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    assert lib.n_variants() == len(VARIANTS)
    return lib


def kernel_names(call) -> list:
    """The device kernels one ``call()`` launches, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if not e.key.startswith(("cuda", "cu", "Activity"))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    lib = library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = cs.get_config("opt-6.7b")
    k, n = opt.d_model, opt.d_ff
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    b = torch.randn(n, generator=gen, device="cuda")
    rows = []
    for m in sorted({m for m, _ in VARIANTS}, reverse=True):
        x = torch.randn((m, k), generator=gen, device="cuda")
        y = torch.empty((m, n), device="cuda")
        want = ref.matmul(x, w, b, activation="relu")
        limit = ref.matmul_limit(x, w, want, b, activation="relu")
        calls = {}
        for i, (vm, name) in enumerate(VARIANTS):
            if vm != m:
                continue

            def call(i=i):
                err = lib.variant(i, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                  y.data_ptr(), m, n, k,
                                  torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {i} launch failed ({err})")
            call()
            _, ratio = cs.excess(y, want, limit)
            cs.check(ratio <= 1.0, f"{name}: {ratio:.3f} x its limit")
            calls[name] = call
        calls["the port's kernel"] = lambda: k_mm.matmul(x, w, b,
                                                         activation="relu")
        calls["torch._addmm_activation"] = lambda: torch._addmm_activation(
            b, x, w)
        cs.log(f"m {m:3d} torch._addmm_activation runs "
               f"{kernel_names(calls['torch._addmm_activation'])}")
        times = {name: [] for name in calls}
        for _ in range(args.rounds):
            for name, call in calls.items():
                times[name].append(cs.device_ms(call)[0])
        for name, t in times.items():
            row = {"m": m, "k": k, "n": n, "variant": name,
                   "device_ms": float(np.median(t)), "min": min(t),
                   "max": max(t)}
            rows.append(row)
            cs.log(f"m {m:3d} {name:58s} {row['device_ms']:.4f} ms "
                   f"({row['min']:.4f}-{row['max']:.4f})")
    line = json.dumps({"variants": rows})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
