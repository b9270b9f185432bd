"""Time the offload engine's host GEMM at the serving phases' shapes.

``HeteGenEngine._host_matmul`` multiplies the activations as the model
hands them over, ``x`` of shape (B, S, K), by the host share of a weight,
a column view ``w[:, cols:]`` of the (K, N) fp32 weight.  numpy runs a
3-D ``x @ w`` as B separate products, each reading the whole share;
this script times that call beside the same product on ``x`` reshaped to
(B * S, K) (one product, one read of the share) and beside a contiguous
copy of the share, at OPT-6.7B's widths: decode (B 4, S 1), verify (B 4,
S 2 to 5) and a prefill chunk (B 1, S 32), for the attention and MLP
weights, with the host columns of the plan's alpha.  It prints one line
per shape (median of ``--reps`` calls after a warm-up, GB/s of the
share's bytes read once) and the BLAS numpy was built with, and its
thread count where ``threadpoolctl`` is installed.

    python tools/host_gemm_shapes.py [--alpha 0.648] [--reps 5]

No card is needed; run it on the host that serves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.alpha import split_columns  # noqa: E402

SHAPES = [(4, 1), (4, 2), (4, 3), (4, 5), (1, 32)]     # (B, S)
WEIGHTS = {"attn 4096x4096": (4096, 4096), "fc1 4096x16384": (4096, 16384),
           "fc2 16384x4096": (16384, 4096)}


def median_s(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def blas_info() -> dict:
    info = {"numpy": np.__version__, "cpus": len(os.sched_getaffinity(0))}
    try:
        blas = np.__config__.CONFIG["Build Dependencies"]["blas"]
        info["blas"] = f"{blas.get('name')} {blas.get('version')}"
    except (AttributeError, KeyError, TypeError):
        info["blas"] = "unknown"
    try:
        from threadpoolctl import threadpool_info
        info["threads"] = [(p.get("internal_api"), p.get("num_threads"))
                           for p in threadpool_info()]
    except ImportError:
        info["threads"] = "threadpoolctl not installed"
    return info


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alpha", type=float, default=0.648)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(json.dumps(blas_info()), flush=True)
    rng = np.random.default_rng(0)
    for wname, (k, n) in WEIGHTS.items():
        w = rng.standard_normal((k, n), dtype=np.float32)
        view = w[:, split_columns(args.alpha, n):]
        flat = np.ascontiguousarray(view)
        gb = view.nbytes / 1e9
        for b, s in SHAPES:
            x = rng.standard_normal((b, s, k), dtype=np.float32)
            x2 = x.reshape(b * s, k)
            t3 = median_s(lambda: x @ view, args.reps)
            t2 = median_s(lambda: x2 @ view, args.reps)
            tc = median_s(lambda: x2 @ flat, args.reps)
            np.testing.assert_allclose((x @ view).reshape(b * s, -1),
                                       x2 @ view, rtol=1e-4, atol=1e-3)
            print(f"{wname} host share {view.shape} ({gb:.4f} GB), B {b} "
                  f"S {s}: 3-D x @ view {t3 * 1e3:.3f} ms ({gb / t3:.3f} "
                  f"GB/s), 2-D x @ view {t2 * 1e3:.3f} ms "
                  f"({gb / t2:.3f} GB/s), 2-D x @ contiguous "
                  f"{tc * 1e3:.3f} ms ({gb / tc:.3f} GB/s)", flush=True)


if __name__ == "__main__":
    main()
