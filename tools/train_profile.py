"""Where a training step's time goes on the card: Gemma-2-2B whole, as
``chip_smoke.py`` phase 3k(b) trains it (bf16, remat, B 1 x S 4096 a
microbatch, 2 microbatches, AdamW with fp32 moments), one step profiled
with ``torch.profiler`` after two warm-up steps.

    python3 tools/train_profile.py [--seq 4096] [--top 25]

Prints the card's name and power limit, the step's wall seconds (the
second warm-up step's unprofiled, and the profiled one's), the device
time summed over its kernels (their busy share of the wall; the
step runs on one stream, so the kernels do not overlap), that time by
kernel class (bf16 and fp32 GEMMs, softmax, other elementwise and
reduction kernels, copies) and the ``--top`` kernels by device time.
Imports the port only; needs one card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_training_data  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

# cuBLAS names its Hopper tensor-core kernels nvjet_*; with TF32 off only
# the bf16 products take the tensor cores
CLASSES = (("gemm bf16", r"nvjet|(gemm|gemv|xmma|cutlass).*bf16"
                         r"|bf16.*(gemm|xmma)"),
           ("gemm fp32", r"gemm|gemv|xmma|cutlass"),
           ("softmax", r"softmax"),
           ("copy / cast", r"copy|Memcpy|Memset|cast|fill"),
           ("reduction", r"reduce|sum|norm|logsumexp"),
           ("elementwise", r"elementwise|vectorized|unrolled|index|scatter"
                           r"|gather|where|tanh|exp|pow|mul|add|div"))


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if re.search(pat, name, re.IGNORECASE):
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config("gemma2-2b")
    tcfg = TL.TrainConfig(accum_steps=2, optimizer=OptimizerConfig(lr=1e-3),
                          warmup=1, total_steps=100)
    step, opt_init = TL.make_train_step(cfg, tcfg)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    data = make_training_data(cfg, batch=2, seq=args.seq, seed=0)
    for _ in range(2):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    batch = next(data)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    data.close()
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e6, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    print(f"gemma2-2b train step at S {args.seq} x 2: wall {plain_wall:.4f}"
          f" s unprofiled, {wall:.4f} s profiled; device kernels "
          f"{busy:.4f} s ({busy / wall:.4f} of the profiled wall, "
          f"{busy / plain_wall:.4f} of the unprofiled), "
          f"{sum(r[1] for r in rows)} kernel launches")
    by_class = {}
    for s, n, name in rows:
        c = by_class.setdefault(kernel_class(name), [0.0, 0])
        c[0] += s
        c[1] += n
    for cls, (s, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"class {cls}: {s:.4f} s ({s / busy:.4f} of kernel time), "
              f"{n} launches")
    for s, n, name in sorted(rows, reverse=True)[:args.top]:
        print(f"kernel {s:.4f} s x{n} {name[:140]}")
    if busy == 0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
