"""How far the bf16 matmul kernels' fp32 sums lie from the exact product,
beside cuBLAS's (``torch.matmul``), on one card.

    python tools/matmul_sum_units.py [--shapes 2048x18432x73728,4x18432x73728]
                                     [--gated 130x18432x2048,2048x18432x2048]

For each (M, K, N): x ~ N(0, 1) and w ~ N(0, 1/K) in bf16, the exact
product z in fp64, and the outputs whose |z| is under 2e-4, where a bf16
output still resolves an fp32 sum (its rounding is at most 0.05 of the
unit below).  Prints the largest and the 99th / 99.9th percentile distance
|y - z| of the kernel's ``matmul`` (no activation) and of ``torch.matmul``
over those outputs, in units of ``u sqrt(K) (sqrt(sum_k t_k^2) + |z|)``,
the unit of ``kernels.ref._product_bound`` (whose limit allows
``ref._MM_UNITS`` of them), and the signed mean, which shows a bias.
For each ``--gated`` shape it prints the worst distance of the kernel's
``gated_matmul`` (SiLU) from the plain version as a ratio to
``ref.gated_matmul_limit``.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import hete_matmul as k_mm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DEFAULT = "2048x18432x73728,4x18432x73728,2048x4096x14336,6000x768x3072"


def units(y, z, unit, small):
    d = ((y.double() - z) / unit)[small]
    a = d.abs().float()
    q = torch.quantile(a[:1_000_000],
                       torch.tensor([0.99, 0.999], device=a.device))
    return float(a.max()), q.tolist(), float(d.mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=DEFAULT)
    ap.add_argument("--gated", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build(["hete_matmul"])
    gen = torch.Generator(device="cuda").manual_seed(2468)
    for spec in args.shapes.split(","):
        m, k, n = (int(v) for v in spec.split("x"))
        x = torch.randn((m, k), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / k ** 0.5).to(torch.bfloat16)
        xd, wd = x.double(), w.double()
        z = xd @ wd
        unit = 2.0 ** -24 * math.sqrt(k) * (((xd * xd) @ (wd * wd)).sqrt()
                                           + z.abs())
        small = z.abs() < 2e-4
        for name, y in (("kernel", k_mm.matmul(x, w)),
                        ("torch.matmul", torch.matmul(x, w))):
            top, (q99, q999), mean = units(y, z, unit, small)
            print(f"{m}x{k}x{n} {name}: over {int(small.sum())} outputs "
                  f"with |z| < 2e-4, |y - z| up to {top:.3f} units (99% "
                  f"{q99:.3f}, 99.9% {q999:.3f}), signed mean {mean:.3f}",
                  flush=True)
        del x, w, xd, wd, z, unit, small
        torch.cuda.empty_cache()
    for spec in filter(None, args.gated.split(",")):
        m, k, n = (int(v) for v in spec.split("x"))
        x = torch.randn((m, k), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        wg, wu = ((torch.randn((k, n), generator=gen, device="cuda")
                   / k ** 0.5).to(torch.bfloat16) for _ in range(2))
        got = k_mm.gated_matmul(x, wg, wu, activation="silu")
        want = ref.gated_matmul(x, wg, wu, activation="silu")
        limit = ref.gated_matmul_limit(x, wg, wu, want, activation="silu")
        ratio = float(((got.float() - want.float()).abs() / limit).max())
        print(f"gated {m}x{k}x{n} silu: worst error {ratio:.3f} x "
              f"ref.gated_matmul_limit", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
