"""Design variants of the bf16 wgmma kernel of ``csrc/hete_matmul.cu``
(``gated_matmul`` and ``matmul`` above 48 rows), written as whole copies of
the source with one change each, for ``tools/ab_kernels.py --variant``:

    python tools/gated_variants.py [--out DIR]

prints one ``--variant NAME=hete_matmul:FILE`` argument per variant:

* ``stages3``, ``stages2``: three or two 48 KB stages in the ring (four in
  the kernel);
* ``one_consumer``: one consumer warpgroup of 64 rows (tiles of 64 x 128,
  256 threads, no register moves) instead of two of 64;
* ``bn64``: 64-column tiles (m64n64k16 wgmma, one weight box a stage, six
  32 KB stages) instead of 128;
* ``n_fastest``: tiles walked with N fastest instead of M.

Each change is a text substitution checked to apply exactly where
expected, so a variant follows the tree's kernel in everything else.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "hete_matmul.cu")


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    found = src.count(old)
    if found != count:
        raise SystemExit(f"expected {count} of {old!r}, found {found}")
    return src.replace(old, new)


def _wgmma_n64() -> str:
    """An m64n64k16 twin of ``wgmma_m64n128k16_bf16_bt``."""
    regs = ", ".join(f"%{i}" for i in range(32))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(32))
    return (
        "__device__ __forceinline__ void wgmma_m64n64k16_bf16_bt("
        "float (&d)[32], uint64_t a, uint64_t b) {\n"
        '  asm volatile("{\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "\n'
        f'      "{{{regs}}}, %32, %33, 1, 1, 1, 0, 1;\\n"\n'
        '      "}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(a), "l"(b));\n'
        "}\n")


def variants(src: str) -> dict:
    out = {}
    out["stages3"] = _sub(src, "STAGES = GATED ? 4 : 6;", "STAGES = GATED ? 3 : 6;")
    out["stages2"] = _sub(src, "STAGES = GATED ? 4 : 6;", "STAGES = GATED ? 2 : 6;")

    v = _sub(src, "constexpr int kWgBM = 128;", "constexpr int kWgBM = 64;")
    v = _sub(v, "constexpr int kWgThreads = 384;", "constexpr int kWgThreads = 256;")
    v = _sub(v, "  if (wg == 2) {", "  if (wg == 1) {")
    v = _sub(v, "if (threadIdx.x == 256) {", "if (threadIdx.x == 128) {")
    v = _sub(v, "mbar_init(&empty[s], 8);", "mbar_init(&empty[s], 4);")
    v = _sub(v, "setmaxnreg_dec<40>();", "")
    v = _sub(v, "setmaxnreg_inc<232>();", "")
    out["one_consumer"] = v

    v = _sub(src, "constexpr int kWgBN = 128;", "constexpr int kWgBN = 64;")
    v = _sub(v, "static constexpr int B_BYTES = 2 * kWgBox;",
             "static constexpr int B_BYTES = kWgBox;")
    v = _sub(v, "STAGES = GATED ? 4 : 6;", "STAGES = 6;")
    v = _sub(v, "const int boxes = n0 + 64 < n ? 2 : 1;", "const int boxes = 1;")
    v = _sub(v, "float acc[NW][64];", "float acc[NW][32];")
    v = _sub(v, "for (int i = 0; i < 64; ++i)", "for (int i = 0; i < 32; ++i)", 2)
    v = _sub(v, "      for (int j = 0; j < 16; ++j) {\n        const int col = c0 + 8 * j;",
             "      for (int j = 0; j < 8; ++j) {\n        const int col = c0 + 8 * j;")
    v = _sub(v, "            wgmma_m64n128k16_bf16_bt(",
             "            wgmma_m64n64k16_bf16_bt(")
    v = _sub(v, '#include "launch_args.h"\n',
             '#include "launch_args.h"\n\n' + _wgmma_n64())
    out["bn64"] = v

    v = _sub(src, "  const int tiles = mt * ((n + kWgBN - 1) / kWgBN);\n",
             "  const int nt = (n + kWgBN - 1) / kWgBN;\n"
             "  const int tiles = mt * nt;\n")
    out["n_fastest"] = _sub(
        v, "const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * kWgBN;",
        "const int m0 = (t / nt) * kWgBM, n0 = (t % nt) * kWgBN;", 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "src", "repro_torch", "_build", "variants"))
    args = ap.parse_args(argv)
    with open(SOURCE) as f:
        src = f.read()
    os.makedirs(args.out, exist_ok=True)
    flags = []
    for name, text in variants(src).items():
        path = os.path.join(args.out, f"hete_matmul_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        flags.append(f"--variant {name}=hete_matmul:{path}")
    print(" ".join(flags))
    return 0


if __name__ == "__main__":
    sys.exit(main())
