"""Design variants of the bf16 kernels of ``csrc/hete_matmul.cu`` (the
folded wgmma kernel above 48 rows, the split-K weight stream at or below),
written as whole copies of the source with one change each, for
``tools/ab_kernels.py --variant``:

    python tools/bf16_matmul_variants.py [--out DIR]

prints one ``--variant NAME=hete_matmul:FILE`` argument per variant:

* ``no_cluster``, ``cluster4``: ``matmul`` above 48 rows without a
  cluster (each block loads its own weight tiles), or in clusters of four
  along M, in place of two;
* ``tile128``: 128 x 128 tiles (m64n128k16, two weight boxes a stage) in
  place of 128 x 192;
* ``unfolded``: no fold of the accumulator before a tile's end (for
  timing only: at K 18432 the sums fail ``ref.matmul_limit``);
* ``parts1``, ``parts4``: a tile's epilogue in one part, or four, between
  the next tile's first stages, in place of two;
* ``runtime_act``: the activation chosen by a switch at every element of
  the epilogue, in place of a template argument;
* ``newton``: GELU's and SiLU's reciprocal by the exponent trick and three
  Newton steps on the FMA pipes, in place of the MUFU op;
* ``no_l2_hint``: the split-K stream's weight loads without the L2's
  256-byte fetch.

Each change is a text substitution checked to apply exactly where
expected, so a variant follows the tree's kernels in everything else.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "hete_matmul.cu")

_FOLD = ": launch_fold<3, 2>("
_EPI = "constexpr int kEpiParts = 2;"
_NEWTON = '''__device__ __forceinline__ float rcp_newton(float d) {
  if (!(d <= 8.5e37f)) return __frcp_rn(d);
  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fmaf(r, fmaf(-d, r, 1.f), r);
  return r;
}

'''
_RUNTIME_ACT = '''__device__ __forceinline__ float act_runtime(int act, float y) {
  switch (act) {
    case kRelu:
      return act_bf16<kRelu>(y);
    case kRelu2:
      return act_bf16<kRelu2>(y);
    case kGelu:
      return act_bf16<kGelu>(y);
    case kSilu:
      return act_bf16<kSilu>(y);
    default:
      return y;
  }
}

'''


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    found = src.count(old)
    if found != count:
        raise SystemExit(f"expected {count} of {old!r}, found {found}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    out = {}
    out["no_cluster"] = _sub(src, _FOLD, _FOLD.replace("3, 2>", "3, 1>"))
    out["cluster4"] = _sub(src, _FOLD, _FOLD.replace("3, 2>", "3, 4>"))
    out["tile128"] = _sub(src, _FOLD, _FOLD.replace("<3, 2>", "<2, 2>"))
    out["unfolded"] = _sub(
        src, "        if ((kt + 1) % (kPromoteK / kWgBK) == 0 && kt + 1 < ktiles) "
        "fold();", "")
    out["parts1"] = _sub(src, _EPI, _EPI.replace("2;", "1;"))
    out["parts4"] = _sub(src, _EPI, _EPI.replace("2;", "4;"))

    v = _sub(src, "// f(std::integral_constant<int, A>) for the activation code",
             _RUNTIME_ACT + "// f(std::integral_constant<int, A>) for the "
             "activation code")
    v = _sub(v, "      with_act(act, [&](auto a) {\n"
             "        constexpr int A = decltype(a)::value;",
             "      with_act(kNone, [&](auto) {\n        const int A = act;")
    out["runtime_act"] = _sub(v, "act_bf16<A>(", "act_runtime(A, ", 2)

    v = _sub(src, "// The activation where the output is bf16",
             _NEWTON + "// The activation where the output is bf16")
    out["newton"] = _sub(v, "y * rcp_ftz(", "y * rcp_newton(", 2)

    out["no_l2_hint"] = _sub(src, "      cp_async16_l2(bs + r * C::BS + nc,",
                             "      cp_async16(bs + r * C::BS + nc,")
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
