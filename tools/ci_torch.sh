#!/usr/bin/env bash
# One-step verify of the PyTorch/CUDA port on the CPU:
#
#     bash tools/ci_torch.sh
#
# Runs the port's tests (tests/test_torch_*.py: parity against the JAX
# package on seeded inputs; the `gpu`-marked tests skip without a card),
# then two smokes through the port's launchers with --device cpu: a `tiny`
# offloaded serve (continuous batching over the paged cache) and a `tiny`
# training run whose loss must fall.  On a card, chip_smoke.py is the
# end-to-end check instead.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS=cpu

echo "== port: pytest tests/test_torch_*.py =="
python -m pytest -q -p no:cacheprovider tests/test_torch_*.py

echo "== port smoke: tiny offloaded serve (batch-offload, paged) =="
python -m repro_torch.launch.serve --arch tiny --device cpu \
    --mode batch-offload --paged --requests 3 --max-new 4

echo "== port smoke: tiny train through launch/train.py =="
out=$(python -m repro_torch.launch.train --arch tiny --steps 30 \
    --device cpu --accum 2)
echo "$out"
python - "$out" <<'EOF'
import re
import sys

m = re.search(r"done: loss ([\d.]+) -> ([\d.]+)", sys.argv[1])
assert m, "no 'done' line"
first, last = float(m.group(1)), float(m.group(2))
assert last < first, f"loss did not fall: {first} -> {last}"
print(f"train smoke OK: loss {first} -> {last}")
EOF
