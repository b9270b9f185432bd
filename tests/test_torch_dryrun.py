"""``repro_torch.launch.dryrun``: the cell matrix, cells traced on a fake
world, and the per-device FLOPs of a small cell against the JAX package's
HLO analyzer.

* ``--list`` prints the JAX package's cell matrix, line for line;
* ``tiny`` x ``decode_32k`` on rank 0 of the (16, 16) fake world, traced
  on the meta device and executed on the CPU: status ok, the argument
  bytes equal the analytic params plus cache exactly, every kernel site
  reached (route ``meta`` / ``cpu``);
* the counterpart of the JAX package's ``test_tiny_mesh_dryrun_subprocess``:
  reduced Mistral-NeMo's ``decode_32k`` at batch 4 on a (2, 2) mesh,
  traced on meta in a fake world of 4 ranks; its per-device FLOPs against
  ``repro.analysis.hlo_cost.HloCostAnalyzer`` over the same cell compiled
  in a subprocess with 4 host devices, within 1% (equal in the run this
  test was written with: 17006592 both, ratio 1.0).
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from repro_torch.launch import dryrun as DR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_REL_TOL = 1e-2


def _env():
    return {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
            "HOME": os.environ.get("HOME", "/root"), "JAX_PLATFORMS": "cpu"}


def test_list_matches_reference_matrix():
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=_env())
    assert ref.returncode == 0, ref.stderr[-1000:]
    buf = io.StringIO()
    with redirect_stdout(buf):
        DR.main(["--list"])
    assert buf.getvalue().split("\n") == ref.stdout.split("\n")
    assert len(buf.getvalue().strip().split("\n")) == 10 * 4 * 2


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_tiny_cell(device):
    rec = DR.run_cell("tiny", "decode_32k", "single", device=device,
                      verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["analytic"]["params"] \
        + mem["analytic"]["cache"]
    assert mem["fits_80GB"]
    assert {k.split(":")[1] for k in rec["kernel_calls"]} == {device}
    assert {k.split(":")[0] for k in rec["kernel_calls"]} >= {
        "decode_attention", "rmsnorm"}
    assert rec["hlo"]["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


_REF = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models import model as M
import repro.configs.shapes as SH
from repro.distributed import specs as SP
from repro.distributed.shardings import ShardingRules
from repro.serving.engine import make_serve_step
from repro.analysis.hlo_cost import HloCostAnalyzer
cfg = reduced(get_config("mistral-nemo-12b"))
mesh = make_mesh((2, 2), ("data", "model"))
rules = ShardingRules.for_mesh(mesh)
pshape = jax.eval_shape(lambda k: M.init_params(cfg, k),
                        jax.random.PRNGKey(0))
ins = SH.input_specs(cfg, "decode_32k", batch_override=4)
cspec = SP.named(mesh, SP.cache_specs(cfg, rules, ins["cache"]))
tspec = SP.named(mesh, SP.batch_specs(cfg, rules, ins["token"]))
pspec = SP.named(mesh, SP.param_specs(cfg, rules, pshape, serve=True))
c = jax.jit(make_serve_step(cfg, rules), in_shardings=(pspec, tspec, cspec),
            out_shardings=(cspec, tspec)).lower(
    pshape, ins["token"], ins["cache"]).compile()
rep = HloCostAnalyzer(c.as_text(), max_bytes_per_elem=2).entry_cost()
print("FLOPS", rep.flops)
'''


def test_tiny_mesh_flops_equal_reference_analyzer():
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    r = subprocess.run([sys.executable, "-c", _REF], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=_env())
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("FLOPS")]
    assert line, r.stdout[-500:] + r.stderr[-2000:]
    want = float(line[0].split()[1])
    cfg = reduced(get_config("mistral-nemo-12b"))
    init_fake_world(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        got = DR.trace_cell(cfg, "decode_32k", mesh, batch_override=4)
    finally:
        dist.destroy_process_group()
    assert got["hlo"]["flops_per_device"] == pytest.approx(
        want, rel=FLOPS_REL_TOL)
    assert got["kernel_calls"] == {"decode_attention:meta": 2,
                                   "gated_matmul:meta": 2,
                                   "rmsnorm:meta": 5}
