"""The port never imports JAX or the JAX package: in a subprocess whose
``sys.meta_path`` refuses ``jax`` and ``repro`` (and their submodules),
every ``repro_torch`` module imports and ``chip_smoke.py`` parses and
imports only what it may."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(" ".join(names))
"""

# modules the scan must reach (walk_packages finds them by itself; the
# list guards against a package that stops being walked)
MUST_SCAN = ("repro_torch.serving.speculative",
             "repro_torch.serving.tokenizer",
             "repro_torch.launch.serve",
             "repro_torch.configs.gemma2_2b",
             "repro_torch.configs.minicpm3_4b",
             "repro_torch.configs.llama4_scout_17b_16e",
             "repro_torch.configs.llama4_maverick_400b_a17b",
             "repro_torch.configs.zamba2_1_2b",
             "repro_torch.train.loop",
             "repro_torch.train.optimizer",
             "repro_torch.data.pipeline",
             "repro_torch.checkpoint.manager",
             "repro_torch.distributed.fault_tolerance",
             "repro_torch.core.sim",
             "repro_torch.launch.train",
             "repro_torch.configs.whisper_small",
             "repro_torch.configs.llava_next_mistral_7b",
             "repro_torch.configs.nemotron_4_340b",
             "repro_torch.configs.shapes")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 65                       # every module was walked
    assert set(MUST_SCAN) <= set(names)


def test_chip_smoke_imports_only_torch_numpy_and_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert "jax" not in tops and "repro" not in tops
    assert tops <= {"__future__", "argparse", "dataclasses", "json", "math",
                    "os", "subprocess", "sys", "time", "numpy", "torch",
                    "repro_torch"}


def _import_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("tool", ["ab_kernels.py", "matmul_variants.py",
                                  "train_profile.py", "matmul_sum_units.py"])
def test_card_tools_import_neither_jax_nor_repro(tool):
    """The card-side measurement tools run where only the port is
    installed: they import no ``jax`` and nothing of ``repro``."""
    tops = _import_tops(os.path.join(ROOT, "tools", tool))
    assert "jax" not in tops and "jaxlib" not in tops and "repro" not in tops
    assert "repro_torch" in tops or "chip_smoke" in tops
