"""The port's Trainer and launcher:

* the JAX package's fault-tolerance cases (``test_fault_tolerance.py``)
  on the port: straggler detection, retry, preemption, and kill /
  restore / resume identical to an uninterrupted run (an async resume
  included), and the Trainer's ``cuda`` default;
* ``python -m repro_torch.launch.train --device cpu``: the loss falls and
  checkpoints land every ``--ckpt-every`` steps; ``--dryrun`` and
  ``--mesh`` exit naming ``launch/dryrun.py``.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerDetector,
                                                     retry)
from repro_torch.train import loop as TT
from repro_torch.train import optimizer as TO

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_straggler_detection():
    sd = StragglerDetector()
    for _ in range(5):
        for h in range(8):
            sd.update(f"h{h}", 1.0 + (2.5 if h == 3 else 0.0))
    assert sd.stragglers() == ["h3"]
    assert sd.fleet_summary()["stragglers"] == 1


def test_straggler_needs_warmup():
    sd = StragglerDetector(warmup=3)
    sd.update("a", 1.0)
    sd.update("b", 9.0)
    assert sd.stragglers() == []


def test_retry_recovers_and_exhausts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42
    assert retry(flaky, attempts=3) == 42

    def broken():
        raise RuntimeError("x")
    with pytest.raises(RuntimeError):
        retry(broken, attempts=2)


def test_preemption_flag():
    h = PreemptionHandler(install=False)
    assert not h.triggered
    h.trigger()
    assert h.triggered
    h.reset()
    assert not h.triggered


def _tiny_tcfg(lr):
    return TT.TrainConfig(accum_steps=1,
                          optimizer=TO.OptimizerConfig(lr=lr), warmup=2)


def _random_batches(vocab):
    r = np.random.default_rng(7)
    while True:
        t = r.integers(0, vocab, (4, 32)).astype(np.int32)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def test_kill_restore_resume_identical(tmp_path):
    """Train 6 steps; separately train 3, 'crash', restore, train 3 more:
    the same final params."""
    cfg = get_config("tiny")
    tcfg = _tiny_tcfg(1e-2)
    t_all = TT.Trainer(cfg, tcfg, checkpoint_dir=str(tmp_path / "a"),
                       checkpoint_every=3, async_checkpoint=False,
                       device="cpu")
    t_all.run(_random_batches(cfg.vocab_size), 6)
    t1 = TT.Trainer(cfg, tcfg, checkpoint_dir=str(tmp_path / "b"),
                    checkpoint_every=3, async_checkpoint=False, device="cpu")
    gen = _random_batches(cfg.vocab_size)
    t1.run(gen, 3)
    del t1                                              # "crash"
    t2 = TT.Trainer(cfg, tcfg, checkpoint_dir=str(tmp_path / "b"),
                    checkpoint_every=3, async_checkpoint=True, device="cpu")
    assert t2.step == 3
    t2.run(gen, 3)
    for a, b in zip(TO.tree_leaves(t_all.state["params"]),
                    TO.tree_leaves(t2.state["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert len(t_all.metrics_log) == 6 and t2.metrics_log[-1]["step"] == 6


def test_preemption_checkpoints_immediately(tmp_path):
    cfg = get_config("tiny")
    tr = TT.Trainer(cfg, _tiny_tcfg(1e-3), checkpoint_dir=str(tmp_path),
                    checkpoint_every=1000, async_checkpoint=False,
                    device="cpu")

    def batches():
        while True:
            yield {"tokens": torch.zeros((2, 16), dtype=torch.int32),
                   "labels": torch.zeros((2, 16), dtype=torch.int32)}

    tr.preemption.trigger()
    tr.run(batches(), 5)
    assert tr.ckpt.list_steps() == [1]


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.Trainer(get_config("tiny"), _tiny_tcfg(1e-3))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    # one thread: the suite may run six test workers beside this process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)


def test_launcher_loss_falls(tmp_path):
    out = _launch("--arch", "tiny", "--steps", "30", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "10")
    assert out.returncode == 0, out.stderr
    m = re.search(r"done: loss ([\d.]+) -> ([\d.]+) at step 30", out.stdout)
    assert m, out.stdout
    assert float(m.group(2)) < float(m.group(1))
    assert sorted(os.listdir(tmp_path)) == ["step_000000010",
                                            "step_000000020",
                                            "step_000000030"]


@pytest.mark.parametrize("flag", [["--dryrun"], ["--mesh", "multi"]])
def test_launcher_dryrun_names_the_missing_module(flag):
    out = _launch("--device", "cpu", *flag)
    assert out.returncode != 0
    assert "launch/dryrun.py" in out.stderr
