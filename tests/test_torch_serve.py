"""``python -m repro_torch.launch.serve`` against the JAX package's
launcher: every mode on ``tiny`` with ``--device cpu``, the speculative,
streaming, event-loop and tracing flags, and greedy tokens of the batch
modes equal to the reference launcher's on the same params (the port's
``serve(args, params=)`` takes the JAX package's seed-0 weights carried
across through numpy; the reference's outputs are read through a
recording subclass of its ``LLM``)."""
import json
import os
import subprocess
import sys

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import repro.serving.api as japi
from repro.configs import get_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def tiny_params():
    cfg = get_config("tiny")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")


def _port(argv, params):
    args = tserve.build_parser().parse_args(
        ["--arch", "tiny", "--device", "cpu", *argv])
    return tserve.serve(args, params=params)


def _reference(argv, monkeypatch):
    """The reference launcher's output tokens, in submission order."""
    got = []

    class Recording(japi.LLM):
        def generate(self, *a, **kw):
            outs = super().generate(*a, **kw)
            got.extend(o.tokens for o in outs)
            return outs

        def drain(self, *a, **kw):
            outs = super().drain(*a, **kw)
            got.extend(outs[r].tokens for r in sorted(outs))
            return outs

    monkeypatch.setattr(japi, "LLM", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "tiny", *argv])
    jserve.main()
    return got


@pytest.mark.parametrize("mode", ["resident", "offload", "batch",
                                  "batch-offload"])
def test_every_mode_serves_on_the_cpu(mode, tiny_params, capsys):
    res = _port(["--mode", mode, "--max-new", "6"], tiny_params)
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "device=cpu" in out
    assert len(res["outputs"]) == 4
    assert all(len(o.tokens) == 6 for o in res["outputs"])
    assert res["stats"]["executor"] == (
        "generator" if mode in ("resident", "offload") else "batcher")
    if "offload" in mode:
        assert "phase plans:" in out and "stream busy" in out


@pytest.mark.parametrize("argv", [
    ["--mode", "batch"],
    ["--mode", "batch-offload"],
    ["--mode", "batch", "--paged", "--spec", "ngram"],
    ["--mode", "batch-offload", "--paged", "--spec", "ngram",
     "--spec-adaptive"],
], ids=["batch", "batch-offload", "batch-spec", "batch-offload-spec"])
def test_batch_tokens_equal_reference_launcher(argv, tiny_params,
                                               monkeypatch, capsys):
    argv = argv + ["--hw", "a10", "--max-new", "8"]
    want = _reference(argv, monkeypatch)
    res = _port(argv, tiny_params)
    assert [o.tokens for o in res["outputs"]] == want
    if "--spec" in argv:
        assert res["stats"]["spec"]["drafted"] > 0
        assert "speculative: drafter=ngram" in capsys.readouterr().out


def test_spec_stream_async_trace_flags(tiny_params, tmp_path, capsys):
    trace = tmp_path / "t.json"
    res = _port(["--mode", "batch-offload", "--paged", "--spec", "ngram",
                 "--stream", "--async", "--trace", str(trace),
                 "--overlap-report", "--max-new", "8"], tiny_params)
    out = capsys.readouterr().out
    streamed = [int(line.split(">")[1]) for line in out.splitlines()
                if line.startswith("  stream> ")]
    assert len(streamed) == 8
    assert len(res["outputs"]) == 3
    assert res["stats"]["executor"] == "batcher(async)"
    assert "verify" in res["stats"]["phase_alpha"]
    with open(trace) as f:
        doc = json.load(f)
    assert doc["traceEvents"] and f"trace: {trace}" in out
    assert "critical path" in out
    # the same requests without the extra flags: the same tokens
    plain = _port(["--mode", "batch-offload", "--paged", "--spec", "ngram",
                   "--stream", "--max-new", "8"], tiny_params)
    assert [o.tokens for o in plain["outputs"]] == \
        [o.tokens for o in res["outputs"]]


def test_model_drafter_and_priority_policy(tiny_params, capsys):
    res = _port(["--mode", "batch", "--paged", "--spec", "model",
                 "--spec-k", "3", "--policy", "priority", "--n-pages", "12",
                 "--max-new", "6"], tiny_params)
    out = capsys.readouterr().out
    assert "speculative: drafter=model k=3" in out
    assert res["stats"]["spec"]["acceptance_rate"] == 1.0   # self-draft
    assert "policy=priority" in out


def test_defaults_and_unported_dryrun(tiny_params):
    args = tserve.build_parser().parse_args([])
    assert args.device == "cuda" and args.hw == "h100"
    rec = _port(["--dryrun"], tiny_params)        # rank 0 of (16, 16)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["shape"], rec["mesh"], rec["device"]) == (
        "decode_32k", "single", "cpu")
    assert rec["memory"]["argument_bytes"] == (
        rec["memory"]["analytic"]["params"]
        + rec["memory"]["analytic"]["cache"])
    if not torch.cuda.is_available():
        # no card: the default device refuses instead of running on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.serve(tserve.build_parser().parse_args(
                ["--arch", "tiny"]), params=tiny_params)


def test_dryrun_of_a_failed_cell_exits_1(capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "tiny", "--device", "cpu", "--dryrun",
                     "--shape", "no_such_shape"])
    assert e.value.code == 1
    assert "[ERROR] tiny x no_such_shape x single" in capsys.readouterr().out


def test_module_entry_point():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tiny",
         "--device", "cpu", "--mode", "batch", "--paged", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "4 requests, 16 tokens via executor=batcher" in out.stdout
