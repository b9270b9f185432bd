"""Training launcher of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
        --steps 50 --device cpu

Trains ``--arch`` (``--reduced`` for its smoke-scale variant) on the
synthetic corpus of :mod:`repro_torch.data.pipeline` through
:class:`repro_torch.train.loop.Trainer`, with checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` (resuming from the newest one
there).  ``--device`` defaults to ``cuda``.  ``--dryrun`` (or ``--mesh``)
runs :func:`repro_torch.launch.dryrun.run_cell` for ``--arch`` on the
``train_4k`` cell of that mesh (``single`` by default) instead, on
``--device`` (``meta`` for a shape-only trace), and exits 1 unless its
status is ``ok``.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of --arch")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda | cpu)")
    ap.add_argument("--dryrun", action="store_true",
                    help="trace rank 0's train_4k step on a production "
                         "mesh (launch/dryrun.py)")
    ap.add_argument("--mesh", choices=("single", "multi"), default=None)
    return ap


def train(args: argparse.Namespace) -> None:
    """Run the flags' training; prints the config line and the loss from
    the first step to the last."""
    if args.dryrun or args.mesh:
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell(args.arch, "train_4k", args.mesh or "single",
                       device=args.device)
        if rec["status"] != "ok":
            raise SystemExit(1)
        return
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import make_training_data
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(accum_steps=args.accum,
                       optimizer=OptimizerConfig(name=cfg.optimizer,
                                                 lr=args.lr),
                       warmup=min(20, args.steps // 5 + 1),
                       total_steps=args.steps)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, accum {args.accum}, "
          f"device {args.device}", flush=True)
    data = make_training_data(cfg, batch=args.batch, seq=args.seq)
    tr = Trainer(cfg, tcfg, checkpoint_dir=args.ckpt_dir,
                 checkpoint_every=args.ckpt_every, device=args.device)
    last = tr.run(data, args.steps)
    data.close()
    first = tr.metrics_log[0]["loss"] if tr.metrics_log else math.nan
    final = last.get("loss", math.nan)
    print(f"done: loss {first:.3f} -> {final:.3f} at step {tr.step}",
          flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
