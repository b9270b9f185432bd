"""Multi-pod dry-run: trace rank 0's step of every (arch x shape x mesh) cell.

The port of the JAX package's ``launch/dryrun.py``.  The JAX package
lowers and compiles each cell's step with 512 placeholder host devices.
Here one process joins a world of 256 or 512 ranks as rank 0
(:func:`repro_torch.launch.mesh.init_fake_world`: a process group whose
collectives move no data) and builds the production mesh on it:

    single:  (16,16)    ("data","model")          — 256 ranks
    multi:   (2,16,16)  ("pod","data","model")    — 512 ranks

For every cell it places the step's arguments — params, optimizer state,
cache, batch — as ``DTensor``s whose local tensors are rank 0's shards
(:func:`repro_torch.distributed.specs.distribute`), runs the real step
function (``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` under the cell's sharding rules) once under
:class:`repro_torch.analysis.hlo_cost.CostMode`, and writes one JSON
record per cell under ``--out``: the exact per-device argument bytes, the
analytic footprint (:mod:`repro_torch.analysis.memory_model`), the
per-device FLOPs, bytes and collective wire bytes, and the roofline terms
on one H100 (:func:`repro_torch.analysis.roofline.roofline_terms`).

``--device`` says where the shards live:

* ``meta`` (the default): a shape-only trace, nothing allocated, nothing
  computed; a kernel wrapper reached there runs its plain version on meta
  tensors (tallied as route ``meta`` in ``kernel_calls``);
* ``cuda``: rank 0's step executes on the card — its shards allocated,
  every kernel launched on them — and the record adds the measured peak
  (``memory.measured_peak_bytes``, ``torch.cuda.max_memory_allocated``)
  and the step's time under CUDA events (``step_ms``, a second step after
  the traced one);
* ``cpu``: the same execution on the host (small configs).

The world's collectives move no data, so the VALUES a step computes are
meaningless, as the JAX package's compile-only dry-run computes none: only
shapes, bytes, FLOPs and times count.  A decode cell on a device starts
from a full cache (its length set to seq - 1), so its kernels read every
key.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    ... --arch mistral-nemo-12b --shape decode_32k --mesh single
    ... --device cuda      # execute rank 0's step on the card
    ... --no-sp            # disable sequence-parallel activations
    ... --list             # print the cell matrix and exit
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis.roofline import roofline_terms
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable
from repro_torch.distributed import specs as SP
from repro_torch.distributed.shardings import PartitionSpec as P
from repro_torch.distributed.shardings import ShardingRules, is_dtensor

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _accum_for(shape_batch: int, batch_shards: int) -> int:
    """Largest accumulation count keeping micro-batch >= batch shards."""
    for a in (16, 8, 4, 2, 1):
        if shape_batch % a == 0 and shape_batch // a >= batch_shards:
            return a
    return 1


def _local_maker(device: str):
    """``distribute``'s ``local_fn``: rank 0's shard of a leaf on
    ``device`` (zeros; meta allocates nothing)."""
    def make(path, leaf, shape):
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return make


def build_cell(cfg, shape_name: str, mesh, *,
               sequence_parallel: Optional[bool] = None,
               batch_override: Optional[int] = None,
               device: str = "meta"):
    """Returns (step, args, meta): ``step(*args)`` runs rank 0's step on
    ``args`` placed on ``mesh``.

    ``sequence_parallel`` defaults per arch: on for the >=100B (fsdp)
    archs whose remat-saved activations need the model axis, off
    otherwise.
    """
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig

    if sequence_parallel is None:
        sequence_parallel = cfg.fsdp
    rules = ShardingRules.for_mesh(mesh, sequence_parallel=sequence_parallel)
    shape = SHAPES[shape_name]
    ins = input_specs(cfg, shape_name, batch_override=batch_override)
    pshape = SP.param_shapes(cfg)
    pspec = SP.param_specs(cfg, rules, pshape,
                           serve=(shape.kind != "train"))
    make = _local_maker(device)

    def place(tree, spec):
        return SP.distribute(tree, mesh, spec, local_fn=make)

    if shape.kind == "train":
        batch_shards = 1
        for a in ("pod", "data"):
            batch_shards *= rules.mesh_shape.get(a, 1)
        accum = _accum_for(ins["batch"][next(iter(ins["batch"]))].shape[0],
                           batch_shards)
        tcfg = TrainConfig(
            accum_steps=accum,
            accum_dtype="bfloat16" if accum >= 8 else "float32",
            optimizer=OptimizerConfig(
                name=cfg.optimizer,
                moment_dtype="bfloat16" if cfg.optimizer == "adamw"
                else "float32"))
        step_fn, opt_init = make_train_step(cfg, tcfg, rules)
        opt_shape = opt_init(pshape)
        ospec = SP.opt_state_specs(cfg, rules, opt_shape, pspec)
        state = {"params": place(pshape, pspec),
                 "opt": place(opt_shape, ospec),
                 "step": place(torch.zeros((), dtype=torch.int32,
                                           device="meta"), P())}
        batch = place(ins["batch"], SP.batch_specs(cfg, rules, ins["batch"]))
        meta = dict(kind="train", rules=rules, accum=accum,
                    param=(pshape, pspec), opt=(opt_shape, ospec),
                    state=(state["params"], state["opt"]))
        return step_fn, (state, batch), meta

    cache_shape = ins["cache"]
    cspec = SP.cache_specs(cfg, rules, cache_shape)
    params = place(pshape, pspec)
    cache = place(cache_shape, cspec)
    if shape.kind == "prefill":
        batch = place(ins["batch"], SP.batch_specs(cfg, rules, ins["batch"]))
        meta = dict(kind="prefill", rules=rules, accum=1,
                    param=(pshape, pspec), cache=(cache_shape, cspec),
                    state=(params, cache))
        return make_prefill_step(cfg, rules), (params, batch, cache), meta
    token = place(ins["token"], SP.batch_specs(cfg, rules, ins["token"]))
    if device != "meta":
        cache["len"].to_local().fill_(shape.seq - 1)   # a full cache
    meta = dict(kind="decode", rules=rules, accum=1,
                param=(pshape, pspec), cache=(cache_shape, cspec),
                state=(params, cache))
    return make_serve_step(cfg, rules), (params, token, cache), meta


def _local_bytes(tree) -> int:
    total = 0
    for _, x in SP.flatten_with_path(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def fake_world(n: int, device: str):
    """A fake world of ``n`` ranks for the block; one of that size that
    stands already is used as it is."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_world
    if dist.is_initialized() and dist.get_world_size() == n:
        yield
        return
    init_fake_world(n, device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_device_type(device: str, kind: str) -> str:
    """The device type of a cell's mesh.  A meta trace takes ``cuda``, as
    the card's run does, so ``DTensor`` plans the collectives it would
    plan there (a ``cpu`` mesh turns each all-to-all into an all-gather);
    but a train cell's backward makes ``DTensor`` propagate some ops on
    tensors of the mesh's device, so on a build without CUDA it takes
    ``cpu``."""
    if device == "cpu" or (device == "meta" and kind == "train"
                           and not torch.backends.cuda.is_built()):
        return "cpu"
    return "cuda"


def make_cell_mesh(mesh_kind: str, device_type: str):
    from repro_torch.launch.mesh import make_mesh
    shape, axes = MESHES[mesh_kind]
    return make_mesh(shape, axes, device_type=device_type)


def trace_cell(cfg, shape_name: str, mesh, *, device: str = "meta",
               sequence_parallel: Optional[bool] = None,
               batch_override: Optional[int] = None,
               time_step: bool = False) -> Dict:
    """Build and run one cell's rank-0 step on ``mesh`` under the cost
    mode; returns the record's measured parts (``memory``, ``hlo``,
    ``kernel_calls``, timings)."""
    from repro_torch.analysis import memory_model as MM
    from repro_torch.analysis.hlo_cost import CostMode
    from repro_torch.kernels import ops

    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step, args, meta = build_cell(cfg, shape_name, mesh,
                                  sequence_parallel=sequence_parallel,
                                  batch_override=batch_override,
                                  device=device)
    out: Dict = {"accum_steps": meta["accum"]}
    cap = 2 if cfg.dtype == "bfloat16" else None
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    with torch.no_grad() if meta["kind"] != "train" else \
            contextlib.nullcontext():
        with CostMode(max_bytes_per_elem=cap) as cm:
            step(*args)
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.update(build_s=round(t1 - t0, 3), trace_s=round(t2 - t1, 3))
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["kernel_calls"] = {f"{n}:{r}": c
                           for (n, r), c in sorted(cm.kernel_calls.items())}
    rep = cm.report
    out["hlo"] = {
        "flops_per_device": rep.flops,
        "bytes_per_device": rep.bytes,
        "collective_bytes": dict(rep.collective_bytes),
        "collective_wire_bytes_total": rep.total_collective_bytes,
        "collective_count": rep.collective_count,
        "dtype_cap_bytes": cap,
    }
    shp = SHAPES[shape_name]
    rules = meta["rules"]
    est_kw = dict(kind=meta["kind"], batch=batch_override or shp.batch,
                  seq=shp.seq, rules=rules, accum=meta["accum"],
                  accum_dtype_bytes=2 if meta["accum"] >= 8 else 4,
                  param_shapes=meta["param"][0], param_spec=meta["param"][1])
    if "opt" in meta:
        est_kw.update(opt_shapes=meta["opt"][0], opt_spec=meta["opt"][1])
    if "cache" in meta:
        est_kw.update(cache_shapes=meta["cache"][0],
                      cache_spec=meta["cache"][1])
    est = MM.estimate(cfg, **est_kw)
    mem = {"argument_bytes": _local_bytes(meta["state"]),
           "input_bytes": _local_bytes(args) - _local_bytes(meta["state"]),
           "analytic": {k: (float(v) if not isinstance(v, bool) else v)
                        for k, v in est.items()},
           "fits_80GB": bool(est["fits_80GB"])}
    if cuda:
        mem["measured_peak_bytes"] = int(torch.cuda.max_memory_allocated()
                                         - base)
        mem["device_total_bytes"] = int(
            torch.cuda.get_device_properties(0).total_memory)
        if time_step:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with torch.no_grad() if meta["kind"] != "train" else \
                    contextlib.nullcontext():
                ev[0].record()
                step(*args)
                ev[1].record()
            torch.cuda.synchronize()
            out["step_ms"] = ev[0].elapsed_time(ev[1])
            mem["measured_peak_bytes"] = int(
                torch.cuda.max_memory_allocated() - base)
    out["memory"] = mem
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             sequence_parallel: Optional[bool] = None,
             kv_int8: bool = False,
             device: str = "meta",
             out_dir: Optional[str] = None,
             verbose: bool = True) -> Dict:
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "sequence_parallel": sequence_parallel,
                 "kv_dtype": cfg.kv_dtype, "device": device}
    if shape_name not in SHAPES:
        rec.update(status="error", error=f"unknown shape {shape_name!r} "
                   f"(one of {', '.join(SHAPES)})")
        return _finish(rec, out_dir, verbose)
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return _finish(rec, out_dir, verbose)
    shape, axes = MESHES[mesh_kind]
    n = 1
    for d in shape:
        n *= d
    try:
        with fake_world(n, device):
            rec["mesh_device_type"] = mesh_device_type(
                device, SHAPES[shape_name].kind)
            mesh = make_cell_mesh(mesh_kind, rec["mesh_device_type"])
            rec["mesh_shape"] = dict(zip(axes, shape))
            rec.update(trace_cell(cfg, shape_name, mesh, device=device,
                                  sequence_parallel=sequence_parallel,
                                  time_step=device == "cuda"))
        terms = roofline_terms(rec["hlo"])
        rec["roofline"] = {**terms, "dominant": max(terms, key=terms.get)}
        if verbose:
            an = rec["memory"]["analytic"]
            print(f"  analytic_est: "
                  f"{ {k: round(v / 2**30, 2) if isinstance(v, float) else v for k, v in an.items()} } GiB")
            print(f"  hlo: {rec['hlo']}")
        rec["status"] = "ok"
    except Exception as e:                                    # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return _finish(rec, out_dir, verbose)


def _finish(rec: Dict, out_dir: Optional[str], verbose: bool) -> Dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        s = rec["status"].upper()
        extra = ""
        if rec["status"] == "ok":
            gb = rec["memory"]["analytic"]["total"] / 2**30
            extra = (f" mem/dev={gb:.2f}GiB"
                     f" fits={rec['memory']['fits_80GB']}"
                     f" colls={rec['hlo']['collective_count']}")
        elif rec["status"] == "error":
            extra = " " + rec["error"][:160]
        elif rec["status"] == "skipped":
            extra = " (" + rec["reason"][:60] + ")"
        print(f"[{s}] {rec['arch']} x {rec['shape']} x {rec['mesh']}{extra}",
              flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="*", default=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activation sharding")
    ap.add_argument("--int8-kv", action="store_true",
                    help="quantized int8 KV cache")
    ap.add_argument("--device", choices=("meta", "cpu", "cuda"),
                    default="meta",
                    help="meta: shape-only trace; cpu/cuda: execute rank "
                    "0's step there")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    cells = [(a, s, m) for a in args.arch for s in args.shape
             for m in meshes]
    if args.list:
        for c in cells:
            print(*c)
        return

    n_ok = n_err = n_skip = 0
    t0 = time.time()
    for arch, shape, mesh_kind in cells:
        rec = run_cell(arch, shape, mesh_kind,
                       sequence_parallel=False if args.no_sp else None,
                       kv_int8=args.int8_kv, device=args.device,
                       out_dir=args.out, verbose=True)
        n_ok += rec["status"] == "ok"
        n_err += rec["status"] == "error"
        n_skip += rec["status"] == "skipped"
    print(f"\ndone in {time.time()-t0:.0f}s: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
