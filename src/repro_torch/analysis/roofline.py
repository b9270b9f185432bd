"""Roofline table builder — reads dry-run JSON records, emits Markdown.

The port of the JAX package's ``analysis/roofline.py`` with one H100's
constants.  Per (arch x shape x mesh) cell:

    compute_s    = FLOPs_per_device / 989 TF/s   (dense bf16, H100 SXM)
    memory_s     = bytes_per_device / 3.35 TB/s  (HBM3, H100 SXM)
    collective_s = collective_wire_bytes_per_device / 50 GB/s per link

The link figure is a ring's slowest hop: a 16-wide "model" axis spans two
8-GPU NVLink domains (450 GB/s a direction inside one), so every ring over
it crosses the inter-node fabric, one 400 Gb/s NDR InfiniBand port a GPU
(50 GB/s).  The counts come from :mod:`repro_torch.analysis.hlo_cost`
over a traced rank-0 step (``launch/dryrun.py``).

Also derived:
    MODEL_FLOPS  = 6*N*D for train (N = params — active params for MoE),
                   2*N*D for prefill, 2*N*batch for one decode step
    useful ratio = MODEL_FLOPS / (FLOPs_per_device * chips)
    roofline fraction = floor / dominant term, bound = the dominant term
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import kv_cache_bytes

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    s = SHAPES[shape]
    n = cfg.active_param_count()
    if s.kind == "train":
        return 6.0 * n * s.batch * s.seq
    if s.kind == "prefill":
        return 2.0 * n * s.batch * s.seq
    return 2.0 * n * s.batch            # one decode step


def ideal_seconds(arch: str, shape: str, chips: int) -> Dict[str, float]:
    """Irreducible per-chip time: the roofline floor for this cell.

    compute: MODEL_FLOPS at the card's peak.
    memory:  the bytes the algorithm MUST move per step —
      decode:  params (weights read once) + KV cache read
      prefill: params + 2x cache (compute + write K/V)
      train:   3x params (fwd read, bwd read, update write) + grad buffer
               r/w + 2x remat-saved activations (write fwd, read bwd)
    The roofline fraction is max(ideal_compute, ideal_memory) /
    dominant_term — 100% means the dominant term is at its floor.
    """
    cfg = get_config(arch)
    s = SHAPES[shape]
    dt = cfg.dtype_bytes()
    p_bytes = cfg.param_count() * dt
    if s.kind == "decode":
        cache = kv_cache_bytes(cfg, s.batch, s.seq)
        mem = p_bytes + cache
    elif s.kind == "prefill":
        cache = kv_cache_bytes(cfg, s.batch, s.seq)
        mem = p_bytes + 2 * cache
    else:
        tokens = s.batch * s.seq
        saved = cfg.n_layers * tokens * cfg.d_model * dt
        mem = 3 * p_bytes + 2 * cfg.param_count() * 4 + 2 * saved
    comp = model_flops(arch, shape) / (chips * PEAK_FLOPS)
    return {"compute": comp, "memory": mem / (chips * HBM_BW),
            "floor": max(comp, mem / (chips * HBM_BW))}


def roofline_terms(hlo: Dict) -> Dict[str, float]:
    """One rank's compute, memory and collective seconds at the card's
    rates, from a record's ``hlo`` counts."""
    return {
        "compute_s": hlo["flops_per_device"] / PEAK_FLOPS,
        "memory_s": hlo["bytes_per_device"] / HBM_BW,
        "collective_s": hlo["collective_wire_bytes_total"] / LINK_BW,
    }


def load_records(out_dir: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def enrich(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    chips = 1
    for v in rec["mesh_shape"].values():
        chips *= v
    hlo = rec["hlo"]
    terms = roofline_terms(hlo)
    dominant = max(terms, key=terms.get)
    total = sum(terms.values())
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_total_flops = hlo["flops_per_device"] * chips
    step_bound_s = max(terms.values())
    ideal = ideal_seconds(rec["arch"], rec["shape"], chips)
    return {
        **rec,
        "chips": chips,
        "terms": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(hlo_total_flops, 1e-30),
        "ideal": ideal,
        "roofline_fraction": ideal["floor"] / max(step_bound_s, 1e-30),
        "bound_s": step_bound_s,
        "balance": step_bound_s / max(total, 1e-30),
    }


_FIX_HINTS = {
    ("memory_s", "decode"): "decode is HBM-bound as expected; int8 KV/"
        "weights or larger batch raise arithmetic intensity",
    ("memory_s", "train"): "fuse/remat to cut activation re-reads; check "
        "redundant layout changes in the HLO",
    ("memory_s", "prefill"): "larger attention chunk or flash kernel to cut "
        "score-tensor traffic",
    ("compute_s", "train"): "compute-bound — good; raise MFU via larger "
        "microbatch or kernel fusion",
    ("compute_s", "prefill"): "compute-bound — good; tensor-core tiles",
    ("compute_s", "decode"): "unusual for decode: look for dense recompute "
        "of unused logits or capacity-padded MoE",
    ("collective_s", "train"): "shift TP collectives to reduce-scatter/"
        "all-gather (SP), overlap with compute, or rebalance TP vs DP",
    ("collective_s", "prefill"): "sequence-parallel attention or fewer "
        "all-gathers of KV",
    ("collective_s", "decode"): "TP all-reduces dominate tiny decode "
        "matmuls: batch heads per collective / widen DP",
}


def fix_hint(dominant: str, shape: str) -> str:
    kind = SHAPES[shape].kind
    return _FIX_HINTS.get((dominant, kind), "")


def markdown_table(recs: List[Dict], mesh: str = "single") -> str:
    rows = []
    head = ("| arch | shape | compute_s | memory_s | collective_s | "
            "dominant | MODEL_FLOPS/HLO | roofline-frac | note |")
    sep = "|" + "---|" * 9
    rows.append(head)
    rows.append(sep)
    for r in recs:
        e = enrich(r) if r.get("status") == "ok" else None
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| — | skipped: {r['reason'][:50]} |")
            continue
        if e is None:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| — | ERROR |")
            continue
        t = e["terms"]
        rows.append(
            f"| {e['arch']} | {e['shape']} "
            f"| {t['compute_s']*1e3:.2f}ms | {t['memory_s']*1e3:.2f}ms "
            f"| {t['collective_s']*1e3:.2f}ms "
            f"| {e['dominant'].replace('_s','')} "
            f"| {e['useful_flops_ratio']:.2f} "
            f"| {e['roofline_fraction']:.2%} "
            f"| {fix_hint(e['dominant'], e['shape'])[:60]} |")
    return "\n".join(rows)


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | status | mem/dev (analytic) | fits "
            "| colls | trace_s |", "|" + "---|" * 8]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skip | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | — | — | — | — |")
            continue
        an = r["memory"].get("analytic", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {an.get('total', 0)/2**30:.2f} GiB "
            f"| {'yes' if r['memory'].get('fits_80GB') else 'NO'} "
            f"| {r['hlo']['collective_count']} | {r.get('trace_s')} |")
    return "\n".join(rows)
