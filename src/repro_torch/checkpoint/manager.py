"""Sharded, asynchronous, atomic checkpointing of train states — the port of
the JAX package's ``checkpoint/manager.py``, on the same on-disk layout::

    <dir>/step_000000123/
        manifest.json      leaf paths, global shapes/dtypes, shard index
        leaf_<i>_shard_<j>.npy

* **Interchangeable**: leaves are numbered, and their ``path`` strings
  written, as JAX's ``tree_flatten_with_path`` / ``keystr`` do it (dict
  keys sorted; ``['params']['blocks']['pos0']['attn']['wq']``), so a
  checkpoint written by either package opens in the other.  A bfloat16
  leaf is written as the JAX package writes it — an ``'<V2'`` npy of the
  raw 2-byte words, manifest dtype ``"bfloat16"`` — and read back by
  reinterpreting those words, with no numeric cast (no ``ml_dtypes``).
* **Asynchronous**: ``save`` copies every tensor to host memory (CUDA
  tensors included) before the writer thread starts, so the train loop
  never blocks on storage and may update its state in place meanwhile.
* **Atomic**: written to ``step_N.tmp`` then renamed; a crash never leaves
  a half checkpoint that ``restore_latest`` would pick up; ``keep`` bounds
  the checkpoints kept.
* **Shard slices**: every shard records its global index ranges, and
  ``restore`` assembles each leaf from whatever saved slices overlap it,
  so a checkpoint written in pieces (by several hosts) restores whole.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# manifest dtype names <-> torch dtypes; bfloat16 travels as int16 words
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_BF16 = "bfloat16"


def _flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(tree)


def _snapshot(leaf) -> Tuple[str, Tuple[int, ...], np.ndarray]:
    """(dtype name, shape, a host copy of the leaf's data: the raw int16
    words of a bfloat16 tensor)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return str(arr.dtype), arr.shape, arr
    t = leaf.detach()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, tuple(t.shape), t.to("cpu", copy=True).numpy()


def _save_npy(path: str, name: str, data: np.ndarray) -> None:
    if name != _BF16:
        np.save(path, data)
        return
    # the JAX package's bytes for an ml_dtypes bfloat16 array
    data = np.ascontiguousarray(data, dtype="<i2")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": data.shape})
        f.write(data.tobytes())


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state) -> None:
        """Snapshot to host, then write in the background (if async)."""
        self.wait()
        snap = []
        for path, leaf in _flatten_with_path(state):
            name, shape, data = _snapshot(leaf)
            snap.append((path, name, shape,
                         [(_index_to_json((), shape), data)]))

        def write():
            try:
                self._write(step, snap)
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_if_failed()

    def _write(self, step: int, snap) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        for i, (path, name, shape, shards) in enumerate(snap):
            entry = {"path": path, "dtype": name, "shape": list(shape),
                     "shards": []}
            for j, (idx, data) in enumerate(shards):
                fname = f"leaf_{i:05d}_shard_{j:03d}.npy"
                _save_npy(os.path.join(tmp, fname), name, data)
                entry["shards"].append({"file": fname, "index": idx})
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e!r}") from e

    # ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, template) -> Any:
        """The state saved at ``step``, shaped like ``template``: each leaf
        assembled from its saved shard slices and put on the template
        leaf's device and dtype."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for path, leaf in _flatten_with_path(template):
            e = by_path[path]
            shape = tuple(e["shape"])
            bf16 = e["dtype"] == _BF16
            block = np.zeros(shape, np.int16 if bf16 else np.dtype(e["dtype"]))
            for s in e["shards"]:
                _assemble(block, _index_from_json(s["index"]),
                          os.path.join(d, s["file"]))
            t = torch.from_numpy(block)
            if bf16:
                t = t.view(torch.bfloat16)
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            out.append(t)
        return _unflatten(template, out)

    def restore_latest(self, template) -> Optional[Any]:
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], template)


# ---------------------------------------------------------------------------

def _assemble(block: np.ndarray, have, fname: str) -> None:
    """Copy the part of a saved shard (global slice ``have``) that lies in
    ``block`` (the whole leaf) into it."""
    have = _normalize(have, block.shape)
    data = np.load(fname, mmap_mode="r")
    if data.dtype.kind == "V":                  # bfloat16 words
        data = data.view(np.int16)
    block[have] = data


def _index_to_json(index, shape) -> list:
    idx = _normalize(index, shape)
    return [[s.start, s.stop] for s in idx]


def _index_from_json(j):
    return tuple(slice(a, b) for a, b in j)


def _normalize(index, shape):
    if not index:
        index = tuple(slice(None) for _ in shape)
    out = []
    for sl, n in zip(index, shape):
        start = 0 if sl.start is None else sl.start
        stop = n if sl.stop is None else sl.stop
        out.append(slice(start, stop))
    return tuple(out)
