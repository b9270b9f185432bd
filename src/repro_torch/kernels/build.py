"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles in
seconds with ``nvcc`` alone (no PyTorch headers) into
``_build/lib<name>-<digest>.so``; the digest covers the source and the
flags, so an edited kernel rebuilds and an unchanged one is reused.
Nothing is compiled at import: :func:`library` builds on first use, and
:func:`build` starts one ``nvcc`` per source at once (what a cold start
that needs every kernel should call).  ``_build/`` is listed in
``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("paged_decode_attention", "paged_prefill_attention", "q8_matmul",
           "decode_attention", "flash_attention", "rmsnorm", "ssd_chunk",
           "hete_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: PyTorch's resolved CUDA home first, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def target(name: str) -> Path:
    """The shared library ``name`` builds into."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every stale library in ``names``, one ``nvcc`` each, all
    started together.  Returns each kernel's compiler output (the
    ``-Xptxas -v`` register/shared-memory summary); raises on a failed
    build with that output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for name in names:
        so = target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            _libs[name] = lib
        return lib


def c_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of kernel ``name`` with its C signature declared (every
    entry point returns the launch's ``cudaGetLastError()``)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
