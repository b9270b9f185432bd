"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles in
seconds with ``nvcc`` alone (no PyTorch headers) into
``_build/lib<name>-<digest>.so``; the digest covers the source, the
headers of ``csrc/`` and the flags, so an edited kernel rebuilds and an
unchanged one is reused.
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
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

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
_fns: Dict[Tuple[str, str], "CFunction"] = {}


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
    """The shared library ``name`` builds into, keyed by its source, the
    headers of ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.h")))
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


class CFunction:
    """A kernel's C entry point, ``int symbol(const long long* args)``, with
    the layout of its packed arguments (``csrc/launch_args.h``): one 8-byte
    slot per entry of ``argtypes``, ``ctypes.c_float`` as a float64 and
    every integer or pointer as an int64 (0 for a null pointer), the
    stream last."""

    __slots__ = ("fn", "pack", "__name__")

    def __init__(self, fn, symbol: str, argtypes):
        self.fn = fn
        self.pack = struct.Struct("<" + "".join(
            "d" if t is ctypes.c_float else "q" for t in argtypes)).pack
        self.__name__ = symbol


def c_function(name: str, symbol: str, argtypes) -> CFunction:
    """``symbol`` of kernel ``name``, whose packed arguments have the types
    ``argtypes`` (every entry point returns the launch's
    ``cudaGetLastError()``).  Looked up and declared once per (library,
    symbol); later calls return the same object."""
    fn = _fns.get((name, symbol))
    if fn is None:
        c = getattr(library(name), symbol)
        c.argtypes = [ctypes.c_char_p]
        c.restype = ctypes.c_int
        fn = _fns[(name, symbol)] = CFunction(c, symbol, argtypes)
    return fn


def launch(fn: CFunction, index: int, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream
    of CUDA device ``index`` (a graph's capture stream while one is
    captured), making that device current only when it is not; raises if
    the launch was refused.  The stream is the raw handle that
    ``torch.cuda.current_stream(index).cuda_stream`` reads, taken without
    building a ``Stream`` object: that object cost 3.4 us of a call's 25 us
    on the card (one H100, 700 W), where a decode step issues over a
    thousand calls."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(fn, index, *args)
    err = fn.fn(fn.pack(*args, torch._C._cuda_getCurrentRawStream(index)))
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed (cudaError {err})")
