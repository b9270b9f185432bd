"""HeteGen on PyTorch + CUDA: the port of :mod:`repro` to NVIDIA Hopper.

Same layout as the JAX package (``repro/core/engine.py`` ↔
``repro_torch/core/engine.py``); imports ``torch`` and numpy only.  Entry
points (``LLM``, ``HeteGenBackend``, ``ResidentBackend``, ``init_params``,
``HeteGenEngine``) run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels live under ``csrc/`` and are
built with ``nvcc`` at first use (:mod:`repro_torch.kernels.build`).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Without a card and without ``device=``, raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the host")
    return dev
