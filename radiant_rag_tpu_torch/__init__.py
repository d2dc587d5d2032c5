"""PyTorch / CUDA port of the radiant-rag retrieval engine for NVIDIA Hopper.

The JAX package `radiant_rag_tpu` is the reference; this package keeps its
module names (`ops/similarity.py`, `index/hybrid.py`, ...) so each function
has an obvious counterpart. It imports torch and numpy only. Hand-written
CUDA kernels live in `csrc/` and are built with nvcc at first use
(`_build.py`).

Entry points take `device=None`, which means CUDA. Without a card they raise
unless the caller asks for `device="cpu"` explicitly (the CPU tests do);
there is no silent CPU fallback.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda (raise when CUDA is missing); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "radiant_rag_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a card the copy goes through
    pinned memory and does not block: a copy from pageable memory waits for
    every kernel queued before it, which would hold the host's preparation
    of the next batch behind the device's work on this one."""
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
