"""Device policy of the port, in one place.

Entry points (``compiler.compile``, ``CountingEngine``) take a ``device``
argument.  ``None`` means the CUDA device and *raises* when there is
none; the CPU is used only when the caller names it (``device="cpu"``),
as the CPU tests do.  Nothing here picks the CPU quietly.

Counts are f64 tensors on the device (exact up to 2^53).
"""
from __future__ import annotations

import torch

COUNT_DTYPE = torch.float64


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising without one); anything else is taken
    at the caller's word."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run on the CPU explicitly")
    return dev
