"""Production mesh factory: device-free meshes for the dry run, and
live slot meshes.

The reference builds ``jax`` meshes over 512 forced host devices.  The
port's dry run traces each cell on meta tensors and resolves the
logical-axis rules against the mesh's axis names and sizes alone, so
``make_production_mesh`` and ``make_host_mesh`` without a device return
``distributed.meshes.AbstractMesh``: no device is made or touched.
Handed a device, ``make_host_mesh`` returns a live ``DataMesh`` whose
slots all lie on it (several slots on one card or on the CPU, as the
reference's tests force host devices).  (The graph-mining tier's
execution mesh is ``data_mesh``, the 1-D form of the same type.)
"""
from __future__ import annotations

import torch

from repro_torch.distributed.meshes import AbstractMesh, slot_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ``("data", "model")``; with ``multi_pod`` 2 x 16 x 16
    ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(shape=None, axes=None, device=None):
    """``shape`` over ``axes``; with no shape, ``(1, n)`` ``("data",
    "model")`` over the n CUDA devices, raising where there is none.  With
    ``device``, a live ``DataMesh`` of that shape whose slots all lie on
    ``device`` (no shape: ``(1, 1)``)."""
    if device is not None:
        if shape is None:
            shape, axes = (1, 1), ("data", "model")
        if axes is None:
            raise ValueError("make_host_mesh: a shape needs its axis names")
        return slot_mesh(tuple(shape), tuple(axes), device)
    if shape is None:
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("make_host_mesh: no CUDA device; pass a "
                               "shape for a mesh of no devices")
        shape, axes = (1, n), ("data", "model")
    if axes is None:
        raise ValueError("make_host_mesh: a shape needs its axis names")
    return AbstractMesh(tuple(shape), tuple(axes))
