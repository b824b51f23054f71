"""Production mesh factory: device-free meshes for the dry run.

The reference builds ``jax`` meshes over 512 forced host devices.  The
port's dry run traces each cell on meta tensors and resolves the
logical-axis rules against the mesh's axis names and sizes alone, so
these return ``distributed.meshes.AbstractMesh``: no device is made or
touched.  (The graph-mining tier's execution mesh is ``data_mesh``, a
``DataMesh`` of device slots; it is separate from these.)
"""
from __future__ import annotations

import torch

from repro_torch.distributed.meshes import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ``("data", "model")``; with ``multi_pod`` 2 x 16 x 16
    ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(shape=None, axes=None) -> AbstractMesh:
    """``shape`` over ``axes``; with no shape, ``(1, n)`` ``("data",
    "model")`` over the n CUDA devices, raising where there is none."""
    if shape is None:
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("make_host_mesh: no CUDA device; pass a "
                               "shape for a mesh of no devices")
        shape, axes = (1, n), ("data", "model")
    if axes is None:
        raise ValueError("make_host_mesh: a shape needs its axis names")
    return AbstractMesh(tuple(shape), tuple(axes))
