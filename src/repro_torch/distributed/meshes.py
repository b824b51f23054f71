"""The execution mesh of the graph-mining tier: a 1-D ``("data",)`` mesh
of device slots in one process.

The reference package shards over a ``jax.sharding.Mesh`` and runs each
request of a batch under ``jax.default_device(slot)``; its tests force
eight host devices into one CPU process.  The port keeps that programming
model rather than going multi-process: a ``DataMesh`` is an ordered tuple
of ``torch.device`` slots, and a slot may repeat a device — the
counterpart of ``--xla_force_host_platform_device_count``.  Every sharded
route (``distributed.cutjoin``, ``distributed.contract``) runs each slot's
share on that slot's device and sums the slots' f64 partials in slot
order on slot 0's device (the reference's ``psum``).  Where slots share a
device, a replicated tensor is one tensor and a slot's row block is a
view of it.

``num_chips``, ``sharding_ctx`` and ``active_mesh`` exist for parity with
the reference's API: no route of the port reads the active mesh yet (the
lint's ``mesh-guard`` rule looks for ``sharding_ctx`` by name).  The
logical-axis rules of the reference's ``meshes`` module
(``DEFAULT_RULES``, ``spec_for``, ``constrain``, ``tree_shardings``) serve
the LM scaffold and wait for it (ROADMAP.md queue 1, item 13f).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import device as _device

AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """An ordered tuple of device slots on the axis ``"data"``."""
    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    @property
    def home(self) -> torch.device:
        """Slot 0's device: where slot partials meet and results land."""
        return self.devices[0]


def _normalised(device) -> torch.device:
    """A device as tensors report it: ``cuda`` gains the current index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(num_devices: Optional[int] = None, *, device=None) -> DataMesh:
    """1-D ``("data",)`` mesh.  With ``device``, ``num_devices`` slots (1
    when None) all on that device: several slots on one card or on the
    CPU, as the reference's tests force host devices.  Without it, the
    first ``num_devices`` CUDA devices (all of them when None); raises
    when fewer exist — it never makes fewer slots than asked."""
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices={num_devices}: a mesh needs a slot")
    if device is not None:
        dev = _normalised(_device.resolve(device))
        return DataMesh((dev,) * (num_devices or 1))
    have = torch.cuda.device_count()
    want = have if num_devices is None else num_devices
    if want < 1 or want > have:
        raise RuntimeError(f"data_mesh: {want} CUDA device(s) asked for, "
                           f"{have} available; pass device= to put "
                           f"several slots on one device")
    return DataMesh(tuple(torch.device("cuda", i) for i in range(want)))


def num_shards(mesh: Optional[DataMesh], axis: str = AXIS) -> int:
    """Size of ``axis`` in ``mesh`` — 1 when the mesh is absent or does not
    carry the axis, so callers treat "no mesh" and "trivial mesh" alike."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))


def slot_ranges(n: int, d: int) -> list:
    """Slot s's rows ``[start, stop)`` of an axis of length ``n`` split
    over ``d`` slots: ⌈n / d⌉ rows each, the last slots short or empty.
    Every sharded route splits its axis so."""
    rows = -(-max(n, 1) // d)
    return [(min(n, s * rows), min(n, (s + 1) * rows)) for s in range(d)]


class Replicas:
    """One copy of each whole operand per slot device: ``get(key, dev,
    make)`` calls ``make(dev)`` once per (key, device) and returns that
    copy after."""

    def __init__(self):
        self._memo: dict = {}

    def get(self, key, dev: torch.device, make):
        if (key, dev) not in self._memo:
            self._memo[key, dev] = make(dev)
        return self._memo[key, dev]


def num_chips(mesh: DataMesh) -> int:
    """Distinct devices under the mesh's slots (slots may share one)."""
    return len(set(mesh.devices))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[DataMesh] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh: DataMesh):
    """Make ``mesh`` the active mesh of this thread for the block."""
    prev = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.mesh = prev


def active_mesh() -> Optional[DataMesh]:
    return _CTX.mesh


def slot_context(device: torch.device):
    """Run under ``device``: the current CUDA device for a card, nothing
    for the CPU — the counterpart of ``jax.default_device``."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
