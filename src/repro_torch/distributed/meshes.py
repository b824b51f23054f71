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
the reference's API: no route of the mining tier reads the active mesh
(the lint's ``mesh-guard`` rule looks for ``sharding_ctx`` by name).

The LM side keeps the reference's logical-axis rules: parameters,
caches and inputs carry *logical* axis names ("embed", "heads", "batch",
...), resolved to mesh axes through a rules dict (``DEFAULT_RULES``
merged with a cell's own, as ``sharding_ctx(mesh, rules)`` merges them).
``spec_for`` gives a leaf's resolved spec: a tuple with one entry per
dim, a mesh-axis name, a tuple of names, or ``None`` (the content of
jax's ``PartitionSpec``), and ``shard_shape`` the per-device shape it
implies.  The resolver works on any mesh with a ``shape`` dict; the dry
run's meshes are device-free (``AbstractMesh``, made by
``launch.mesh``).  ``constrain`` (a sharding constraint on a live tensor),
resharding restores and the expert-parallel MoE wait for ROADMAP queue
1, item 13f.
"""
from __future__ import annotations

import contextlib
import math
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


@dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and their sizes, the counterpart of
    jax's abstract mesh.  Rules resolve against it; nothing runs on it."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for "
                             f"{self.axis_names} axes")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def num_chips(mesh) -> int:
    """Distinct devices under a ``DataMesh``'s slots (slots may share one);
    an ``AbstractMesh``'s size."""
    if isinstance(mesh, AbstractMesh):
        return mesh.size
    return len(set(mesh.devices))


# Baseline logical->mesh rules (single- and multi-pod share names; "pod" is
# simply absent from the single-pod mesh and gets dropped by the resolver).
#   embed   : FSDP axis of weight matrices (d_model rows)  -> data
#   heads/kv/mlp/vocab/experts : tensor-parallel columns    -> model
#   batch   : data parallel                                 -> pod+data
#   seq     : sequence parallel (long-context decode only)  -> None here
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP weight sharding
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_embed": (),
    "expert_mlp": ("data",),
    "seq": (),
    "kv_seq": (),                # decode KV-cache sequence axis
    "layers": (),
    "head_dim": (),
    "state": (),
    "conv": (),
    "lora": (),
    "img": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` the active mesh of this thread for the block, with
    ``rules`` merged over ``DEFAULT_RULES`` as its logical-axis rules."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def current_rules() -> dict:
    return dict(_CTX.rules or DEFAULT_RULES)


def _resolve_dim(name: Optional[str], dim: int, mesh, rules: dict,
                 used: set):
    """Mesh axes for one logical dim: drop axes that don't divide the dim
    or were already consumed by an earlier dim of the same spec."""
    if name is None:
        return None
    want = rules.get(name, ())
    if isinstance(want, str):
        want = (want,)
    got = []
    prod = 1
    for ax in want:
        if ax not in mesh.shape or ax in used:
            continue
        sz = mesh.shape[ax]
        if dim % (prod * sz) == 0:
            got.append(ax)
            prod *= sz
    used.update(got)
    if not got:
        return None
    return tuple(got) if len(got) > 1 else got[0]


def spec_for(axes: tuple, shape: tuple, mesh, rules: dict) -> tuple:
    """The resolved spec of a leaf: one entry per dim (see the module
    docstring)."""
    assert len(axes) == len(shape), (axes, shape)
    used: set = set()
    return tuple(_resolve_dim(a, d, mesh, rules, used)
                 for a, d in zip(axes, shape))


def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The per-device shape of a leaf of ``shape`` laid out by ``spec``:
    each dim divided by the sizes of the mesh axes it is split over."""
    out = []
    for dim, entry in zip(shape, spec):
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        parts = math.prod(mesh.shape[ax] for ax in names)
        assert dim % parts == 0, (shape, spec)
        out.append(dim // parts)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (jax's ``NamedSharding``)."""
    mesh: object
    spec: tuple


def sharding_for(axes: tuple, shape: tuple, mesh=None,
                 rules: Optional[dict] = None) -> Optional[NamedSharding]:
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(axes, shape, mesh, rules))


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(
        isinstance(e, (str, type(None))) for e in t)


def tree_shardings(axes_tree, shapes_tree, mesh=None, rules=None):
    """Map (axes, shapes) trees of dicts and lists to ``NamedSharding``s.

    ``shapes_tree`` leaves may be shape tuples or anything with ``.shape``
    (tensors, meta tensors included).
    """
    mesh = mesh or _CTX.mesh
    rules = dict(DEFAULT_RULES, **(rules or _CTX.rules or {}))

    def walk(a, s):
        if _is_axes(a):
            shape = tuple(s.shape if hasattr(s, "shape") else s)
            return NamedSharding(mesh, spec_for(a, shape, mesh, rules))
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        if isinstance(a, list):
            assert len(a) == len(s), (len(a), len(s))
            return [walk(x, y) for x, y in zip(a, s)]
        raise TypeError(f"not an axes tree: {type(a).__name__}")

    return walk(axes_tree, shapes_tree)


def slot_context(device: torch.device):
    """Run under ``device``: the current CUDA device for a card, nothing
    for the CPU — the counterpart of ``jax.default_device``."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
