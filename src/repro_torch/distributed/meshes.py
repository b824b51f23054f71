"""Meshes of device slots in one process, and the logical-axis rules.

A ``DataMesh`` is an ordered grid of device slots with named axes: the
graph-mining tier's execution mesh is its 1-D ``("data",)`` form, the LM
side's ``("data", "model")`` (or ``("pod", "data", "model")``) grids.

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
(the lint's ``mesh-guard`` rule looks for ``sharding_ctx`` by name); the
LM side's expert-parallel MoE does (``models.moe``).

The LM side keeps the reference's logical-axis rules: parameters,
caches and inputs carry *logical* axis names ("embed", "heads", "batch",
...), resolved to mesh axes through a rules dict (``DEFAULT_RULES``
merged with a cell's own, as ``sharding_ctx(mesh, rules)`` merges them).
``spec_for`` gives a leaf's resolved spec: a tuple with one entry per
dim, a mesh-axis name, a tuple of names, or ``None`` (the content of
jax's ``PartitionSpec``), and ``shard_shape`` the per-device shape it
implies.  The resolver works on any mesh with a ``shape`` dict; the dry
run's meshes are device-free (``AbstractMesh``), a live one is a
``DataMesh`` (both made by ``launch.mesh.make_host_mesh``).
``constrain(x, *axes)`` resolves x's spec under the active mesh as the
reference's does (its rank checked) and returns x: one process holds the
whole tensor, so the pin only records the layout the reference asks for.
While the dry run traces a step (``launch.dryrun.trace``), a *recorder*
is active: ``constrain`` then reports x and its resolved spec to it (and
the gradient's, in the backward, as ``with_sharding_constraint``'s
transpose does), and ``pin``, ``exchange`` and ``slot_local`` tell it
what the expert-parallel MoE's slot axis is and what its exchanges move.
Without a recorder each of them returns its argument and does nothing.
``place`` lays a whole tensor out on a live mesh as a ``ShardedTensor``,
one shard per slot (slots that share a device get views of one tensor);
``train.checkpoint.restore(shardings=)`` and
``train.fault_tolerance.elastic_reshard`` restore onto it.
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
    """An ordered grid of device slots: ``devices`` in row-major order
    over ``axis_sizes`` (the order of the reference's ``mesh.devices``
    flattened), named by ``axis_names``.  The default is the 1-D
    ``("data",)`` mesh over all the slots."""
    devices: tuple
    axis_names: tuple = (AXIS,)
    axis_sizes: Optional[tuple] = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        if self.axis_sizes is None:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if len(self.axis_sizes) != len(self.axis_names) or \
                math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"{len(self.devices)} slots over axes "
                             f"{self.axis_names} of sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

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


def slot_mesh(shape: tuple, axes: tuple, device) -> DataMesh:
    """A ``DataMesh`` of ``shape`` over ``axes`` whose slots all lie on
    ``device`` (the card, or the CPU), as the reference's tests force host
    devices."""
    dev = _normalised(_device.resolve(device))
    return DataMesh((dev,) * math.prod(shape), tuple(axes), tuple(shape))


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
        self.recorder = None


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


def active_ctx() -> tuple:
    """This thread's (mesh, rules, recorder), for ``under_ctx`` to set
    again."""
    return _CTX.mesh, _CTX.rules, _CTX.recorder


@contextlib.contextmanager
def under_ctx(ctx: tuple):
    """Run the block under a (mesh, rules, recorder) triple from
    ``active_ctx``: a layer recomputed in the backward (remat) runs under
    the mesh and recorder its forward ran under, wherever the backward is
    called."""
    prev = active_ctx()
    _CTX.mesh, _CTX.rules, _CTX.recorder = ctx
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.recorder = prev


@contextlib.contextmanager
def recording(recorder):
    """Make ``recorder`` this thread's recorder for the block (the dry
    run's meter, ``launch.dryrun.trace``)."""
    prev = _CTX.recorder
    _CTX.recorder = recorder
    try:
        yield
    finally:
        _CTX.recorder = prev


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
        parts = math.prod(mesh.shape[ax] for ax in entry_axes(entry))
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


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    under an active mesh, x's spec is resolved by ``sharding_for`` (which
    checks that ``axes`` name every dim); x is returned as it is, whole,
    or, under a recorder, as ``pin`` returns it.  Nothing is done without
    a mesh."""
    if _CTX.mesh is None:
        return x
    s = sharding_for(tuple(axes), tuple(x.shape))
    return pin(x, s.spec)


class _Pin(torch.autograd.Function):
    """Identity whose backward reports the gradient at the same spec."""

    @staticmethod
    def forward(ctx, x, spec, rec):
        ctx.spec, ctx.rec = spec, rec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rec.pin(g, ctx.spec)
        return g, None, None


class _Exchange(torch.autograd.Function):
    """Identity whose backward reports the transposed exchange: the
    gradient goes back to the input's layout."""

    @staticmethod
    def forward(ctx, x, moved, rec):
        ctx.rec, ctx.moved = rec, moved
        ctx.back = rec.dims_of(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rec.exchange(g, ctx.back, ctx.moved, transpose=True)
        return g, None, None


def pin(x, spec: tuple):
    """Under a recorder, x laid out at the resolved ``spec``: the recorder
    prices the move from x's layout (a slice is free; a gather, or a
    pending sum settled, is a collective) and the gradient's move back in
    the backward.  Otherwise x itself."""
    rec = _CTX.recorder
    if rec is None:
        return x
    y = _Pin.apply(x, spec, rec)
    rec.pin(y, spec)
    return y


def exchange(x, spec: tuple, moved: list):
    """Under a recorder, x laid out at ``spec`` by the collectives
    ``moved`` ((op, per-device result bytes, group) each), which the
    caller computed from its shapes: the recorder records them (and their
    transposes in the backward) and prices nothing else.  Otherwise x
    itself.  The expert-parallel MoE's exchanges over its slot axis."""
    rec = _CTX.recorder
    if rec is None:
        return x
    y = _Exchange.apply(x, moved, rec)
    rec.exchange(y, rec.dims(spec), moved)
    return y


def slot_local(index):
    """Under a recorder, mark ``index`` as holding each slot's indices into
    that slot's own rows, so that gathering and scattering by it along a
    dim split over the slots moves nothing between devices."""
    if _CTX.recorder is not None:
        _CTX.recorder.slot_local(index)
    return index


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


def entry_axes(entry) -> tuple:
    """The mesh axes one entry of a resolved spec names."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def shard_slices(shape: tuple, spec: tuple, mesh, slot: int) -> tuple:
    """The slices of a leaf of ``shape`` that slot ``slot`` holds under
    ``spec``: a dim split over mesh axes (a, b, ...) is cut into
    size(a)·size(b)·... blocks, the block index taken with a as its major
    digit, as jax lays out a ``PartitionSpec`` entry that names a tuple."""
    coord = dict(zip(mesh.axis_names, _unravel(slot, mesh.axis_sizes)))
    per = shard_shape(shape, spec, mesh)
    out = []
    for entry, n in zip(spec, per):
        block = 0
        for ax in entry_axes(entry):
            block = block * mesh.shape[ax] + coord[ax]
        out.append(slice(block * n, (block + 1) * n))
    return tuple(out)


def _unravel(index: int, sizes: tuple) -> tuple:
    coord = []
    for n in reversed(sizes):
        coord.append(index % n)
        index //= n
    return tuple(reversed(coord))


@dataclass(frozen=True)
class ShardedTensor:
    """A leaf laid out on a live ``DataMesh``: ``shards[s]`` is slot s's
    block (``shard_slices``) on slot s's device.  Slots that share a
    device hold views of one tensor there; a slot alone on its device
    holds a copy of its block alone."""
    sharding: NamedSharding
    shape: tuple
    shards: tuple

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self) -> torch.Tensor:
        """The whole leaf on slot 0's device, each block read from its
        slot's shard."""
        mesh = self.mesh
        out = torch.empty(self.shape, dtype=self.dtype, device=mesh.home)
        for slot, shard in enumerate(self.shards):
            out[shard_slices(self.shape, self.spec, mesh, slot)] = \
                shard.to(mesh.home)
        return out


def place(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` laid out by ``sharding`` on its live mesh: on each device
    that holds several slots, x is copied there once and those slots take
    views of it; a slot alone on its device gets a copy of its block."""
    mesh = sharding.mesh
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"place needs a live DataMesh, not "
                        f"{type(mesh).__name__}")
    shape = tuple(x.shape)
    slots_on: dict = {}
    for slot, dev in enumerate(mesh.devices):
        slots_on.setdefault(dev, []).append(slot)
    shards: list = [None] * mesh.size
    for dev, slots in slots_on.items():
        whole = x.to(dev) if len(slots) > 1 else x
        for slot in slots:
            block = whole[shard_slices(shape, sharding.spec, mesh, slot)]
            shards[slot] = block if len(slots) > 1 else \
                block.to(dev, copy=True).contiguous()
    return ShardedTensor(sharding, shape, tuple(shards))


def slot_context(device: torch.device):
    """Run under ``device``: the current CUDA device for a card, nothing
    for the CPU — the counterpart of ``jax.default_device``."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
