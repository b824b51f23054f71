"""Mesh-execution tier for the decomposition join: Σ_{e_c} Π_i M_i(e_c)
sharded over a 1-D ``("data",)`` mesh of device slots
(``distributed.meshes``).

Two layers, as in the reference package:

**Layer 1 — data-parallel plan execution** (``MeshExecutor``): the graph
and its compiled plan are shared; a step's requests fan out over the
slots, one plan read per slot (``map``), or a homogeneous batch of joins
runs as one f64 batch split over the slots (``join_batch``).  No
numerical change: each request runs the single-device path.

**Layer 2 — block-sharded factors** (``sharded_cutjoin*``): the join's
cut grid is split over cut axis 0.  Slot s holds rows ``[s·r, (s+1)·r)``
of every factor that carries axis 0, r = ⌈n / slots⌉ (the last slots may
hold fewer rows, or none); factors that miss axis 0 are replicated.  Each
slot calls the kernel tier's tile entry points (``kernels.matreduce``:
``prod_reduce_tiles``, ``prod_reduce_keep_tiles``, ``tri_reduce_tiles``,
``tri_reduce_keep_tiles``; on the card they launch K1–K4 and K4-keep) on
its slice with its global ``offsets`` ``(s·r, 0[, 0])``, so the
injectivity mask still compares global cut vertices.  The slots' f64
partials are summed in f64, in slot order, on slot 0's device (the
reference's ``psum``).  A keep join concatenates the slots' output slices
when the kept axis is the sharded one and sums their partial vectors
otherwise.  The |cut| = 1 join has no mask: it is column-sliced with no
offsets.

**Slices, not padded copies.**  The reference zero-pads axis-0 carriers
to the slots × tile multiple because its grid needs equal, tile-aligned
shards; the port's entry points take rectangular slices of any size, so a
slot's slice is a view of the factor (rows beyond n would be zero and add
nothing).  A slice keeps its factor's strides, so K3's and K4-keep's
entries, which are chosen by stride (``keep_entry``, ``tri_keep_entry``),
are the whole join's.  A factor may also arrive as the sharded
contraction's ``distributed.contract.Sliced`` row blocks: the slot rows
are the same, so slot s takes a view of the block slot s made and no row
block moves.  Where slots share a device, a replicated factor is one
tensor; a slot on another device receives its slice (and each replicated
factor) once per join.

**Exactness.**  The sharded kernel routes run only under the same
``exact_block`` guard as the single-device kernels, and the guard's bound
is global (the max over the whole factor dominates every slice's max).
Every f32 chunk partial is then an exact integer, every slot's f64 sum an
exact integer below 2^53, and integer f64 addition is associative: slot
count and summation order cannot change the result, which is bit-for-bit
equal to the single-device join.  With ``f64=True`` the |cut| = 1 join and
the pair keep join take the f64 instances of K1 and K3 on each slice, for
joins the f32 guard refuses and ``exact_f64`` admits; that bound is global
too (the whole reduced axis, the maxima over whole factors), so every
slot's partial and their sum stay exact integers.  The dense f64 routes
(``sharded_dense_join[_keep]``) are plain PyTorch, as the reference's are
plain XLA, and exact by the same argument: the lowering takes them only
for joins that neither bound admits, and on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed import contract as _contract
from repro_torch.distributed import meshes
from repro_torch.kernels import matreduce as _mr

# re-exported so callers need only this module
data_mesh = meshes.data_mesh
num_shards = meshes.num_shards
slot_ranges = meshes.slot_ranges

DEFAULT_BLOCK = 128          # the tile entry points' own default chunk


def _tensors(factors) -> list:
    return [F if isinstance(F, (torch.Tensor, _contract.Sliced))
            else torch.as_tensor(F) for F in factors]


def _extent(F) -> int:
    """Length of a factor's axis 0 (a ``Sliced`` one's data rows)."""
    return F.n if isinstance(F, _contract.Sliced) else F.shape[0]


def _whole(F, dev: torch.device) -> torch.Tensor:
    return _contract.gather(F, dev).to(dev)


def _slots(mesh, n: int):
    """(slot, device, start, stop) of every slot that holds rows."""
    for s, (start, stop) in enumerate(slot_ranges(n, num_shards(mesh))):
        if stop > start:
            yield s, mesh.devices[s], start, stop


def _shard(entry, factors, carries, n: int, mesh) -> list:
    """The slots' results of one sharded join: ``entry(ops, start, stop)``
    under each slot's device for every slot that holds rows ``[start,
    stop)`` of cut axis 0 (length ``n``).  ``ops`` holds those rows of each
    factor that carries axis 0 (``carries[i]``) — a view where the factor
    lies on the slot's device, the slot's own block of a ``Sliced`` factor
    with the same slot rows — and every other factor whole."""
    d = num_shards(mesh)
    rows = -(-max(n, 1) // d)
    replicas = meshes.Replicas()
    out = []
    for s, dev, a, b in _slots(mesh, n):
        ops = []
        for i, F in enumerate(factors):
            if not carries[i]:
                ops.append(replicas.get(i, dev,
                                        lambda dv, F=F: _whole(F, dv)))
            elif not isinstance(F, _contract.Sliced):
                ops.append(F[a:b].to(dev))
            elif len(F.parts) == d and F.rows == rows:
                ops.append(F.rows_of(s, b - a).to(dev))
            else:                    # another mesh's blocks: whole, once
                ops.append(replicas.get(
                    i, dev, lambda dv, F=F: _whole(F, dv))[a:b])
        with meshes.slot_context(dev):
            out.append(entry(ops, a, b))
    return out


def _slot_sum(parts, home: torch.device):
    """f64 sum of the slots' partials in slot order on ``home``."""
    total = None
    for part in parts:
        part = part.to(home)
        total = part if total is None else total + part
    return total


def _scalar(parts, mesh) -> float:
    return _slot_sum(parts, mesh.home).item() if parts else 0.0


def _keep_out(pieces, keep: int, home: torch.device) -> torch.Tensor:
    """A keep join's output from the slots' pieces: the kept axis is the
    sharded one (keep == 0) — concatenate the output slices — or not —
    sum the partial vectors."""
    if keep == 0:
        return torch.cat([p.to(home) for p in pieces])
    return _slot_sum(pieces, home)


# -- layer 2: block-sharded joins ---------------------------------------------------

def sharded_cutjoin(factors, *, mesh, distinct: bool = True,
                    block: Optional[int] = None, f64: bool = False) -> float:
    """|cut| <= 2 decomposition join sharded over cut axis 0 — the mesh
    analogue of ``ops.cutjoin_reduce``.  ``block`` must come from the
    ``exact_block`` guard: the sharded route inherits the single-device
    exactness contract and is only bit-for-bit under it.  ``f64`` (|cut| =
    1 only) takes K1's f64 instance, the analogue of
    ``ops.cutjoin_reduce_f64``, under the ``exact_f64`` bound instead."""
    block = block or DEFAULT_BLOCK
    fs = _tensors(factors)
    vec = fs[0].ndim == 1

    def entry(ops, a, b):
        # |cut| = 1 has no mask, so its column slices need no offsets
        return _mr.prod_reduce_tiles(ops, distinct=distinct, block=block,
                                     offsets=None if vec else (a, 0),
                                     f64=f64).sum()
    return _scalar(_shard(entry, fs, [True] * len(fs), _extent(fs[0]),
                          mesh), mesh)


def sharded_cutjoin3(factors, axes, *, n: int, mesh, distinct: bool = True,
                     block: Optional[int] = None) -> float:
    """|cut| = 3 decomposition join sharded over cut axis 0 — the mesh
    analogue of ``ops.cutjoin_reduce3``.  Axis-subset factors are sliced
    only when they carry axis 0, else replicated; each slot's join takes
    the route ``tri_route`` gives the factors' axes.  The same
    ``exact_block`` contract as ``sharded_cutjoin`` applies."""
    block = block or DEFAULT_BLOCK
    axes = [tuple(ax) for ax in axes]

    def entry(ops, a, b):
        return _mr.tri_reduce_tiles(ops, axes, n=(b - a, n, n),
                                    distinct=distinct, block=block,
                                    offsets=(a, 0, 0)).sum()
    return _scalar(_shard(entry, _tensors(factors),
                          [0 in ax for ax in axes], n, mesh), mesh)


def sharded_cutjoin_keep(factors, *, keep: int = 0, mesh,
                         distinct: bool = True, block: Optional[int] = None,
                         f64: bool = False) -> torch.Tensor:
    """Keep-axis |cut| = 2 join sharded over cut axis 0 — the mesh
    analogue of ``ops.cutjoin_reduce_keep``: an f64 vector on slot 0's
    device.  keep == 0 shards the output itself; keep == 1 shards the
    reduced axis and sums the slots' partial vectors.  Same ``exact_block``
    contract as the scalar routes; ``f64`` takes K3's f64 instance, the
    analogue of ``ops.cutjoin_reduce_keep_f64``, under ``exact_f64``."""
    if keep not in (0, 1):
        raise ValueError(f"keep={keep}: a pair join keeps axis 0 or 1")
    block = block or DEFAULT_BLOCK
    fs = _tensors(factors)

    def entry(ops, a, b):
        return _mr.prod_reduce_keep_tiles(ops, keep=keep, distinct=distinct,
                                          block=block, offsets=(a, 0),
                                          f64=f64).sum(0)
    return _keep_out(_shard(entry, fs, [True] * len(fs), _extent(fs[0]),
                            mesh), keep, mesh.home)


def sharded_cutjoin3_keep(factors, axes, *, keep: int, n: int, mesh,
                          distinct: bool = True,
                          block: Optional[int] = None) -> torch.Tensor:
    """Keep-axis |cut| = 3 join sharded over cut axis 0 — the mesh
    analogue of ``ops.cutjoin_reduce3_keep``: an f64 vector on slot 0's
    device.  keep == 0 concatenates the slots' output slices, any other
    kept axis sums their partial vectors."""
    if keep not in (0, 1, 2):
        raise ValueError(f"keep={keep}: a tri join keeps axis 0, 1 or 2")
    block = block or DEFAULT_BLOCK
    axes = [tuple(ax) for ax in axes]

    def entry(ops, a, b):
        return _mr.tri_reduce_keep_tiles(ops, axes, keep=keep,
                                         n=(b - a, n, n), distinct=distinct,
                                         block=block,
                                         offsets=(a, 0, 0)).sum(0)
    return _keep_out(_shard(entry, _tensors(factors),
                            [0 in ax for ax in axes], n, mesh),
                     keep, mesh.home)


def _dense_factors(Ms, k: int) -> list:
    Ms = [M.double() for M in _tensors(Ms)]
    if Ms[0].ndim != k:
        raise ValueError(f"{Ms[0].ndim}-D factors for |cut| = {k}")
    return Ms


def sharded_dense_join(Ms, k: int, *, mesh) -> float:
    """The f64 dense join (factors already expanded and the injectivity
    mask appended, as ``lowering._eval_cutjoin`` builds them) sharded over
    the first cut axis: per slot the product of its row slices, summed;
    the slots' sums added in slot order.  No f32 chunking, so no guard;
    f64 sums of integer counts are exact in any order, so this is
    bit-for-bit with the single-device dense route."""
    Ms = _dense_factors(Ms, k)
    return _scalar(_shard(
        lambda ops, a, b: torch.sum(torch.prod(torch.stack(ops), dim=0)),
        Ms, [True] * len(Ms), Ms[0].shape[0], mesh), mesh)


def sharded_dense_join_keep(Ms, k: int, *, keep: int, mesh) -> torch.Tensor:
    """The f64 dense keep-axis join (factors expanded and the injectivity
    mask appended, as ``lowering._eval_local`` builds them) sharded over
    cut axis 0 — the route of keep joins no bound admits under a mesh.
    keep == 0: each slot owns a slice of the output (concatenated);
    otherwise each slot's partial vector is summed.  Exact by the same
    argument as ``sharded_dense_join``."""
    if not 0 <= keep < k:
        raise ValueError(f"keep={keep} of a |cut| = {k} join")
    Ms = _dense_factors(Ms, k)
    red = tuple(a for a in range(k) if a != keep)
    return _keep_out(_shard(
        lambda ops, a, b: torch.sum(torch.prod(torch.stack(ops), dim=0),
                                    dim=red),
        Ms, [True] * len(Ms), Ms[0].shape[0], mesh), keep, mesh.home)


# -- layer 1: data-parallel plan execution ------------------------------------------

class MeshExecutor:
    """Layer-1 fan-out: the graph and compiled plans are shared, a step's
    requests spread over the ``data`` slots.

    ``map`` round-robins per-request thunks over the slots, each run
    under its slot's device (``meshes.slot_context``) — no numerical
    change, for any plan read.  ``join_batch`` evaluates a homogeneous
    batch of |cut| = 2 joins as one f64 batch split over the slots."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.devices = list(mesh.devices)

    def map(self, fn, items: Sequence):
        out = []
        for i, item in enumerate(items):
            dev = self.devices[i % len(self.devices)]
            with meshes.slot_context(dev):
                out.append(fn(item))
        obs.counter("mesh.map_requests", devices=len(self.devices),
                    value=len(items))
        return out

    def join_batch(self, stacks, *, distinct: bool = True) -> torch.Tensor:
        """Scalar pair joins: ``stacks[r]`` is one request's (k, n, n)
        factor stack (a (B, k, n, n) tensor or a sequence of arrays);
        returns the (B,) f64 counts on slot 0's device.  Each slot
        evaluates its ⌈B / slots⌉ requests in f64 dense arithmetic —
        product over factors, off-diagonal mask, sum — exact on integer
        counts, so equal to B serial guarded kernel joins."""
        home = self.mesh.home
        if isinstance(stacks, torch.Tensor):
            big = stacks.to(dtype=torch.float64)
        else:                    # one host stack, one transfer
            big = torch.as_tensor(np.asarray(stacks, np.float64),
                                  device=home)
        if big.ndim != 4:
            raise ValueError(f"join_batch takes (B, k, n, n) stacks: "
                             f"{tuple(big.shape)}")
        pieces = []
        for s, dev, a, b in _slots(self.mesh, big.shape[0]):
            with meshes.slot_context(dev):
                prod = torch.prod(big[a:b].to(dev), dim=1)
                if distinct:
                    i = torch.arange(prod.shape[1], device=dev)
                    prod[:, i, i] = 0.0
                pieces.append(prod.sum(dim=(1, 2)))
        if not pieces:
            return torch.zeros((0,), dtype=torch.float64, device=home)
        return torch.cat([p.to(home) for p in pieces])
