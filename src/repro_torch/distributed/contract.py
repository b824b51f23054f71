"""Sharded hom contractions: bucket elimination with the adjacency held as
row blocks over the slots of a 1-D ``("data",)`` mesh.

``sharded_hom`` mirrors ``core.homomorphism.hom_count`` step for step —
the same factors, the same elimination order, the same ``PlanTooWide``
cap — but the dense adjacency never exists as one n x n tensor:

* ``adjacency_blocks`` builds each slot's row block straight from the
  graph's CSR on the slot's device (``Sliced``);
* ``label_blocks`` does the same for the one-hot label indicators, split
  over the vertex axis, so a labelled pattern's unary factors arrive
  already sliced;
* each elimination step splits the eliminated vertex's axis over the
  slots: every involved factor carries it (the adjacency is symmetric, so
  a factor carrying the vertex on its column axis is relabelled
  ``(u, v) -> (v, u)`` and served from the row blocks as they are), each
  slot contracts its slice (``homomorphism._pairwise_einsum``) on its
  device, and the slots' f64 partials are summed in slot order on slot
  0's device — the reference's ``psum``.  The intermediate is one tensor
  there, and later steps read their slices of it as views;
* the final free-axis step splits its *output* over ``free[0]`` (cut axis
  0): each slot computes its own row block, and the blocks stay where they
  were made, as a ``Sliced`` tensor.  Its slot rows are those of
  ``distributed.cutjoin``, so the join tier's slot s reads, as a view, the
  block slot s made: no row block moves between slots and none is copied.
  ``gather`` makes the whole tensor, for callers that ask for one
  (``contract.slice_gathers`` counts it).  An adjacency factor between two
  later free vertices is the one input that must be whole inside that
  step; ``contract.finish_gathers`` counts it.

**Exactness.**  Every intermediate is a sum of products of 0/1 adjacency
entries and non-negative integer unaries — integers, exact in f64 below
2^53, and integer addition is associative — so slot count, summation
order and zero padding cannot change a value: the sharded route is
bit-for-bit equal to ``hom_count``.

**Padding.**  Vertex axes run over ``Rp = ⌈n / d⌉ · d``.  The adjacency
blocks and unary vectors are zero outside ``[0, n)``, so intermediates
stay zero in every padded region.  When d divides n there is no padding;
otherwise a gathered tensor is trimmed to n on every axis, which
``contract.trim_gathers`` counts, as the reference does.  A ``Sliced``
result needs no trim: a slot's view stops at n on every axis.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import homomorphism as H
from repro_torch.distributed import meshes

_F64 = torch.float64


class Sliced(NamedTuple):
    """A tensor held as one row block per mesh slot: ``parts[s]`` is rows
    ``[s·rows, (s+1)·rows)`` on slot s's device.  Every axis runs over the
    padded extent ``len(parts) · rows``; its first ``n`` indices hold the
    data, the rest are zero."""
    parts: tuple
    rows: int
    n: int

    @property
    def shape(self) -> tuple:
        """The padded shape."""
        return (self.rows * len(self.parts),) + tuple(self.parts[0].shape[1:])

    @property
    def extent(self) -> tuple:
        """The shape of the data: n on every axis."""
        return (self.n,) * self.parts[0].ndim

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def is_cuda(self) -> bool:
        return self.parts[0].is_cuda

    def whole(self, device: torch.device) -> torch.Tensor:
        """The padded tensor on ``device`` (a copy of every block)."""
        return torch.cat([p.to(device) for p in self.parts])

    def rows_of(self, s: int, count: int) -> torch.Tensor:
        """The first ``count`` rows of slot s's block, cut to n on every
        other axis: a view."""
        part = self.parts[s]
        return part[(slice(0, count),) + (slice(0, self.n),) * (part.ndim - 1)]

    def abs_max(self, device: torch.device) -> torch.Tensor:
        """max |value| over the data, a 0-d tensor on ``device`` (the zero
        padding cannot raise it)."""
        return torch.stack([p.abs().max().to(device) for p in self.parts
                            if p.numel()]).max()


def gather(value, device: torch.device):
    """``value`` as one tensor: a ``Sliced`` one copied block by block to
    ``device`` and cut to its extent (``contract.slice_gathers`` counts
    it); anything else as it is."""
    if not isinstance(value, Sliced):
        return value
    obs.counter("contract.slice_gathers")
    return _trim(value.whole(device), value.n)


def padded_rows(n: int, mesh) -> int:
    """Global vertex-axis extent of the sharded buffers: n rounded up to
    the slot multiple (== n exactly when the mesh divides n)."""
    d = meshes.num_shards(mesh)
    return -(-max(n, 1) // d) * d


def adjacency_blocks(graph, mesh, dtype=_F64) -> Sliced:
    """The (Rp, Rp) adjacency as row blocks, each built on its slot's
    device from that slot's span of the CSR — the host holds index arrays
    of one block at a time and no n x n array exists anywhere."""
    n, d = graph.n, meshes.num_shards(mesh)
    Rp = padded_rows(n, mesh)
    rows = Rp // d
    offs, nbrs = graph.csr
    parts = []
    for dev, (start, stop) in zip(mesh.devices, meshes.slot_ranges(n, d)):
        block = torch.zeros((rows, Rp), dtype=dtype, device=dev)
        r = np.repeat(np.arange(stop - start),
                      np.diff(offs[start:stop + 1]))
        c = nbrs[offs[start]:offs[stop]]
        if len(c):
            block[torch.from_numpy(r).to(dev),
                  torch.from_numpy(np.asarray(c, np.int64)).to(dev)] = 1
        parts.append(block)
    return Sliced(tuple(parts), rows, n)


def label_blocks(graph, mesh, dtype=_F64) -> tuple:
    """Per slot an (num_labels, rows) one-hot block over that slot's
    vertices: row l of every block together is the label-l unary factor,
    already sliced along the vertex axis every elimination step splits."""
    if graph.labels is None:
        raise ValueError("label_blocks needs a labelled graph")
    n, L, d = graph.n, graph.num_labels, meshes.num_shards(mesh)
    rows = padded_rows(n, mesh) // d
    labels = np.asarray(graph.labels, np.int64)
    parts = []
    for dev, (start, stop) in zip(mesh.devices, meshes.slot_ranges(n, d)):
        block = torch.zeros((L, rows), dtype=dtype, device=dev)
        if stop > start:
            block[torch.from_numpy(labels[start:stop]).to(dev),
                  torch.arange(stop - start, device=dev)] = 1
        parts.append(block)
    return tuple(parts)


def unary_slices(blocks: tuple, label: int, n: int) -> Sliced:
    """The label-``label`` unary factor from ``label_blocks`` (zero for a
    label outside the alphabet)."""
    L = blocks[0].shape[0]
    if 0 <= label < L:
        parts = tuple(b[label] for b in blocks)
    else:
        parts = tuple(torch.zeros_like(b[0]) for b in blocks)
    return Sliced(parts, blocks[0].shape[1], n)


def _collective_contract(involved, out_idx, shard_index, *, mesh, n,
                         budget, out_sharded):
    """einsum the (indices, value, is_adjacency) factors down to
    ``out_idx`` with ``shard_index``'s axis split over the slots in every
    factor that carries it — the sharded analogue of
    ``homomorphism._contract`` (whose budget chunking the slot split
    replaces).  Elimination steps return the slots' summed partials on
    slot 0's device; the free-output step returns its row blocks as a
    ``Sliced`` tensor.  A ``Sliced`` operand that must be whole in a step
    is copied once per slot device."""
    out_elems = n ** len(out_idx)
    if out_elems > 4 * budget:
        raise H.PlanTooWide(f"intermediate of {out_elems:.2e} elements "
                            f"(indices {tuple(out_idx)}, n={n}) exceeds "
                            f"the cap")
    prepared, gathers = [], 0
    for s, value, is_adj in involved:
        if shard_index in s:
            if is_adj and s.index(shard_index) == 1:
                # A is symmetric: relabel (u, v) -> (v, u) so the split
                # index is served from the row blocks as they are
                s = (s[1], s[0])
            ax = s.index(shard_index)
        else:
            ax = None
            if is_adj:
                gathers += 1             # the whole adjacency in this step
        prepared.append((tuple(s), value, ax))
    if gathers:
        obs.counter("contract.finish_gathers", value=gathers)
    idx_sets = [s for s, _, _ in prepared]
    d = meshes.num_shards(mesh)
    Rp = padded_rows(n, mesh)
    rows = Rp // d
    replicas = meshes.Replicas()
    home = mesh.home
    blocks, total = [], None
    for slot, dev in enumerate(mesh.devices):
        start = slot * rows
        ops = []
        for i, (s, value, ax) in enumerate(prepared):
            if isinstance(value, Sliced):
                if ax is None:
                    ops.append(replicas.get(i, dev, value.whole))
                else:                    # split index on axis 0 (relabelled)
                    ops.append(value.parts[slot].to(dev))
            elif ax is None:
                ops.append(replicas.get(i, dev, value.to))
            else:
                ops.append(value.narrow(ax, start, rows).to(dev))
        with meshes.slot_context(dev):
            part = H._pairwise_einsum(idx_sets, ops, tuple(out_idx))
        if out_sharded:
            blocks.append(part)
        else:
            part = part.to(home)
            total = part if total is None else total + part
    if out_sharded:
        return Sliced(tuple(blocks), rows, n)
    return total


def _split(vec, mesh, n: int) -> Sliced:
    """An (Rp,) vector as slot blocks: views of it on each slot's device
    (one copy per slot on another device); a ``Sliced`` one as it is."""
    if isinstance(vec, Sliced):
        return vec
    rows = padded_rows(n, mesh) // meshes.num_shards(mesh)
    return Sliced(tuple(vec.narrow(0, s * rows, rows).to(dev)
                        for s, dev in enumerate(mesh.devices)), rows, n)


def _trim(arr: torch.Tensor, n: int) -> torch.Tensor:
    """Rp -> n on every axis: nothing to do when the mesh divides n;
    otherwise a view of the first n rows of every axis, which the counter
    makes visible."""
    if not arr.ndim or arr.shape[0] == n:
        return arr
    obs.counter("contract.trim_gathers")
    return arr[(slice(0, n),) * arr.ndim]


def sharded_hom(p, blocks: Sliced, *, mesh, n: int,
                order: Optional[tuple] = None, free: tuple = (),
                unary: Optional[dict] = None, budget: int = 1 << 27,
                sliced: bool = False):
    """# homomorphisms of ``p`` into the graph whose adjacency row blocks
    are ``blocks`` (from ``adjacency_blocks``), with ``free`` pattern
    vertices kept as output axes — the sliced mirror of
    ``homomorphism.hom_count``, bit-for-bit equal to it.

    ``unary`` maps pattern vertices to (Rp,) factors: ``Sliced`` ones
    (``unary_slices``) or whole tensors zero beyond ``n``.  A scalar count
    returns a 0-d f64 tensor on slot 0's device; a free count the
    (n,)*len(free) tensor there, or with ``sliced`` its row blocks where
    the slots made them (a ``Sliced``; see the module docstring)."""
    free = tuple(free)
    home = mesh.home
    Rp = padded_rows(n, mesh)

    def ones_vec():
        return (torch.arange(Rp, device=home) < n).to(_F64)

    def whole(value):
        return value.whole(home) if isinstance(value, Sliced) else value

    if p.n == 1:
        vec = (unary or {}).get(0)
        if sliced and free == (0,):
            return _split(ones_vec() if vec is None else vec, mesh, n)
        vec = ones_vec() if vec is None else whole(vec)
        return _trim(vec, n) if free == (0,) else torch.sum(vec)

    factors = []                    # (index tuple, value, is_adjacency)
    for (u, v) in sorted(p.edges):
        factors.append(((u, v), blocks, True))
    if unary:
        for v, vec in unary.items():
            factors.append(((v,), vec, False))
    covered = set()
    for s, _, _ in factors:
        covered.update(s)
    for v in range(p.n):                          # isolated vertices
        if v not in covered:
            factors.append(((v,), ones_vec(), False))

    order = order or H.greedy_plan(p, free)
    for v in order:
        if v in free:
            continue
        involved = [f for f in factors if v in f[0]]
        rest = [f for f in factors if v not in f[0]]
        out_idx = tuple(sorted({i for s, _, _ in involved for i in s}
                               - {v}))
        arr = _collective_contract(involved, out_idx, v, mesh=mesh, n=n,
                                   budget=budget, out_sharded=False)
        factors = rest + [(out_idx, arr, False)]

    if not free:
        total = torch.ones((), dtype=_F64, device=home)
        for _, a, _ in factors:
            a = whole(a)
            total = total * (a if a.ndim == 0 else torch.sum(a))
        return total
    out = _collective_contract(factors, free, free[0], mesh=mesh, n=n,
                               budget=budget, out_sharded=True)
    return out if sliced else gather(out, home)
