"""Block-sparse adjacency counting: the scalable mining backend.

Real graphs are sparse but locally dense; tiling the adjacency into
TILE x TILE blocks and keeping only non-empty tiles gives dense work at
the tile level while skipping the (vast) empty majority — the tensorised
analogue of the paper's observation that enumeration cost follows
pattern/graph structure, not n^k.

``BlockSparseAdjacency`` stores the non-empty tiles of A as f32 tensors on
the device (one stacked (T, tile, tile) tensor in the order of the sorted
tile keys i·nb + j, ``keys``; ``blocks[(i, j)]`` is a view into it); the
counting functions below (triangle / wedge-closing) iterate only over
non-empty tile triples, and each tile-level product is exactly the masked
matrix-product reduce of ``kernels.ops`` (K6, ``masked_matmul_reduce``).
``tile_lists`` turns the triples into K6's tile lists, so that the
kernel route counts every output tile in one call
(``kernels.matreduce.matreduce_tilelist``).  Occupancy statistics
quantify the skipped work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.graph.storage import Graph

TILE = 128
GROUP = 8       # output row tiles the kernel route's lists sweep together


class BlockSparseAdjacency:
    def __init__(self, g: Graph, tile: int = TILE, device=None):
        self.tile = tile
        self.n = g.n
        self.nb = (g.n + tile - 1) // tile
        dev = _device.resolve(device)
        e = np.asarray(g.edges, np.int64).reshape(-1, 2)
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        keys, inv = np.unique((src // tile) * self.nb + dst // tile,
                              return_inverse=True)
        tiles = torch.zeros((len(keys), tile, tile), dtype=torch.float32,
                            device=dev)
        idx = [torch.from_numpy(a).to(dev)
               for a in (inv.reshape(-1), src % tile, dst % tile)]
        tiles[idx[0], idx[1], idx[2]] = 1.0
        self.tiles = tiles
        self.keys = keys
        self.block_rows = torch.from_numpy(keys // self.nb).to(dev)
        self.blocks = {(int(k) // self.nb, int(k) % self.nb): tiles[t]
                       for t, k in enumerate(keys)}
        # row index: non-empty block columns per block row
        self.row_blocks: dict = {}
        for (i, j) in self.blocks:
            self.row_blocks.setdefault(i, []).append(j)
        for i in self.row_blocks:
            self.row_blocks[i].sort()

    @property
    def occupancy(self) -> float:
        return len(self.blocks) / float(self.nb * self.nb)

    def stats(self) -> dict:
        nnz = int(self.tiles.sum().item())
        return {"tiles": len(self.blocks), "grid": self.nb * self.nb,
                "occupancy": self.occupancy, "nnz": nnz,
                "tile_density": nnz / (len(self.blocks) * self.tile ** 2)}


def _tile_triples(bsa: BlockSparseAdjacency):
    """(output tile (i, j), its mask, [k with both A[i,k] and A[k,j]])."""
    for (i, j), mask in bsa.blocks.items():
        ks = [k for k in bsa.row_blocks.get(i, []) if (k, j) in bsa.blocks]
        if ks:
            yield i, j, mask, ks


def tile_lists(bsa: BlockSparseAdjacency, group: int = 1):
    """K6's tile lists of the triangle count, built with numpy from the
    tile keys: for each output tile (i, j) that ``_tile_triples`` yields
    the stack index of (i, j) (``out_idx``), and for each k of its list,
    in ascending order, the stack indices of A[i, k] (``lhs_idx``) and of
    the tile (j, k) (``rhs_idx``); ``k_ptr`` bounds each output tile's
    entries.  The product kernels take lhs @ rhsᵀ, and A[k, j] = tile
    (j, k)ᵀ because the adjacency is symmetric: ``BlockSparseAdjacency``
    inserts both (u, v) and (v, u) of every edge, so tile (j, k) is
    stored exactly when (k, j) is, as its transpose.

    Output tiles come in groups of ``group`` row tiles, column by column
    inside a group (``group=1``: ``_tile_triples``' order).  The card
    runs them in that order, so the output tiles in flight share their
    rhs tiles (j, k), and a group's lhs tiles stay in L2 while it sweeps
    its columns."""
    nb, keys = bsa.nb, np.asarray(bsa.keys, np.int64)
    rows, cols = keys // nb, keys % nb
    start = np.searchsorted(rows, np.arange(nb + 1))
    # every stored (i, k) beside every stored (k, j) of row k
    count = start[cols + 1] - start[cols]
    first = np.cumsum(count) - count
    a = np.repeat(np.arange(len(keys)), count)
    b = np.repeat(start[cols], count) + np.arange(count.sum()) \
        - np.repeat(first, count)
    # ... whose output tile (i, j) is stored
    want = rows[a] * nb + cols[b]
    out = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    hit = keys[out] == want
    a, b, out = a[hit], b[hit], out[hit]
    i, j = rows[out], cols[out]
    order = np.lexsort((cols[a], i, j, i // group))
    a, b, out = a[order], b[order], out[order]
    rhs_key = cols[b] * nb + rows[b]
    rhs = np.searchsorted(keys, rhs_key)
    if len(rhs) and (rhs.max() >= len(keys)
                     or not np.array_equal(keys[rhs], rhs_key)):
        raise ValueError("the tiles are not symmetric: a tile (k, j) is "
                         "stored without (j, k)")
    first = np.ones(len(out), bool)
    first[1:] = out[1:] != out[:-1]
    out_idx = out[first]
    k_ptr = np.concatenate([np.nonzero(first)[0], [len(out)]])
    return out_idx, k_ptr, a, rhs


def triangle_count_blocksparse(bsa: BlockSparseAdjacency,
                               use_kernel: bool = False) -> float:
    """Σ A ⊙ (A @ A) / 6 over non-empty tile triples only.

    For each non-empty output tile (i,j), stack the factor tiles A[i,k]
    and A[k,j] over the k where BOTH exist into one K dimension, then
    mask with A[i,j] and reduce — per tile exactly the masked
    matrix-product reduce.  ``use_kernel=True`` hands every output tile
    to ``kernels.matreduce.matreduce_tilelist`` at once (the lists of
    ``tile_lists``; K6's tile-list launches on a CUDA tensor, one host
    sync in all; its plain version on a CPU one); otherwise an f32
    product and an f64 sum per tile.
    """
    if use_kernel:
        from repro_torch.kernels import matreduce
        return matreduce.matreduce_tilelist(
            bsa.tiles, *tile_lists(bsa, GROUP)) / 6.0
    total = 0.0
    for i, j, mask, ks in _tile_triples(bsa):
        lhs = torch.cat([bsa.blocks[(i, k)] for k in ks], dim=1)
        rhs = torch.cat([bsa.blocks[(k, j)].T for k in ks], dim=1)
        total += float(((lhs @ rhs.T) * mask).sum(dtype=torch.float64))
    return total / 6.0


def wedge_count_blocksparse(bsa: BlockSparseAdjacency) -> float:
    """# 3-chains (edge-induced) = Σ_v deg(v)·(deg(v)-1)/2 computed from
    tile row sums — validates the block structure end-to-end."""
    rows = bsa.tiles.sum(dim=2, dtype=torch.float64)     # (T, tile)
    deg = torch.zeros((bsa.nb, bsa.tile), dtype=torch.float64,
                      device=rows.device)
    deg.index_add_(0, bsa.block_rows, rows)
    deg = deg.reshape(-1)[:bsa.n]
    return float((deg * (deg - 1) / 2).sum())


def dense_flops(n: int) -> float:
    return 2.0 * n ** 3


def blocksparse_flops(bsa: BlockSparseAdjacency) -> float:
    f = 0.0
    t = bsa.tile
    for _, _, _, ks in _tile_triples(bsa):
        f += 2.0 * len(ks) * t ** 3
    return f
