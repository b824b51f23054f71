"""Block-sparse adjacency counting: the scalable mining backend.

Real graphs are sparse but locally dense; tiling the adjacency into
TILE x TILE blocks and keeping only non-empty tiles gives dense work at
the tile level while skipping the (vast) empty majority — the tensorised
analogue of the paper's observation that enumeration cost follows
pattern/graph structure, not n^k.

``BlockSparseAdjacency`` stores the non-empty tiles of A as f32 tensors on
the device (one stacked (T, tile, tile) tensor; ``blocks[(i, j)]`` is a
view into it); the counting functions below (triangle / wedge-closing)
iterate only over non-empty tile triples, and each tile-level product is
exactly the masked matrix-product reduce of ``kernels.ops`` (K6,
``masked_matmul_reduce``).  Occupancy statistics quantify the skipped
work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.graph.storage import Graph

TILE = 128


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


def triangle_count_blocksparse(bsa: BlockSparseAdjacency,
                               use_kernel: bool = False) -> float:
    """Σ A ⊙ (A @ A) / 6 over non-empty tile triples only.

    For each non-empty output tile (i,j), stack the factor tiles A[i,k]
    and A[k,j] over the k where BOTH exist into one K dimension, then
    mask with A[i,j] and reduce — per tile exactly the masked
    matrix-product reduce.  ``use_kernel=True`` takes
    ``ops.masked_matmul_reduce`` (K6 on a CUDA tensor, its plain version
    on a CPU one); otherwise an f32 product and an f64 sum.
    """
    from repro_torch.kernels import ops
    total = 0.0
    for i, j, mask, ks in _tile_triples(bsa):
        lhs = torch.cat([bsa.blocks[(i, k)] for k in ks], dim=1)
        rhs = torch.cat([bsa.blocks[(k, j)].T for k in ks], dim=1)
        if use_kernel:
            total += ops.masked_matmul_reduce(lhs, rhs, mask)
        else:
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
