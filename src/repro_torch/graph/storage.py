"""Graph substrate: edge lists -> CSR + dense (tile-padded) adjacency.

The tensorized counting engine contracts over the dense adjacency (optionally
padded to a multiple of ``TILE``; nothing on the counting path needs the
pad); CSR backs the sampling primitives
(APCT profiling) and host-side materialisation.  Vertex labels are kept as
per-label indicator vectors; N(v, l) of the paper's labelled CSR becomes
label-partitioned adjacency slices A ⊙ L_l.
"""
from __future__ import annotations

import numpy as np

TILE = 128


class Graph:
    """Undirected simple graph (dedup'd edges, no self loops)."""

    def __init__(self, num_vertices: int, edges: np.ndarray,
                 labels: np.ndarray | None = None):
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        # canonicalise: undirected, dedup, no self-loops
        u = np.minimum(edges[:, 0], edges[:, 1])
        v = np.maximum(edges[:, 0], edges[:, 1])
        keep = u != v
        uv = np.unique(np.stack([u[keep], v[keep]], 1), axis=0)
        self.n = int(num_vertices)
        self.edges = uv                                   # (E, 2) u < v
        self.m = len(uv)
        self.labels = (np.asarray(labels, np.int32)
                       if labels is not None else None)
        self.num_labels = (int(self.labels.max()) + 1
                           if self.labels is not None and self.n else 0)
        self._csr = None
        self._dense = None

    def invalidate_signature(self):
        """Drop every content-derived memo after an in-place mutation of
        ``edges``/``labels``: the ``_plan_signature`` content hash set by
        ``repro_torch.compiler.cache.graph_signature`` (the plan cache and the
        morph ``CountStore`` key exact results by it — a stale one would
        serve the pre-mutation graph's plans and counts) plus the CSR
        and dense-adjacency caches.  The evolving-graph path must call
        this on every applied delta."""
        if hasattr(self, "_plan_signature"):
            del self._plan_signature
        self._csr = None
        self._dense = None

    # -- CSR ---------------------------------------------------------------
    @property
    def csr(self):
        if self._csr is None:
            deg = np.zeros(self.n, np.int64)
            np.add.at(deg, self.edges[:, 0], 1)
            np.add.at(deg, self.edges[:, 1], 1)
            offs = np.zeros(self.n + 1, np.int64)
            np.cumsum(deg, out=offs[1:])
            nbrs = np.zeros(2 * self.m, np.int64)
            fill = offs[:-1].copy()
            for a, b in self.edges:
                nbrs[fill[a]] = b
                fill[a] += 1
                nbrs[fill[b]] = a
                fill[b] += 1
            for i in range(self.n):                       # sorted rows
                nbrs[offs[i]:offs[i + 1]].sort()
            self._csr = (offs, nbrs)
        return self._csr

    @property
    def degrees(self):
        offs, _ = self.csr
        return np.diff(offs)

    def neighbors(self, v: int) -> np.ndarray:
        offs, nbrs = self.csr
        return nbrs[offs[v]:offs[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(u)
        i = np.searchsorted(nb, v)
        return i < len(nb) and nb[i] == v

    # -- dense adjacency ----------------------------------------------------
    @property
    def n_padded(self) -> int:
        return max(TILE, ((self.n + TILE - 1) // TILE) * TILE)

    def dense_adjacency(self, dtype=np.float32, pad: bool = True) -> np.ndarray:
        key = (np.dtype(dtype), pad)
        if self._dense is None or self._dense[0] != key:
            n = self.n_padded if pad else self.n
            a = np.zeros((n, n), dtype)
            a[self.edges[:, 0], self.edges[:, 1]] = 1
            a[self.edges[:, 1], self.edges[:, 0]] = 1
            self._dense = (key, a)
        return self._dense[1]

    def label_indicators(self, dtype=np.float32, pad: bool = True) -> np.ndarray:
        """(num_labels, N) one-hot vertex-label indicators."""
        assert self.labels is not None
        n = self.n_padded if pad else self.n
        out = np.zeros((self.num_labels, n), dtype)
        out[self.labels, np.arange(self.n)] = 1
        return out

    # -- misc ----------------------------------------------------------------
    def subgraph_sample_edges(self, max_edges: int, seed: int = 0) -> "Graph":
        """Random edge sampling for the APCT profile graph (paper §4.2)."""
        if self.m <= max_edges:
            return self
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.m, size=max_edges, replace=False)
        return Graph(self.n, self.edges[idx],
                     self.labels if self.labels is not None else None)

    def __repr__(self):
        return f"Graph(n={self.n}, m={self.m}, labels={self.num_labels or None})"
