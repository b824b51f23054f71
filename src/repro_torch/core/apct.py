"""Approximate Pattern Count Table (paper §4.2).

Dataset profiling: random-edge-sample the input graph down to E' edges,
then estimate the count of every connected pattern up to 5 vertices with
ASAP-style neighbour sampling (Fig 21, generalised to arbitrary patterns
by sampling a BFS spanning tree and checking the non-tree edges).  The
estimator is unbiased for injective-tuple counts; frequent patterns
converge fast, infrequent ones are under-estimated — which is exactly the
property the cost model needs (frequent subpatterns are the expensive
contractions).

Misses are computed on demand and inserted (paper: "generated during cost
estimation").
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import Pattern
from repro_torch.graph.storage import Graph


def _bfs_tree(p: Pattern):
    """(order, parent-in-order index) with each vertex adjacent to an
    earlier one; pattern must be connected."""
    a = p.adj()
    order = [0]
    parent = {0: -1}
    while len(order) < p.n:
        for v in range(p.n):
            if v in parent:
                continue
            ns = [u for u in a[v] if u in parent]
            if ns:
                order.append(v)
                parent[v] = ns[0]
                break
    return order, parent


def estimate_inj(g: Graph, p: Pattern, num_samples: int = 32_768,
                 seed: int = 0) -> float:
    """Unbiased estimate of injective-tuple count of p in g (vectorised
    neighbour sampling)."""
    if g.m == 0 or p.n > g.n:
        return 0.0
    rng = np.random.default_rng(seed)
    offs, nbrs = g.csr
    deg = np.diff(offs)
    order, parent = _bfs_tree(p)

    S = num_samples
    verts = np.zeros((p.n, S), np.int64)
    weight = np.full(S, float(g.n))
    valid = np.ones(S, bool)

    verts[order[0]] = rng.integers(0, g.n, S)
    for v in order[1:]:
        par = verts[parent[v]]
        d = deg[par]
        ok = d > 0
        valid &= ok
        d_safe = np.maximum(d, 1)
        pick = (rng.random(S) * d_safe).astype(np.int64)
        verts[v] = nbrs[np.minimum(offs[par] + pick, len(nbrs) - 1)]
        weight *= d_safe
    # injectivity
    for i in range(p.n):
        for j in range(i + 1, p.n):
            valid &= verts[i] != verts[j]
    # non-tree edges
    tree = {(min(v, parent[v]), max(v, parent[v])) for v in order[1:]}
    for (u, v) in p.edges - tree:
        a, b = verts[u], verts[v]
        lo, hi = offs[a], offs[a + 1]
        # vectorised membership: searchsorted within each row
        pos = np.array([np.searchsorted(nbrs[l:h], x)
                        for l, h, x in zip(lo, hi, b)])
        found = (lo + pos < hi) & (nbrs[np.minimum(lo + pos, len(nbrs) - 1)] == b)
        valid &= found
    # labels
    if g.labels is not None and p.labels is not None:
        for v in range(p.n):
            valid &= g.labels[verts[v]] == np.array(p.labels[v])
    return float(np.sum(weight * valid) / S)


class APCT:
    """The table: canonical pattern -> approximate injective-tuple count."""

    def __init__(self, graph: Graph, max_profile_edges: int = 100_000,
                 num_samples: int = 32_768, max_size: int = 5, seed: int = 0):
        self.num_samples = num_samples
        self.seed = seed
        self.profile_graph = graph.subgraph_sample_edges(max_profile_edges,
                                                         seed=seed)
        self.table: dict = {}
        self.misses = 0
        t0 = time.perf_counter()
        for k in range(2, max_size + 1):
            for p in motif_patterns(k):
                self.table[p] = estimate_inj(self.profile_graph, p,
                                             num_samples, seed)
        self.profile_time_s = time.perf_counter() - t0

    def query(self, p: Pattern) -> float:
        c = p.canonical()
        # labelled queries fall back to the unlabelled skeleton (the paper
        # searches decompositions on the unlabelled version, footnote 6)
        if c.labels is not None:
            c = Pattern(c.n, c.edges).canonical()
        if c not in self.table:
            self.misses += 1
            self.table[c] = estimate_inj(self.profile_graph, c,
                                         self.num_samples, self.seed)
        return self.table[c]
