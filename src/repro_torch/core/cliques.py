"""Specialised clique counting (degeneracy-ordered enumeration).

Dense tensor contraction of K_k needs an N^(k-2) intermediate — exactly
the high-treewidth regime the paper's decomposition cannot help with
(cliques have no cutting set, §2.4 footnote).  The paper's observation is
that clique counting is cheap by *ordered enumeration*; we implement that
path on the host CSR (degeneracy order + out-neighbour intersections) and
route complete patterns to it.  Also provides the pseudo-clique counter
(K_k minus one edge, vertex-induced) used by the PC application.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.storage import Graph


def degeneracy_order(g: Graph) -> np.ndarray:
    offs, nbrs = g.csr
    deg = np.diff(offs).astype(np.int64)
    removed = np.zeros(g.n, bool)
    order = np.empty(g.n, np.int64)
    # simple bucketed peeling
    for i in range(g.n):
        v = int(np.argmin(np.where(removed, np.iinfo(np.int64).max, deg)))
        order[i] = v
        removed[v] = True
        for w in nbrs[offs[v]:offs[v + 1]]:
            if not removed[w]:
                deg[w] -= 1
    return order


def _oriented_adj(g: Graph, order: np.ndarray) -> list:
    rank = np.empty(g.n, np.int64)
    rank[order] = np.arange(g.n)
    out = [None] * g.n
    offs, nbrs = g.csr
    for v in range(g.n):
        ns = nbrs[offs[v]:offs[v + 1]]
        fwd = ns[rank[ns] > rank[v]]
        out[v] = np.sort(fwd)
    return out


def clique_count(g: Graph, k: int) -> int:
    """Number of k-cliques (vertex subsets)."""
    if k == 1:
        return g.n
    if k == 2:
        return g.m
    adj = _oriented_adj(g, degeneracy_order(g))

    def rec(cands: np.ndarray, depth: int) -> int:
        if depth == k:
            return len(cands)
        total = 0
        for v in cands:
            nxt = np.intersect1d(cands, adj[v], assume_unique=True)
            if len(nxt) >= k - depth - 1:
                total += rec(nxt, depth + 1)
        return total

    total = 0
    for v in range(g.n):
        if len(adj[v]) >= k - 1:
            total += rec(adj[v], 2)
    return total


def clique_minus_edge_count(g: Graph, k: int) -> int:
    """Vertex-induced count of K_k minus one edge: non-adjacent pairs
    (u,v) whose common neighbourhood contains a (k-2)-clique fully
    adjacent to both — i.e. cliques of size k-2 in the induced common
    neighbourhood."""
    assert k >= 3
    offs, nbrs = g.csr
    # candidate non-adjacent pairs with >= k-2 common neighbours: collect
    # from wedges
    pair_count: dict = {}
    for w in range(g.n):
        ns = nbrs[offs[w]:offs[w + 1]]
        if len(ns) < 2:
            continue
        for i in range(len(ns)):
            u = ns[i]
            for v in ns[i + 1:]:
                pair_count[(u, v)] = pair_count.get((u, v), 0) + 1
    total = 0
    for (u, v), c in pair_count.items():
        if c < k - 2 or g.has_edge(u, v):
            continue
        common = np.intersect1d(g.neighbors(u), g.neighbors(v),
                                assume_unique=True)
        sub = _induced(g, common)
        total += clique_count(sub, k - 2)
    return total


def pseudo_clique_count(g: Graph, k: int) -> int:
    """Vertex-induced pseudo-cliques with parameter 1 (paper's PC app):
    K_k plus K_k-minus-one-edge."""
    return clique_count(g, k) + clique_minus_edge_count(g, k)


def _induced(g: Graph, verts: np.ndarray) -> Graph:
    idx = {int(v): i for i, v in enumerate(verts)}
    edges = []
    vset = set(idx)
    for v in verts:
        for w in g.neighbors(int(v)):
            if int(w) in vset and int(w) > int(v):
                edges.append((idx[int(v)], idx[int(w)]))
    return Graph(len(verts), np.asarray(edges).reshape(-1, 2)
                 if edges else np.zeros((0, 2), np.int64))
