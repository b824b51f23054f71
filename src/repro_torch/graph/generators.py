"""Synthetic graph generators: Erdős–Rényi, RMAT, small-world, labelled."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.storage import Graph


def erdos_renyi(n: int, avg_degree: float, seed: int = 0,
                num_labels: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    e = rng.integers(0, n, size=(int(m * 1.2) + 8, 2))
    labels = rng.integers(0, num_labels, n) if num_labels else None
    return Graph(n, e[:m * 2], labels)


def rmat(n_log2: int, avg_degree: float, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         num_labels: int = 0) -> Graph:
    """R-MAT generator (Chakrabarti et al. 2004), used for RMAT-100M-style
    skewed graphs in the paper's Table 7."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    m = int(n * avg_degree / 2)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    p = np.array([a, b, c, 1 - a - b - c])
    for bit in range(n_log2):
        q = rng.choice(4, size=m, p=p)
        src |= ((q >> 1) & 1) << bit
        dst |= (q & 1) << bit
    labels = rng.integers(0, num_labels, n) if num_labels else None
    return Graph(n, np.stack([src, dst], 1), labels)


def small_world(n: int, k: int = 4, beta: float = 0.1, seed: int = 0,
                num_labels: int = 0) -> Graph:
    """Watts–Strogatz ring with rewiring — high structural locality, the
    regime where the paper's APCT beats the random-graph cost model."""
    rng = np.random.default_rng(seed)
    edges = []
    for off in range(1, k // 2 + 1):
        u = np.arange(n)
        v = (u + off) % n
        rewire = rng.random(n) < beta
        v = np.where(rewire, rng.integers(0, n, n), v)
        edges.append(np.stack([u, v], 1))
    labels = rng.integers(0, num_labels, n) if num_labels else None
    return Graph(n, np.concatenate(edges), labels)


def triangle_rich(n: int, communities: int, seed: int = 0,
                  num_labels: int = 0) -> Graph:
    """Clustered graph (dense communities + sparse bridges): a proxy for
    CiteSeer/MiCo-like locality used in the cost-model experiments."""
    rng = np.random.default_rng(seed)
    size = max(n // communities, 3)
    edges = []
    for ci in range(communities):
        lo = ci * size
        hi = min(lo + size, n)
        verts = np.arange(lo, hi)
        if len(verts) < 2:
            continue
        # dense-ish intra-community
        k = min(len(verts) * 3, len(verts) * (len(verts) - 1) // 2)
        u = rng.choice(verts, k)
        v = rng.choice(verts, k)
        edges.append(np.stack([u, v], 1))
    bridges = rng.integers(0, n, size=(n // 4 + 1, 2))
    edges.append(bridges)
    labels = rng.integers(0, num_labels, n) if num_labels else None
    return Graph(n, np.concatenate(edges), labels)
