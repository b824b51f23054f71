"""Exact pattern counting: hom -> injective -> edge/vertex-induced.

The engine memoises homomorphism counts by canonical pattern — the
tensorised form of the paper's cross-pattern computation reuse: all
concrete patterns of an application (e.g. the 112 6-motifs) draw from one
shared pool of quotient hom contractions.

Counts run in f64 on the engine's device (``torch.float64``) — exact up
to 2^53, enough for trillion-scale embedding counts.  Free-hom tensors
stay on the device; scalars come back with one ``.item()``.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import homomorphism as H
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import Pattern, free_skeleton, mark_free
from repro_torch.core.quotient import mobius, partitions, quotient_terms
from repro_torch.graph.storage import Graph


def _quotient_order(q: Pattern, cut_blocks: frozenset | None):
    if not cut_blocks:
        return H.greedy_plan(q)
    return H.plan_from_cut(q, frozenset(cut_blocks)) \
        if q.components_without(frozenset(cut_blocks)) else H.greedy_plan(q)


class CountingEngine:
    """Tensorised counting over one input graph, on one device — or, with
    ``mesh=``, with its contractions sliced over the mesh's slots."""

    def __init__(self, graph: Graph, budget: int = 1 << 27,
                 device=None, mesh=None):
        self.graph = graph
        self.budget = budget
        # a mesh names its devices: without ``device`` the engine lives on
        # the mesh's first slot
        if device is None and mesh is not None:
            device = mesh.home
        self.device = _device.resolve(device)
        self.dtype = _device.COUNT_DTYPE
        # sharded-contraction binding: a 1-D ("data",) mesh routes hom /
        # hom_free_tensor through ``distributed.contract`` (adjacency row
        # blocks, sliced einsums — bit-for-bit with the single-device
        # path).  None, a trivial mesh, or a graph smaller than the mesh
        # keeps every contraction single-device.
        self.mesh = None
        if mesh is not None:
            from repro_torch.distributed import meshes as _meshes
            d = _meshes.num_shards(mesh)
            if d > 1 and graph.n >= d:
                self.mesh = mesh
        # dense adjacency / label indicators build lazily: plans whose
        # contractions are all clique-enumerated never pay for them, and
        # the sharded route never builds them (its row blocks are built
        # only when a mesh routes to them)
        self._A_dense = None
        self._labels_dense = None
        self._A_blocks = None
        self._label_blocks = None
        self.hom_memo: dict = {}
        self.hom_free_memo: dict = {}
        self.domain_memo: dict = {}
        self.stats = {"hom_evals": 0, "hom_hits": 0}

    @property
    def A(self) -> torch.Tensor:
        """Dense (n, n) f64 adjacency on the device — lazy."""
        if self._A_dense is None:
            self._A_dense = torch.from_numpy(
                self.graph.dense_adjacency(np.float64, pad=False)
            ).to(self.device)
        return self._A_dense

    @property
    def labels(self):
        """(num_labels, n) one-hot indicators on the device — lazy, as
        ``A``; None on an unlabelled graph."""
        if self.graph.labels is None:
            return None
        if self._labels_dense is None:
            self._labels_dense = torch.from_numpy(
                self.graph.label_indicators(np.float64, pad=False)
            ).to(self.device)
        return self._labels_dense

    # -- sharded-contraction route --------------------------------------------
    def contract_shards(self) -> int:
        """Shard count of the contraction route (1 = single-device) —
        lowering annotates Contract evals with it."""
        if self.mesh is None:
            return 1
        from repro_torch.distributed import meshes as _meshes
        return _meshes.num_shards(self.mesh)

    def _blocks(self):
        if self._A_blocks is None:
            from repro_torch.distributed import contract as C
            self._A_blocks = C.adjacency_blocks(self.graph, self.mesh)
        return self._A_blocks

    def _unary_blocks(self, p: Pattern):
        """Sharded analogue of ``_unary_for``: label indicators split over
        the vertex axis, the same alphabet-binding semantics."""
        if p.labels is None or self.graph.labels is None:
            return None
        from repro_torch.distributed import contract as C
        if self._label_blocks is None:
            self._label_blocks = C.label_blocks(self.graph, self.mesh)
        return {v: C.unary_slices(self._label_blocks, l, self.graph.n)
                for v, l in enumerate(p.labels)}

    def _sharded_hom(self, p: Pattern, order, free=(), sliced=False):
        from repro_torch.distributed import contract as C
        val = C.sharded_hom(p, self._blocks(), mesh=self.mesh,
                            n=self.graph.n, order=order, free=free,
                            unary=self._unary_blocks(p),
                            budget=self.budget, sliced=sliced)
        return val if isinstance(val, C.Sliced) else val.to(self.device)

    # -- memo peeks (costing reads these to zero-cost materialised work) -------
    def has_hom(self, p: Pattern) -> bool:
        """True when ``hom(p)`` is already memoised (no evaluation)."""
        return p.canonical() in self.hom_memo

    def has_free_tensor(self, p: Pattern, free: tuple) -> bool:
        """True when the ``(pattern, free)``-keyed free-hom tensor is
        already materialised — the compiler's costing stage treats such
        ``Contract`` nodes as zero-cost (shared across cut choices and
        across compiles that reuse this engine)."""
        return (p, tuple(free)) in self.hom_free_memo

    # -- hom ------------------------------------------------------------------
    def _unary_for(self, p: Pattern):
        """Per-vertex label-indicator factors binding a labelled pattern
        to this graph's label alphabet.  A pattern label outside the
        alphabet binds to the zero vector (no such vertices => count 0),
        so one compiled plan serves any graph whose alphabet covers —
        or merely overlaps — the pattern's.  An unlabelled graph ignores
        pattern labels (wildcard semantics, matching the brute-force
        reference)."""
        if p.labels is None or self.labels is None:
            return None
        L = self.labels.shape[0]
        zero = torch.zeros_like(self.labels[0])
        return {v: (self.labels[l] if 0 <= l < L else zero)
                for v, l in enumerate(p.labels)}

    def hom(self, p: Pattern, order=None) -> float:
        c = p.canonical()
        if c in self.hom_memo:
            self.stats["hom_hits"] += 1
            return self.hom_memo[c]
        self.stats["hom_evals"] += 1
        if c.labels is None and c.m == c.n * (c.n - 1) // 2 and c.n >= 3:
            # complete pattern: no cutting set exists (paper §2.4) and the
            # dense contraction needs an N^(k-2) intermediate — route to
            # ordered enumeration.  hom(K_k) = k! * #cliques.
            from repro_torch.core.cliques import clique_count
            val = float(math.factorial(c.n) * clique_count(self.graph, c.n))
        elif self.mesh is not None:
            val = self._sharded_hom(c, order).item()
        else:
            val = H.hom_count(c, self.A, order=order,
                              unary=self._unary_for(c),
                              budget=self.budget).item()
        self.hom_memo[c] = val
        return val

    def hom_free_tensor(self, p: Pattern, free: tuple,
                        order=None) -> torch.Tensor:
        """hom(p) with ``free`` pattern vertices kept as output axes —
        a (N,)*len(free) f64 tensor over graph vertices, on the engine's
        device (it is never copied to the host: the join tier reads it
        where it lies).  The compiler's ``Contract`` primitive for
        decomposition joins (per-subpattern extension counts as a
        function of the cut tuple).  Memoised by (pattern, free) in
        caller-canonical form; treat the result as read-only.

        Under a mesh the contraction runs sliced over its slots
        (``distributed.contract``) and the memo holds its row blocks;
        this gathers them into one tensor on the engine's device — the
        same values, bit for bit.  ``hom_free_value`` hands the blocks
        over as they are."""
        val = self.hom_free_value(p, free, order)
        if self.mesh is None:
            return val
        from repro_torch.distributed import contract as C
        return C.gather(val, self.device)

    def hom_free_value(self, p: Pattern, free: tuple, order=None):
        """``hom_free_tensor``'s memoised value: the tensor, or under a
        mesh the slots' row blocks (a ``distributed.contract.Sliced``,
        split over ``free[0]`` as the sharded join tier splits cut axis
        0), where the slots made them."""
        key = (p, tuple(free))
        if key in self.hom_free_memo:
            self.stats["hom_hits"] += 1
            return self.hom_free_memo[key]
        self.stats["hom_evals"] += 1
        order = tuple(order) if order else None
        if self.mesh is not None:
            val = self._sharded_hom(p, order, tuple(free), sliced=True)
        else:
            val = H.hom_count(p, self.A, order=order, free=tuple(free),
                              unary=self._unary_for(p), budget=self.budget)
        self.hom_free_memo[key] = val
        return val

    # -- injective tuples / embeddings ----------------------------------------
    def inj(self, p: Pattern, cut=None) -> float:
        """# injective edge-preserving maps (ordered tuples).  ``cut``
        selects the decomposition: quotient contractions eliminate the image
        of the cutting set last (the separator)."""
        total = 0.0
        for coeff, q in quotient_terms(p):
            order = None
            if cut:
                # image of the cut under some quotient map: recompute per
                # quotient via a fresh partition walk is costly; the greedy
                # fallback is used when the cut does not survive.
                order = H.greedy_plan(q)
            total += coeff * self.hom(q, order=order)
        return total

    def edge_induced(self, p: Pattern, cut=None) -> float:
        """# edge-induced embeddings = inj / |Aut| (the paper's
        multiplicity M)."""
        return self.inj(p, cut=cut) / p.aut_order()

    def inj_free(self, p: Pattern, v: int) -> np.ndarray:
        """Vector over graph vertices u: # injective maps with v -> u
        (pattern-vertex domains for FSM MINI support)."""
        return self.inj_free_all(p)[v]

    def inj_free_all(self, p: Pattern) -> np.ndarray:
        """All FSM MINI domains of one pattern as a (p.n, N) matrix: row
        v counts injective maps with v -> u.  One partition walk covers
        every vertex (the old path re-walked per vertex), evaluating one
        free-hom tensor per distinct (quotient, block); each tensor is
        canonicalised (``mark_free``) into the ``hom_free_memo``, so
        vertices sharing a block, symmetric vertices, and sibling
        patterns sharing quotients all reuse the same contraction.  The
        finished matrix memoises per pattern, so per-vertex ``inj_free``
        loops pay the partition walk once."""
        if p in self.domain_memo:
            return self.domain_memo[p]
        n = self.graph.n
        dom = np.zeros((p.n, n))
        for sigma in partitions(tuple(range(p.n))):
            q, blk = p.quotient_with_map(sigma)
            if q is None:
                continue
            mu = mobius(sigma)
            vecs = {}
            for b in set(blk.values()):
                _, qc, free_c = mark_free(q, (b,))
                vecs[b] = self.hom_free_tensor(
                    free_skeleton(qc), free_c,
                    order=H.greedy_plan(qc, free_c)).cpu().numpy()
            for v in range(p.n):
                dom[v] += mu * vecs[blk[v]]
        dom.setflags(write=False)          # shared memo: no silent writes
        self.domain_memo[p] = dom
        return dom

    def vind_inj_oracle(self, p: Pattern) -> float:
        """Vertex-induced injective tuples via complement factors: edges
        must map to edges AND non-edges to non-edges.  Zero-diagonal
        factors enforce injectivity automatically.  Exponential in pattern
        size — test oracle only."""
        A = self.A
        comp = (1.0 - A) - torch.eye(A.shape[0], dtype=A.dtype,
                                     device=A.device)
        et = {}
        full = []
        for i in range(p.n):
            for j in range(i + 1, p.n):
                full.append((i, j))
                if not p.has_edge(i, j):
                    et[(i, j)] = comp
        pfull = Pattern(p.n, full, p.labels)
        val = H.hom_count(pfull, A, edge_tensors=et,
                          unary=self._unary_for(p), budget=self.budget)
        return val.item()

    def vertex_induced(self, p: Pattern) -> float:
        """Vertex-induced embedding count via the same-size overlay
        transform over edge-induced counts (paper §2.1)."""
        k = p.n
        pats = motif_patterns(k)
        e = {q: self.edge_induced(q) for q in pats}
        v = solve_overlay(k, e)
        return v[p.canonical()]

    def motif_table(self, k: int, cuts=None) -> dict:
        """Vertex-induced counts of every connected k-pattern (k-MC)."""
        pats = motif_patterns(k)
        e = {}
        for q in pats:
            cut = cuts.get(q) if cuts else None
            e[q] = self.edge_induced(q, cut=cut)
        return solve_overlay(k, e)

    def existence(self, p: Pattern) -> bool:
        return self.inj(p) > 0.5


# -- overlay transform ----------------------------------------------------------

@lru_cache(maxsize=16)
def overlay_matrix(k: int):
    """S[i][j] = # vertex permutations mapping E(P_i) into E(P_j), for the
    connected k-patterns.  edge_induced[i] = Σ_j S[i][j]/|Aut(P_i)| · vind[j].
    """
    import itertools
    pats = motif_patterns(k)
    adj = []
    for p in pats:
        bits = [0] * k
        for u, v in p.edges:
            bits[u] |= 1 << v
            bits[v] |= 1 << u
        adj.append(bits)
    S = np.zeros((len(pats), len(pats)), np.int64)
    for i, p in enumerate(pats):
        edges = sorted(p.edges)
        for j, q in enumerate(pats):
            if q.m < p.m:
                continue
            bj = adj[j]
            cnt = 0
            for perm in itertools.permutations(range(k)):
                ok = True
                for u, v in edges:
                    if not (bj[perm[u]] >> perm[v]) & 1:
                        ok = False
                        break
                if ok:
                    cnt += 1
            S[i, j] = cnt
    auts = np.array([p.aut_order() for p in pats], np.int64)
    return pats, S, auts


def solve_overlay(k: int, edge_counts: dict) -> dict:
    """Solve vind from edge-induced counts by back-substitution in
    descending edge count (S is triangular in that order)."""
    pats, S, auts = overlay_matrix(k)
    idx = {p: i for i, p in enumerate(pats)}
    order = sorted(range(len(pats)), key=lambda i: -pats[i].m)
    v = np.zeros(len(pats))
    e = np.array([edge_counts[p] for p in pats], float)
    for i in order:
        acc = e[i]
        for j in range(len(pats)):
            if j != i and S[i, j]:
                acc -= (S[i, j] / auts[i]) * v[j]
        v[i] = acc / (S[i, i] / auts[i])
    return {pats[i]: v[i] for i in range(len(pats))}


# -- brute-force reference (host) ------------------------------------------------

def brute_force_edge_induced(g: Graph, p: Pattern) -> int:
    """Nested-loop reference counter (the 'AutoMine' ground truth for
    tests).  Exponential; small graphs only."""
    adj = [set(g.neighbors(v)) for v in range(g.n)]
    order = H.greedy_plan(p)[::-1]                      # connected-first order
    order = _connected_order(p)
    pos = {v: i for i, v in enumerate(order)}
    count = 0
    assign = [None] * p.n

    def rec(i):
        nonlocal count
        if i == len(order):
            count += 1
            return
        v = order[i]
        back = [u for u in range(p.n) if p.has_edge(u, v) and pos[u] < i]
        lab_ok = (lambda x: g.labels is None or p.labels is None
                  or g.labels[x] == p.labels[v])
        if back:
            cands = set(adj[assign[back[0]]])
            for u in back[1:]:
                cands &= adj[assign[u]]
        else:
            cands = range(g.n)
        used = set(assign[order[j]] for j in range(i))
        for x in cands:
            if x in used or not lab_ok(x):
                continue
            assign[v] = x
            rec(i + 1)
            assign[v] = None

    rec(0)
    return count // p.aut_order()


def _connected_order(p: Pattern) -> list:
    a = p.adj()
    order = [0]
    seen = {0}
    while len(order) < p.n:
        nxt = [v for v in range(p.n) if v not in seen
               and any(u in seen for u in a[v])]
        if not nxt:
            nxt = [v for v in range(p.n) if v not in seen]
        order.append(nxt[0])
        seen.add(nxt[0])
    return order


def brute_force_vertex_induced(g: Graph, p: Pattern) -> int:
    """Vertex-induced reference via itertools over vertex subsets."""
    import itertools
    cnt = 0
    target = p.canonical()
    for vs in itertools.combinations(range(g.n), p.n):
        sub = [(a, b) for a, b in itertools.combinations(vs, 2)
               if g.has_edge(a, b)]
        idx = {v: i for i, v in enumerate(vs)}
        lab = (tuple(g.labels[v] for v in vs)
               if g.labels is not None and p.labels is not None else None)
        q = Pattern(p.n, [(idx[a], idx[b]) for a, b in sub], lab)
        if q.m == target.m and q.canonical() == target:
            cnt += 1
    return cnt
