"""Pattern graphs (<= ~8 vertices): canonical forms, automorphisms,
connectivity, quotients.  Canonicalisation uses invariant refinement
(degree / neighbour-degree classes) to prune the permutation search, which
keeps 7-motif-scale generation fast in pure Python.
"""
from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Iterable, Optional, Tuple

Edge = Tuple[int, int]


def _norm_edges(edges) -> frozenset:
    out = set()
    for a, b in edges:
        if a == b:
            continue
        out.add((min(a, b), max(a, b)))
    return frozenset(out)


class Pattern:
    __slots__ = ("n", "edges", "labels", "_hash")

    def __init__(self, n: int, edges: Iterable[Edge],
                 labels: Optional[tuple] = None):
        self.n = int(n)
        self.edges = _norm_edges(edges)
        self.labels = tuple(labels) if labels is not None else None
        if self.labels is not None:
            assert len(self.labels) == self.n
        self._hash = hash((self.n, self.edges, self.labels))

    # -- basics --------------------------------------------------------------
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (self.n, self.edges, self.labels) == \
               (other.n, other.edges, other.labels)

    def __repr__(self):
        lab = f", labels={self.labels}" if self.labels else ""
        return f"Pattern({self.n}, {sorted(self.edges)}{lab})"

    @property
    def m(self) -> int:
        return len(self.edges)

    def adj(self) -> list:
        a = [set() for _ in range(self.n)]
        for u, v in self.edges:
            a[u].add(v)
            a[v].add(u)
        return a

    def degree(self, v: int) -> int:
        return sum(1 for e in self.edges if v in e)

    def has_edge(self, u: int, v: int) -> bool:
        return (min(u, v), max(u, v)) in self.edges

    def is_connected(self) -> bool:
        if self.n <= 1:
            return True
        a = self.adj()
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for w in a[u]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == self.n

    def components_without(self, cut: frozenset) -> list:
        """Connected components of pattern minus the cut vertices."""
        a = self.adj()
        rest = [v for v in range(self.n) if v not in cut]
        seen = set()
        comps = []
        for s in rest:
            if s in seen:
                continue
            comp = {s}
            stack = [s]
            seen.add(s)
            while stack:
                u = stack.pop()
                for w in a[u]:
                    if w not in cut and w not in seen:
                        seen.add(w)
                        comp.add(w)
                        stack.append(w)
            comps.append(frozenset(comp))
        return comps

    def induced(self, vertices) -> "Pattern":
        """Induced subpattern, vertices relabelled 0..k-1 (sorted order).
        Returns (pattern, mapping old->new)."""
        vs = sorted(vertices)
        idx = {v: i for i, v in enumerate(vs)}
        e = [(idx[u], idx[v]) for u, v in self.edges
             if u in idx and v in idx]
        lab = tuple(self.labels[v] for v in vs) if self.labels else None
        return Pattern(len(vs), e, lab)

    def relabel(self, perm) -> "Pattern":
        """perm[i] = new index of vertex i."""
        e = [(perm[u], perm[v]) for u, v in self.edges]
        lab = None
        if self.labels:
            lab = [0] * self.n
            for i, l in enumerate(self.labels):
                lab[perm[i]] = l
        return Pattern(self.n, e, tuple(lab) if lab else None)

    def quotient_with_map(self, partition):
        """Merge each block of ``partition`` (iterable of iterables covering
        0..n-1) into one vertex.  Returns (pattern, block_index map old->new)
        or (None, None) if merging adjacent vertices creates a self-loop
        (no injective images on simple G) or labels conflict."""
        blocks = [sorted(b) for b in partition]
        blocks.sort()
        idx = {}
        for bi, b in enumerate(blocks):
            for v in b:
                idx[v] = bi
        e = set()
        for u, v in self.edges:
            a, b = idx[u], idx[v]
            if a == b:
                return None, None                # self-loop
            e.add((min(a, b), max(a, b)))
        lab = None
        if self.labels:
            lab = []
            for b in blocks:
                ls = {self.labels[v] for v in b}
                if len(ls) > 1:
                    return None, None            # incompatible labels
                lab.append(ls.pop())
        return Pattern(len(blocks), e, tuple(lab) if lab else None), idx

    def quotient(self, partition) -> "Pattern":
        return self.quotient_with_map(partition)[0]

    # -- invariants / canonical form ------------------------------------------
    def _classes(self) -> list:
        """Vertex partition by a cheap 2-round WL-style invariant."""
        a = self.adj()
        inv = [(self.degree(v), self.labels[v] if self.labels else 0)
               for v in range(self.n)]
        for _ in range(2):
            inv = [(inv[v], tuple(sorted(inv[w] for w in a[v])))
                   for v in range(self.n)]
        key = {}
        for v in range(self.n):
            key.setdefault(inv[v], []).append(v)
        return [key[k] for k in sorted(key)]

    def _perms(self):
        """Permutations respecting invariant classes (maps old->new)."""
        classes = self._classes()
        slots = []
        pos = 0
        for c in classes:
            slots.append((c, list(range(pos, pos + len(c)))))
            pos += len(c)
        for assignment in itertools.product(
                *[itertools.permutations(s) for c, s in slots]):
            perm = [0] * self.n
            for (c, _), slot_perm in zip(slots, assignment):
                for v, p in zip(c, slot_perm):
                    perm[v] = p
            yield tuple(perm)

    def _code(self) -> tuple:
        bits = 0
        k = 0
        for i in range(self.n):
            for j in range(i + 1, self.n):
                if (i, j) in self.edges:
                    bits |= 1 << k
                k += 1
        return (bits, self.labels or ())

    def canonical(self) -> "Pattern":
        return _canonical_cached(self)

    def canonical_perm(self) -> tuple:
        """A permutation (old->new) achieving the canonical form."""
        best, bperm = None, None
        for perm in self._perms():
            q = self.relabel(perm)
            c = q._code()
            if best is None or c > best:
                best, bperm = c, perm
        return bperm

    def automorphisms(self) -> list:
        """All permutations (old->new) preserving edges and labels.
        Automorphisms map each invariant class onto itself, so we only
        permute members within their own class's vertex set."""
        classes = self._classes()
        code = self._code()
        out = []
        for assignment in itertools.product(
                *[itertools.permutations(c) for c in classes]):
            perm = [0] * self.n
            for c, pc in zip(classes, assignment):
                for v, t in zip(c, pc):
                    perm[v] = t
            if self.relabel(tuple(perm))._code() == code:
                out.append(tuple(perm))
        return out

    def aut_order(self) -> int:
        return len(self.automorphisms())

    def vertex_orbits(self) -> list:
        """Vertex orbits under the automorphism group (sorted tuples,
        sorted by first member).  Vertices in one orbit are exchangeable
        — in particular their FSM MINI domains coincide, so domain plans
        only materialise one representative per orbit."""
        parent = list(range(self.n))

        def find(v):
            while parent[v] != v:
                parent[v] = parent[parent[v]]
                v = parent[v]
            return v

        for perm in self.automorphisms():
            for v, w in enumerate(perm):
                a, b = find(v), find(w)
                if a != b:
                    parent[max(a, b)] = min(a, b)
        groups: dict = {}
        for v in range(self.n):
            groups.setdefault(find(v), []).append(v)
        return sorted(tuple(sorted(g)) for g in groups.values())


@lru_cache(maxsize=100_000)
def _canonical_impl(n, edges, labels):
    p = Pattern(n, edges, labels)
    return p.relabel(p.canonical_perm())


def _canonical_cached(p: Pattern) -> Pattern:
    return _canonical_impl(p.n, p.edges, p.labels)


# -- free-vertex marking --------------------------------------------------------
#
# Free-hom tensors (hom with some vertices kept as output axes) need a
# canonical identity that pins the free axes: two (pattern, free-vertex)
# pairs are interchangeable iff an isomorphism maps one onto the other
# *respecting both real labels and free positions*.  Both properties are
# packed into one int label per vertex:
#
#     unlabelled pattern:  marker                 (0 = bound, k = k-th free)
#     labelled pattern:    (label+1)*STRIDE + marker
#
# Labelled encodings are >= LABEL_STRIDE, unlabelled stay below it, and
# markers never reach the stride (patterns have <= ~8 vertices), so the
# packing is injective and decodable.  ``CountingEngine`` and the
# compiler's free-hom Contract nodes share this scheme, which is what
# lets their (pattern, free) memo keys coincide.

LABEL_STRIDE = 16


def encode_free_label(label, marker: int) -> int:
    assert 0 <= marker < LABEL_STRIDE
    return marker if label is None else (label + 1) * LABEL_STRIDE + marker


def free_skeleton(p: "Pattern") -> "Pattern":
    """Invert the marking: strip markers, restore real labels (if any)."""
    if p.labels is None or max(p.labels) < LABEL_STRIDE:
        return Pattern(p.n, p.edges)
    return Pattern(p.n, p.edges,
                   tuple(l // LABEL_STRIDE - 1 for l in p.labels))


def mark_free(p: "Pattern", free: tuple):
    """Canonicalise a (pattern, free-vertex) pair: returns
    ``(marked, canonical, free_c)`` — the marker-encoded pattern, its
    canonical form, and the free vertices' canonical positions (in rank
    order).  Isomorphic pairs (labels and free positions respected) map
    to identical results."""
    lab = [encode_free_label(p.labels[v] if p.labels else None, 0)
           for v in range(p.n)]
    for rank, fv in enumerate(free):
        lab[fv] = encode_free_label(p.labels[fv] if p.labels else None,
                                    rank + 1)
    marked = Pattern(p.n, p.edges, tuple(lab))
    perm = marked.canonical_perm()
    return marked, marked.relabel(perm), tuple(perm[fv] for fv in free)


# -- common patterns -----------------------------------------------------------

def chain(k: int) -> Pattern:
    return Pattern(k, [(i, i + 1) for i in range(k - 1)])


def clique(k: int) -> Pattern:
    return Pattern(k, [(i, j) for i in range(k) for j in range(i + 1, k)])


def cycle(k: int) -> Pattern:
    return Pattern(k, [(i, (i + 1) % k) for i in range(k)])


def star(k: int) -> Pattern:
    return Pattern(k, [(0, i) for i in range(1, k)])


def tailed_triangle() -> Pattern:
    return Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)])


def pseudo_clique(k: int, missing: int = 1) -> list:
    """All patterns obtained by deleting ``missing`` edges from a k-clique
    (pseudo-cliques with parameter k in the paper's PC application)."""
    full = clique(k)
    out = {}
    for drop in itertools.combinations(sorted(full.edges), missing):
        p = Pattern(k, full.edges - set(drop))
        if p.is_connected():
            out[p.canonical()] = True
    return list(out)
