"""Partition lattice machinery: set partitions, Möbius coefficients, and
shrinkage (quotient) patterns.

The paper's shrinkage patterns (§2.4) are quotients of the target pattern
obtained by merging vertices from *different* subpatterns.  In full
generality, homomorphism and injective-tuple counts are related across the
partition lattice:

    hom(p, G)  =  Σ_{σ ∈ Π(V_p)}  inj(p/σ, G)
    inj(p, G)  =  Σ_{σ ∈ Π(V_p)}  μ(σ) · hom(p/σ, G),
    μ(σ)       =  Π_{B ∈ σ} (-1)^{|B|-1} (|B|-1)!

Quotients with self-loops (merging adjacent vertices) have zero counts on
simple graphs and are dropped.  Quotients are deduplicated by canonical
form, which is exactly the paper's cross-pattern computation reuse: all
112 6-motif patterns share a small pool of quotient hom computations.

Labelled patterns are first-class: ``Pattern.quotient_with_map`` refuses
to merge vertices with different labels (such a quotient has zero hom /
inj count on a vertex-labelled graph, exactly like a self-loop), and
surviving quotients carry the merged labels, so every identity above —
including ``shrinkage_patterns`` multiplicities — holds verbatim on
labelled inputs.  The dropped terms are all identically zero, never
approximations.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache

from repro_torch.core.pattern import Pattern


def partitions(items: tuple):
    """All set partitions of ``items`` (tuple of ints)."""
    items = list(items)
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in partitions(tuple(rest)):
        for i in range(len(part)):
            yield part[:i] + [part[i] + [first]] + part[i + 1:]
        yield [[first]] + part


def mobius(partition) -> int:
    mu = 1
    for block in partition:
        b = len(block)
        mu *= (-1) ** (b - 1) * math.factorial(b - 1)
    return mu


@lru_cache(maxsize=10_000)
def quotient_terms(p: Pattern) -> tuple:
    """Terms of inj(p) = Σ μ·hom(p/σ): tuple of (coeff, canonical quotient),
    merged by isomorphism class.  Self-loop quotients are dropped."""
    acc = {}
    for sigma in partitions(tuple(range(p.n))):
        q = p.quotient(sigma)
        if q is None:
            continue
        c = q.canonical()
        acc[c] = acc.get(c, 0) + mobius(sigma)
    return tuple(sorted(((v, k) for k, v in acc.items() if v != 0),
                        key=lambda t: (t[1].n, t[1].m, sorted(t[1].edges))))


@lru_cache(maxsize=10_000)
def hom_expansion(p: Pattern) -> tuple:
    """Terms of hom(p) = Σ inj(p/σ): tuple of (count, canonical quotient)."""
    acc = {}
    for sigma in partitions(tuple(range(p.n))):
        q = p.quotient(sigma)
        if q is None:
            continue
        c = q.canonical()
        acc[c] = acc.get(c, 0) + 1
    return tuple(sorted(((v, k) for k, v in acc.items()),
                        key=lambda t: (t[1].n, t[1].m, sorted(t[1].edges))))


def shrinkage_quotients_with_maps(p: Pattern, cut: frozenset) -> list:
    """[(quotient pattern, map p-vertex -> quotient vertex)] for every
    cross-component merging partition of p - cut — NOT deduplicated by
    isomorphism, because callers that pin cut vertices (Algorithm 1's
    hash tables, the compiler's anchored LocalCount corrections) need
    the vertex map of every individual partition.  Label-conflicting and
    self-loop merges are dropped (identically zero)."""
    comps = p.components_without(cut)
    comp_of = {}
    for ci, comp in enumerate(comps):
        for v in comp:
            comp_of[v] = ci
    non_cut = tuple(v for v in range(p.n) if v not in cut)
    out = []
    for sigma in partitions(non_cut):
        nontrivial = [b for b in sigma if len(b) > 1]
        if not nontrivial:
            continue
        if not all(len({comp_of[v] for v in b}) == len(b) for b in sigma):
            continue                        # merged within one component
        full = [[v] for v in sorted(cut)] + [sorted(b) for b in sigma]
        q, blk = p.quotient_with_map(full)
        if q is None:
            continue
        out.append((q, blk))
    return out


@lru_cache(maxsize=10_000)
def shrinkage_patterns_subset(p: Pattern, cut: frozenset) -> list:
    """Shrinkage patterns of the *axis-subset* decomposition, where each
    subpattern contains only the cut vertices adjacent to its component
    (the |cut| >= 3 tier's pair/vector factors).  The join then enforces
    injectivity only (a) among cut vertices (the kernel mask) and (b)
    within each component ∪ its adjacent cut vertices, so the allowed
    collisions — each contributing one inj(p/σ) to subtract — are:

      * vertices of different components (classic shrinkage);
      * a component vertex with a cut vertex *not* adjacent to that
        component (the distant-cut collisions the full-cut form folds
        into its factors).

    Enumerates partitions of all of V(p) whose blocks contain at most
    one cut vertex and only pairwise-allowed collisions; multiplicity 1
    per partition, deduplicated by canonical quotient.  Merging adjacent
    vertices never arises (cross-component pairs and distant-cut pairs
    are non-adjacent by construction), and label-conflicting merges are
    dropped as identically zero.  With every component adjacent to the
    whole cut this reduces exactly to ``shrinkage_patterns``."""
    comps = p.components_without(cut)
    adj = p.adj()
    comp_of = {}
    adjc = []
    for ci, comp in enumerate(comps):
        for v in comp:
            comp_of[v] = ci
        adjc.append(frozenset(c for c in cut if adj[c] & comp))

    def allowed(u, v):
        cu, cv = u in cut, v in cut
        if cu and cv:
            return False                    # the kernel mask keeps these
        if cu or cv:
            c, w = (u, v) if cu else (v, u)
            return c not in adjc[comp_of[w]]
        return comp_of[u] != comp_of[v]

    acc = {}
    for sigma in partitions(tuple(range(p.n))):
        nontrivial = [b for b in sigma if len(b) > 1]
        if not nontrivial:
            continue
        if not all(allowed(u, v) for b in nontrivial
                   for u, v in itertools.combinations(b, 2)):
            continue
        q = p.quotient(sigma)
        if q is None:
            continue                        # label conflict: zero
        c = q.canonical()
        acc[c] = acc.get(c, 0) + 1
    return sorted(acc.items(), key=lambda t: (t[0].n, t[0].m))


def shrinkage_patterns(p: Pattern, cut: frozenset) -> list:
    """The paper's shrinkage patterns for a decomposition with cutting set
    ``cut``: quotients merging >=2 vertices that lie in *different*
    connected components of p - cut (cut vertices are never merged).
    Returns a list of (canonical quotient, multiplicity) pairs where the
    multiplicity counts the partitions producing that quotient."""
    comps = p.components_without(cut)
    comp_of = {}
    for ci, comp in enumerate(comps):
        for v in comp:
            comp_of[v] = ci
    non_cut = tuple(v for v in range(p.n) if v not in cut)
    acc = {}
    for sigma in partitions(non_cut):
        # must merge at least one cross-component pair; blocks within one
        # component are not shrinkages (they are impossible tuples already
        # excluded by per-subpattern injectivity)
        nontrivial = [b for b in sigma if len(b) > 1]
        if not nontrivial:
            continue
        if not all(len({comp_of[v] for v in b}) == len(b) for b in sigma):
            continue                        # merged within one component
        full = [[v] for v in cut] + [list(b) for b in sigma]
        q = p.quotient(full)
        if q is None:
            continue
        c = q.canonical()
        acc[c] = acc.get(c, 0) + 1
    return sorted(acc.items(), key=lambda t: (t[0].n, t[0].m))
