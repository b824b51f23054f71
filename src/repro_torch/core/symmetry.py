"""Partial symmetry breaking (paper §4.4), tensorised.

Full symmetry breaking (vertex-ID restrictions) is incompatible with the
decomposition join — restricting each subpattern destroys the tuple
multiplicities the join needs (Fig 25).  PSB restricts only a *partially
symmetric* sub-structure and compensates by replaying the remaining
computation once per automorphism image (Fig 26).

Tensor form: pick an interchangeable vertex orbit O (vertices with
identical neighbourhoods outside O, O itself a clique or independent set —
so Sym(O) <= Aut(p)).  Eliminate all non-orbit vertices first, producing an
extension tensor E over O's indices; the compensation replay is the sum of
E over all |O|! axis permutations (``permute`` — cheap, the paper's
duplicated inner loops); the restricted enumeration contracts the
symmetrised E against strictly-upper-triangular orbit masks, touching each
vertex combination once.  Tensors are f64 on the adjacency's device.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.core import homomorphism as H
from repro_torch.core.pattern import Pattern


def interchangeable_orbits(p: Pattern) -> list:
    """Maximal vertex sets whose members are pairwise interchangeable:
    same neighbourhood outside the set, and the set is a clique or an
    independent set.  Sym(orbit) is then a subgroup of Aut(p)."""
    a = p.adj()
    orbits = {}
    closed, open_ = {}, {}
    for v in range(p.n):
        lab = p.labels[v] if p.labels else 0
        closed.setdefault((frozenset(a[v] | {v}), lab), []).append(v)
        open_.setdefault((frozenset(a[v]), lab), []).append(v)
    for groups, want_clique in ((closed, True), (open_, False)):
        for vs in groups.values():
            if len(vs) < 2:
                continue
            pairs = itertools.combinations(vs, 2)
            if want_clique and all(p.has_edge(u, w) for u, w in pairs):
                orbits[tuple(sorted(vs))] = True
            elif not want_clique and not any(p.has_edge(u, w)
                                             for u, w in pairs):
                orbits[tuple(sorted(vs))] = True
    return sorted(orbits)


def hom_oriented(p: Pattern, A, orbit, *, order=None, unary=None,
                 budget: int = 1 << 27) -> torch.Tensor:
    """hom count with the orbit enumerated once (x_{o1} < x_{o2} < ...)
    times the |orbit|! compensation — equals hom(p) exactly.  ``A`` is the
    (n, n) adjacency tensor; the result is a 0-d tensor on its device.

    Internally: eliminate non-orbit vertices -> extension tensor E over the
    orbit; symmetrise E over axis permutations (compensation replay);
    contract with strict-order masks.
    """
    k = len(orbit)
    free = tuple(orbit)
    E = H.hom_count(p, A, order=order, free=free, unary=unary, budget=budget)
    # compensation replay: sum over all axis permutations
    sym = torch.zeros_like(E)
    for perm in itertools.permutations(range(k)):
        sym = sym + E.permute(perm)
    # orbit-internal factors: edges (clique orbit) need A between members;
    # restrict to strictly increasing assignments
    n = A.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=A.dtype, device=A.device), 1)
    clique = all(p.has_edge(orbit[i], orbit[j])
                 for i in range(k) for j in range(i + 1, k))
    factors = []
    idx = list(range(k))
    for i in range(k):
        for j in range(i + 1, k):
            m = upper * A if clique else upper
            factors.append(((i, j), m))
    factors.append((tuple(idx), sym))
    return H._contract(factors, (), budget)


def psb_speedup_estimate(p: Pattern, orbit) -> float:
    """Structural work reduction on the orbit contraction: the oriented
    enumeration touches C(n,k) instead of n^k combinations."""
    return float(math.factorial(len(orbit)))
