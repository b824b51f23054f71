"""Cutting-set enumeration and subpattern extraction (paper §2.4).

A decomposition of pattern p is a vertex cutting set V_C whose removal
splits p into K >= 2 connected components; each component union V_C is a
subpattern.  Cliques have no cutting set — the engine falls back to the
direct (no-decomposition) plan, exactly the paper's fallback behaviour.

Labels ride along: ``subpatterns`` extracts induced subpatterns with
their vertex labels intact, while cutting sets themselves are a purely
structural property, so labelled variants share one enumeration over
the unlabelled skeleton.
"""
from __future__ import annotations

import itertools
from functools import lru_cache

from repro_torch.core.pattern import Pattern


@lru_cache(maxsize=50_000)
def cutting_sets(p: Pattern) -> tuple:
    """All cutting sets (frozensets) of p, smallest first.  O(2^n) subsets,
    fine for pattern-sized graphs.  Cutting sets depend only on the edge
    structure, so every labelled variant of one skeleton shares a single
    cached enumeration."""
    if p.labels is not None:
        return cutting_sets(Pattern(p.n, p.edges))
    out = []
    verts = list(range(p.n))
    for size in range(1, p.n - 1):
        for cs in itertools.combinations(verts, size):
            cut = frozenset(cs)
            comps = p.components_without(cut)
            if len(comps) >= 2:
                out.append(cut)
    return tuple(out)


def candidates(p: Pattern) -> tuple:
    """Search space for one pattern: None (direct enumeration fallback)
    plus every cutting set."""
    return (None,) + cutting_sets(p)


def subpatterns(p: Pattern, cut: frozenset) -> list:
    """[(subpattern, vertex map old->new)] — one per component, each
    merged with the cutting set."""
    out = []
    for comp in p.components_without(cut):
        vs = sorted(comp | cut)
        idx = {v: i for i, v in enumerate(vs)}
        out.append((p.induced(vs), idx))
    return out
