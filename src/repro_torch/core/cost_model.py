"""Cost models for decomposition plans.

DwarvesGraph model (paper §4.2): every elimination step's intermediate has
one nonzero per match of the subpattern processed so far, so its cost is
the (approximate) count of that subpattern, queried from the APCT —
"every loop iteration corresponds to a match of a subpattern".  A small
dense-tile floor term models the structural minimum of a dense tiled pass.

The application-level cost accounts for cross-pattern computation reuse:
quotient contractions are shared by canonical form across all concrete
patterns, so the cost of a joint cutting-set assignment is summed over
*unique* (quotient, plan) pairs — the reason the paper searches the joint
space (§4.3).

The AutoMine baseline model (random graph, edge probability p = d/n) is
included for the Fig 22 comparison.
"""
from __future__ import annotations

from repro_torch.core import homomorphism as H
from repro_torch.core.pattern import Pattern
from repro_torch.core.quotient import quotient_terms

DENSE_TILE = 128


def plan_cost_apct(p: Pattern, order, apct, n_vertices: int,
                   tile: int = DENSE_TILE) -> float:
    """Cost of one hom contraction under the APCT model."""
    steps = H.frontier_sizes(p, order)
    total = 0.0
    done = set()
    for v, front in steps:
        done |= front
        sub = p.induced(sorted(done))
        # count-bound term: matches of the processed subpattern
        cnt = apct.query(sub) if sub.is_connected() else _disc(apct, p, done)
        # dense floor: tiles of the intermediate
        floor = (max(n_vertices, tile) / tile) ** len(front)
        total += cnt + floor
    return total


def _disc(apct, p: Pattern, done: set) -> float:
    """Disconnected processed subpattern: product over components."""
    sub = p.induced(sorted(done))
    out = 1.0
    seen = set()
    for comp in sub.components_without(frozenset()):
        out *= max(apct.query(sub.induced(sorted(comp))), 1.0)
        seen |= comp
    return out


def pattern_cost(p: Pattern, cut, apct, n_vertices: int,
                 shared: dict | None = None) -> float:
    """Cost of counting inj(p) with the given cutting set (None = direct).

    ``shared``: canonical-quotient -> cost memo; pass one dict across all
    patterns of an application to model computation reuse (costs of already
    -scheduled quotients are not paid again).
    """
    total = 0.0
    for coeff, q in quotient_terms(p):
        order = (H.plan_from_cut(q, _cut_image(p, cut, q))
                 if cut else H.greedy_plan(q))
        cost = plan_cost_apct(q, order, apct, n_vertices)
        if shared is not None:
            if q in shared:                       # already scheduled: reuse
                cost = 0.0
            else:
                shared[q] = cost
        total += cost
    return total


def _cut_image(p: Pattern, cut, q: Pattern):
    """Approximate separator for a quotient: vertices of q with degree
    >= the min cut-vertex degree is fragile, so we simply reuse any valid
    cutting set of q of the same size (quotients of a decomposable pattern
    are typically decomposable with the shrunken cut); fallback greedy."""
    from repro_torch.core.decomposition import cutting_sets
    for c in cutting_sets(q):
        if len(c) <= len(cut):
            return c
    return frozenset()


def application_cost(patterns_with_cuts, apct, n_vertices: int) -> float:
    """Joint cost of an application: Σ over unique quotient contractions."""
    shared: dict = {}
    total = 0.0
    for p, cut in patterns_with_cuts:
        total += pattern_cost(p, cut, apct, n_vertices, shared=shared)
    return total


# -- AutoMine baseline model (Fig 22) -------------------------------------------

def plan_cost_automine(p: Pattern, order, n: int, avg_degree: float) -> float:
    """Random-graph trip-count model: every vertex pair connected with
    probability pr = d/n; loop i trip count = n * pr^{#back edges}."""
    pr = min(avg_degree / max(n, 1), 1.0)
    steps = H.frontier_sizes(p, order)
    total, trips = 0.0, 1.0
    done = set()
    for v, front in steps:
        back = len(front) - 1
        trips *= n * (pr ** back)
        total += trips
        done |= front
    return total


def pattern_cost_automine(p: Pattern, cut, n: int, avg_degree: float) -> float:
    total = 0.0
    for coeff, q in quotient_terms(p):
        order = (H.plan_from_cut(q, _cut_image(p, cut, q))
                 if cut else H.greedy_plan(q))
        total += plan_cost_automine(q, order, n, avg_degree)
    return total
