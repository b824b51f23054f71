"""Homomorphism-count engine: bucket elimination over the dense adjacency.

``hom_count`` contracts one tensor factor A[x_u, x_v] per pattern edge
(plus optional unary label/orientation factors) following an explicit
vertex elimination order — the tensorised form of the paper's loop nests.
Choosing the order IS choosing the decomposition: a cutting set is a
separator that the order eliminates last.

Intermediates above the element budget are computed in chunks over their
leading index (a host loop of device einsums over ``Tensor.narrow``
views) — the dense analogue of tiling the enumeration over vertex blocks.

Everything runs on ``torch.einsum`` in f64 on the adjacency's device.
Multi-operand steps are contracted pairwise in an explicit greedy order
(``_pairwise_einsum``): ``torch.einsum`` would otherwise go left to right
and may materialise an intermediate far wider than the step's output.
"""
from __future__ import annotations

import string
from typing import Optional

import torch

from repro_torch.core.pattern import Pattern

LETTERS = string.ascii_letters


class PlanTooWide(Exception):
    """The elimination order materialises an intermediate beyond the hard
    memory cap — the tensorised analogue of an enumeration too wide to
    tile.  Callers fall back (cliques -> ordered enumeration) or re-plan."""


def plan_from_cut(p: Pattern, cut: frozenset) -> tuple:
    """Elimination order from a cutting set: component vertices first
    (per component, leaves inward), cut vertices last."""
    comps = p.components_without(cut)
    order = []
    for comp in sorted(comps, key=lambda c: (len(c), sorted(c))):
        order.extend(sorted(comp))
    order.extend(sorted(cut))
    return tuple(order)


def greedy_plan(p: Pattern, free: tuple = ()) -> tuple:
    """Min-degree-style greedy elimination order (baseline plan)."""
    adj = {v: set(ns) for v, ns in enumerate(p.adj())}
    remaining = set(range(p.n)) - set(free)
    order = []
    while remaining:
        v = min(remaining, key=lambda x: (len(adj[x] & remaining), x))
        order.append(v)
        nb = adj[v] & (remaining - {v})
        for a in nb:                       # connect the frontier (fill-in)
            adj[a] |= nb - {a}
        remaining.remove(v)
    order.extend(sorted(free))
    return tuple(order)


def elimination_widths(p: Pattern, order: tuple, free: tuple = ()) -> list:
    """Actual per-step intermediate widths of ``hom_count``: simulate the
    factor index sets exactly as the engine contracts them — eliminating
    ``v`` joins only the factors that *touch* v, so a free output axis
    widens a step only once some factor actually carries it (it enters
    through an edge to a free vertex, then rides the produced
    intermediate).  Returns [(v, out_width)] aligned with
    ``frontier_sizes`` (free vertices skipped).

    This is the execution-faithful width the memory gate should test:
    ``frontier_sizes``-based costing used to union *every* free axis
    into *every* step, an upper bound that priced anchored flat-Möbius
    candidates infinite on large graphs even though the real einsums
    never materialise those axes early."""
    factors = [frozenset(e) for e in sorted(p.edges)]
    covered = set().union(*factors) if factors else set()
    factors += [frozenset({v}) for v in range(p.n) if v not in covered]
    out = []
    for v in order:
        if v in free:
            continue
        involved = [s for s in factors if v in s]
        rest = [s for s in factors if v not in s]
        out_idx = frozenset().union(*involved) - {v} if involved \
            else frozenset()
        out.append((v, len(out_idx)))
        factors = rest + [out_idx]
    return out


def frontier_sizes(p: Pattern, order: tuple, free: tuple = ()) -> list:
    """Width of each elimination step (ndim of the intermediate), and the
    processed-subpattern vertex sets (for the APCT cost model)."""
    adj = {v: set(ns) for v, ns in enumerate(p.adj())}
    alive = {v: set(adj[v]) for v in range(p.n)}
    steps = []
    eliminated = set()
    for v in order:
        if v in free:
            continue
        frontier = alive[v] - eliminated
        steps.append((v, frozenset(frontier | {v})))
        for a in frontier:
            alive[a] |= frontier - {a}
        eliminated.add(v)
    return steps


def _einsum_letters(idx_sets, out_idx):
    names = {}
    for s in idx_sets:
        for i in s:
            if i not in names:
                names[i] = LETTERS[len(names)]
    for i in out_idx:
        if i not in names:
            names[i] = LETTERS[len(names)]
    lhs = ",".join("".join(names[i] for i in s) for s in idx_sets)
    rhs = "".join(names[i] for i in out_idx)
    return lhs + "->" + rhs


def _pairwise_einsum(idx_sets, arrays, out_idx):
    """einsum of several operands as a sequence of two-operand einsums.

    Each round contracts the pair whose result has the fewest indices
    (ties: the earliest pair), summing away every index that neither the
    output nor another operand still needs.  Values are integers in f64,
    so the order changes no result — only the peak intermediate size."""
    ops = [(tuple(s), a) for s, a in zip(idx_sets, arrays)]
    out_idx = tuple(out_idx)
    while len(ops) > 2:
        best = None
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                needed = set(out_idx)
                for k, (s, _) in enumerate(ops):
                    if k != i and k != j:
                        needed.update(s)
                res = tuple(sorted((set(ops[i][0]) | set(ops[j][0]))
                                   & needed))
                if best is None or len(res) < len(best[2]):
                    best = (i, j, res)
        i, j, res = best
        arr = torch.einsum(
            _einsum_letters([ops[i][0], ops[j][0]], res),
            ops[i][1], ops[j][1])
        ops = [o for k, o in enumerate(ops) if k != i and k != j]
        ops.append((res, arr))
    return torch.einsum(_einsum_letters([s for s, _ in ops], out_idx),
                        *[a for _, a in ops])


def _contract(tensors, out_idx, budget: int):
    """einsum the (indices, tensor) factors down to ``out_idx``; chunk over
    the leading output index if the result exceeds the budget."""
    idx_sets = [t[0] for t in tensors]
    arrays = [t[1] for t in tensors]
    n = arrays[0].shape[0] if arrays else 1
    out_elems = n ** len(out_idx)
    if out_elems > 4 * budget:
        raise PlanTooWide(f"intermediate of {out_elems:.2e} elements "
                          f"(indices {out_idx}, n={n}) exceeds the cap")
    if out_elems <= budget or not out_idx:
        return _pairwise_einsum(idx_sets, arrays, out_idx)
    # chunk over out_idx[0]
    lead = out_idx[0]
    chunk = max(1, budget // max(n ** (len(out_idx) - 1), 1))
    pieces = []
    for start in range(0, n, chunk):
        length = min(start + chunk, n) - start
        sub = []
        for s, a in tensors:
            if lead in s:
                a = a.narrow(s.index(lead), start, length)
            sub.append(a)
        pieces.append(_pairwise_einsum(idx_sets, sub, out_idx))
    return torch.cat(pieces, dim=0)


def hom_count(p: Pattern, A, *, order: Optional[tuple] = None,
              free: tuple = (), unary: Optional[dict] = None,
              edge_tensors: Optional[dict] = None,
              budget: int = 1 << 27):
    """# homomorphisms (maps preserving edges) of p into the graph with
    dense adjacency A (an (n, n) tensor, f64 for exact counts), with
    ``free`` pattern vertices kept as output axes.  Returns a tensor on
    A's device: 0-d for a closed count, (n,)*len(free) otherwise.

    unary: {vertex: (N,) factor}    (labels, degree masks, ...)
    edge_tensors: {(u,v) sorted: (N,N) factor} overriding A for that edge
      (orientation masks for partial symmetry breaking).
    """
    n = A.shape[0]
    ones = lambda: torch.ones((n,), dtype=A.dtype, device=A.device)
    if p.n == 1:
        vec = unary.get(0, ones()) if unary else ones()
        return vec if free == (0,) else torch.sum(vec)
    factors = []
    for (u, v) in sorted(p.edges):
        t = None
        if edge_tensors:
            t = edge_tensors.get((u, v))
        factors.append(((u, v), t if t is not None else A))
    if unary:
        for v, vec in unary.items():
            factors.append(((v,), vec))
    covered = set()
    for s, _ in factors:
        covered.update(s)
    for v in range(p.n):                      # isolated vertices
        if v not in covered:
            factors.append(((v,), ones()))

    order = order or greedy_plan(p, free)
    for v in order:
        if v in free:
            continue
        involved = [f for f in factors if v in f[0]]
        rest = [f for f in factors if v not in f[0]]
        out_idx = tuple(sorted({i for s, _ in involved for i in s} - {v}))
        arr = _contract(involved, out_idx, budget)
        factors = rest + [(out_idx, arr)]
    # multiply remaining factors over free indices
    if not free:
        total = torch.ones((), dtype=A.dtype, device=A.device)
        for s, a in factors:
            total = total * (a if a.ndim == 0 else torch.sum(a))
        return total
    arr = _contract(factors, tuple(free), budget)
    return arr
