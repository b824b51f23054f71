"""Partial-embedding API: local counts off the decomposition join.

The paper's second headline contribution (§5) is an API that exposes
*per-partial-embedding* information while preserving the advantages of
pattern decomposition: systems that materialise full embeddings pay the
whole enumeration to answer any localised question, whereas the
decomposition join already holds every answer in its cut tensors — the
factor product *before* the final Σ_{e_c} reduce is exactly the table of
completion counts per cut-vertex assignment.  This module reads that
table instead of rebuilding it:

``local_counts(p, g)``            the local tensor over the chosen
                                  cutting set: entry e_c = # injective
                                  maps of ``p`` pinning the cut to e_c.
``local_counts(p, g, anchor=v)``  the (N,) anchored vector: completion
                                  counts with pattern vertex v pinned to
                                  each graph vertex (v is forced into
                                  the cutting set when one contains it;
                                  flat Möbius otherwise).
``exists(p, g)``                  early-exit existence: an all-zero
                                  factor tensor decides False before the
                                  join or shrinkage corrections run.
``vertex_counts(p, g)``           orbit-weighted per-vertex counts: entry
                                  u = # edge-induced embeddings of ``p``
                                  containing graph vertex u (Σ over
                                  orbits of |orbit| · anchored / |Aut|).
``vertex_counts(p, g, top_k=K)``  the K hottest vertices only, as
                                  (value, vertex) pairs.
``pattern_domains(counter, p)``   FSM MINI domains per orbit
                                  representative through the same route.

Counts are f64 tensors on the engine's device: ``device=None`` means the
CUDA device (and raises without one); pass ``device="cpu"`` to run on the
CPU, or a ``counter`` whose device is used.  All entry points compile
through ``repro_torch.compiler`` (plan cache, CSE with the count plans)
and fall back to an uncached direct assembly over a shared
``CountingEngine`` when compilation fails — except for ``KernelError``:
a CUDA kernel that does not build or launch propagates, so the fallback
never hides it.  Counts are exact integers (f64 end to end, f32 kernel
chunks only under the proven-exact guard).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import Pattern
from repro_torch.graph.storage import Graph
from repro_torch.kernels.build import KernelError


@dataclass
class LocalCounts:
    """One partial-embedding answer: ``counts[e_c]`` is the number of
    injective maps of ``pattern`` sending the cut vertices (``axes``, in
    ascending order) to e_c — or, when ``anchor`` is set, ``counts[u]``
    is the completion count with the anchor pinned to graph vertex u
    (then ``axes == (anchor,)``).  Unanchored tensors are computed on
    ``pattern.canonical()`` and ``axes`` name *canonical-form* vertices
    (map back through ``pattern.canonical_perm()``).  ``style`` records
    the route taken (``local`` = decomposition join, ``local-direct`` =
    flat Möbius fallback)."""
    pattern: Pattern
    anchor: Optional[int]
    axes: Optional[tuple]               # cut vertices backing each axis
    counts: torch.Tensor
    style: str = "local"
    from_cache: bool = False

    def total(self) -> float:
        """Σ over assignments = inj(pattern) (injective tuple count)."""
        return float(self.counts.sum())


def _compile_local(pattern: Pattern, graph: Graph, *, counter, cache,
                   apct=None, budget: int = 1 << 27):
    from repro_torch import compiler
    return compiler.compile((pattern,), graph, counter=counter,
                            cache=cache, apct=apct, budget=budget,
                            local=True)


def _direct_plan(pattern: Pattern, graph: Graph, anchor: Optional[int],
                 budget: int):
    """Uncompiled fallback: assemble the cheapest-by-construction local
    fragment directly (smallest eligible cutting set — containing the
    anchor when set — else the flat Möbius route for anchored queries).
    Returns (plan, out_key, cut, style) or None when no unanchored
    tensor exists (cliques).  Unanchored fragments build on the
    canonical form (same axis semantics as the compiled path)."""
    from repro_torch.compiler import frontend
    from repro_torch.compiler.ir import Plan
    from repro_torch.core.decomposition import cutting_sets
    if anchor is None:
        pattern = pattern.canonical()
    cand = None
    for cut in sorted(cutting_sets(pattern), key=len):
        if anchor is not None and anchor not in cut:
            continue
        cand = frontend.local_candidate(pattern, cut, graph_n=graph.n,
                                        anchor=anchor, budget=budget)
        if cand is not None:
            break
    if cand is None:
        if anchor is None:
            return None
        cand = frontend.anchored_direct_candidate(pattern, anchor)
    plan = Plan()
    for node in cand.nodes:
        plan.add(node)
    return plan, cand.out_key, cand.cut, cand.style


def local_counts(pattern: Pattern, graph: Graph, *,
                 anchor: Optional[int] = None,
                 counter: Optional[CountingEngine] = None,
                 cache=None, apct=None, use_compiler: bool = True,
                 budget: int = 1 << 27, device=None) -> LocalCounts:
    """Per-partial-embedding completion counts (see module docstring).

    ``counter`` shares hom/free-hom memos with other queries; ``cache``
    follows ``compiler.compile`` semantics (None = process cache,
    False = uncached).  ``use_compiler=False`` — or a compile failure
    other than ``KernelError`` — takes the direct assembly path over the
    shared engine.  Raises ``ValueError`` for an unanchored query on a
    pattern without an eligible cutting set (cliques: every vertex pair
    is adjacent, so no local tensor exists — anchored queries work)."""
    if anchor is not None and not (0 <= anchor < pattern.n):
        raise ValueError(f"anchor {anchor} outside pattern vertices")
    counter = counter or CountingEngine(graph, budget=budget, device=device)
    if use_compiler:
        try:
            cp = _compile_local(pattern, graph, counter=counter,
                                cache=cache, apct=apct, budget=budget)
            from repro_torch.compiler.ir import local_key
            key = local_key(pattern, anchor)
            if cp.has_local(pattern, anchor):
                cut = cp.plan.meta.get("local_cuts", {}).get(key)
                axes = ((anchor,) if anchor is not None
                        else tuple(cut) if cut else None)
                return LocalCounts(pattern, anchor, axes,
                                   cp.local_counts(pattern, anchor),
                                   style=("local" if cut
                                          else "local-direct"),
                                   from_cache=cp.from_cache)
            if anchor is None:
                raise ValueError(
                    f"{pattern!r} has no eligible cutting set: no "
                    f"unanchored local tensor (anchored queries work)")
        except (ValueError, KernelError):
            raise
        except Exception:               # direct assembly takes over
            obs.counter("api.compile_fallbacks", entry="local_counts")
    from repro_torch.compiler import lowering
    built = _direct_plan(pattern, graph, anchor, budget)
    if built is None:
        raise ValueError(
            f"{pattern!r} has no eligible cutting set: no unanchored "
            f"local tensor (anchored queries work)")
    plan, out_key, cut, style = built
    cp = lowering.lower(plan, graph, counter=counter, budget=budget)
    arr = cp.value(out_key).to(torch.float64, copy=True)
    axes = ((anchor,) if anchor is not None
            else tuple(sorted(cut)) if cut else None)
    return LocalCounts(pattern, anchor, axes, arr, style=style)


def exists(pattern: Pattern, graph: Graph, *,
           counter: Optional[CountingEngine] = None, cache=None,
           apct=None, use_compiler: bool = True,
           budget: int = 1 << 27, device=None) -> bool:
    """Pattern existence with the partial-embedding early exit: factor
    tensors evaluate per subpattern, and any all-zero factor decides
    False before the join or shrinkage corrections run.  Falls back to
    the engine's scalar existence when no local plan is available."""
    counter = counter or CountingEngine(graph, budget=budget, device=device)
    if use_compiler:
        try:
            cp = _compile_local(pattern, graph, counter=counter,
                                cache=cache, apct=apct, budget=budget)
            return cp.exists(pattern)
        except KernelError:
            raise
        except Exception:
            obs.counter("api.compile_fallbacks", entry="exists")
    try:
        lc = local_counts(pattern, graph, counter=counter,
                          use_compiler=False, budget=budget)
        return bool(lc.counts.max() > 0.5)
    except ValueError:                  # no cutting set (cliques)
        return counter.existence(pattern)


def plan_vertex_counts(cp, pattern: Pattern) -> torch.Tensor:
    """Orbit-weighted per-vertex embedding counts read off an
    already-compiled ``local=True`` plan: Σ over orbits of |orbit| ·
    anchored vector, / |Aut|.  The one home of the weighting formula."""
    total = torch.zeros(cp.graph.n, dtype=torch.float64, device=cp.device)
    for orbit in pattern.vertex_orbits():
        total += len(orbit) * cp.local_counts(pattern, orbit[0])
    return total / pattern.aut_order()


def top_vertices(vec, k: int) -> list:
    """The K hottest entries of a per-vertex vector as (value, vertex)
    pairs, hottest first (ties broken by vertex id, ascending, so the
    answer is deterministic).  ``topk`` finds the boundary value, then
    only the vertices at or above it are ranked."""
    vec = torch.as_tensor(vec)
    k = max(0, min(int(k), vec.numel()))
    if k == 0:
        return []
    # widen to every vertex tied with the selection boundary, then rank
    # (value desc, vertex asc): a stable sort of the ascending ids
    cand = torch.nonzero(vec >= torch.topk(vec, k).values.min()).flatten()
    cand = cand[torch.sort(-vec[cand], stable=True).indices][:k]
    return list(zip(vec[cand].tolist(), cand.tolist()))


def vertex_counts(pattern: Pattern, graph: Graph, *,
                  counter: Optional[CountingEngine] = None, cache=None,
                  apct=None, use_compiler: bool = True,
                  budget: int = 1 << 27, top_k: Optional[int] = None,
                  device=None):
    """Orbit-weighted per-vertex embedding counts: entry u is the number
    of edge-induced embeddings of ``pattern`` containing graph vertex u,
    so Σ_u vertex_counts[u] = n_p · inj(p) / |Aut|.  ``top_k=K`` returns
    only the K hottest vertices as (value, vertex) pairs, hottest
    first."""
    counter = counter or CountingEngine(graph, budget=budget, device=device)
    if use_compiler:
        try:
            # one compile serves every orbit: the plan registers all
            # anchored outputs, and its node-value/factor memos are
            # shared across the orbit reads
            cp = _compile_local(pattern, graph, counter=counter,
                                cache=cache, apct=apct, budget=budget)
            total = plan_vertex_counts(cp, pattern)
            return total if top_k is None else top_vertices(total, top_k)
        except KernelError:
            raise
        except Exception:               # per-orbit direct path takes over
            obs.counter("api.compile_fallbacks", entry="vertex_counts")
    total = torch.zeros(graph.n, dtype=torch.float64, device=counter.device)
    for orbit in pattern.vertex_orbits():
        lc = local_counts(pattern, graph, anchor=orbit[0],
                          counter=counter, cache=cache, apct=apct,
                          use_compiler=False, budget=budget)
        total += len(orbit) * lc.counts
    total /= pattern.aut_order()
    return total if top_k is None else top_vertices(total, top_k)


def pattern_domains(counter: CountingEngine, p: Pattern) -> dict:
    """FSM MINI domains {orbit representative -> (N,) tensor} through
    the partial-embedding route: anchored local counts ride the
    decomposition join (reusing cut tensors the engine already holds)
    instead of the flat Möbius free-hom expansion; a failure other than
    ``KernelError`` falls back to the engine's ``inj_free_all``.  Values
    equal ``counter.inj_free(p, rep)`` exactly."""
    reps = [o[0] for o in p.vertex_orbits()]
    try:
        return {rep: local_counts(p, counter.graph, anchor=rep,
                                  counter=counter,
                                  use_compiler=False).counts
                for rep in reps}
    except KernelError:
        raise
    except Exception:
        dom = counter.inj_free_all(p)
        return {rep: torch.from_numpy(dom[rep].copy()).to(counter.device)
                for rep in reps}
