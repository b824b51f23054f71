"""Frequent subgraph mining with MINI (minimum image-based) support —
level-wise, compiled.

Support of a labelled pattern = min over pattern vertices of the number of
distinct graph vertices appearing at that position across all embeddings
(paper §3, Fig 16).  MINI satisfies the downward closure property, so the
search grows patterns one edge at a time and prunes infrequent ones.

Each lattice level is evaluated *jointly*: the whole candidate frontier
goes through one ``compiler.compile(frontier, graph, domains=True)``
call, so sibling patterns sharing a parent CSE-merge their quotient
free-hom contractions (one ``homf:`` node pool per level), domain
vectors materialise once per automorphism orbit, and the plan cache
serves repeated runs.  The fallback path (``use_compiler=False``, or a
compile/execute failure other than ``KernelError``) computes domains per
pattern through the partial-embedding API over the shared engine.  A
kernel that does not build or launch propagates: no fallback hides it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import Pattern
from repro_torch.graph.storage import Graph
from repro_torch.kernels.build import KernelError


@dataclass
class FSMResult:
    frequent: dict                    # canonical pattern -> support
    evaluated: int = 0
    pruned: int = 0
    levels: int = 0
    compiled_levels: int = 0          # levels served by a compiled plan
    fallbacks: int = 0                # levels that fell back to support_fn


def mini_support(counter: CountingEngine, p: Pattern) -> int:
    """Fallback MINI support through the partial-embedding API: one
    anchored local-count vector per automorphism orbit (the anchored
    vector *is* the domain — # injective maps pinning the orbit
    representative per graph vertex), computed off the decomposition
    join where a cutting set contains the orbit and via the flat Möbius
    expansion otherwise; ``pattern_domains`` falls back to the engine's
    vectorised ``inj_free_all`` on a failure other than ``KernelError``.
    Support = min over orbits of the domain's nonzero count (orbit
    members share domains, so representatives suffice)."""
    from repro_torch.api import pattern_domains
    doms = pattern_domains(counter, p)
    return min(int(torch.count_nonzero(d > 0.5)) for d in doms.values())


def mini_support_dense(counter: CountingEngine, p: Pattern) -> int:
    """Legacy MINI support: the full domain matrix in one vectorised
    ``inj_free_all`` partition walk (kept as the differential oracle for
    the partial-embedding route and as a ``support_fn`` swap-in)."""
    dom = counter.inj_free_all(p)
    return int(np.count_nonzero(dom > 0.5, axis=1).min())


def _seed_patterns(g: Graph) -> list:
    """All frequent-candidate single-edge labelled patterns present in g."""
    seen = {}
    la = g.labels
    for u, v in g.edges:
        key = tuple(sorted((int(la[u]), int(la[v]))))
        seen[key] = seen.get(key, 0) + 1
    return [Pattern(2, [(0, 1)], key) for key in sorted(seen)]


def _extensions(p: Pattern, labels: range) -> list:
    """Grow by one edge: close two existing vertices or attach a new
    labelled vertex to an existing one."""
    out = {}
    for u, v in itertools.combinations(range(p.n), 2):
        if not p.has_edge(u, v):
            q = Pattern(p.n, list(p.edges) + [(u, v)], p.labels)
            if q.is_connected():
                out[q.canonical()] = True
    for u in range(p.n):
        for l in labels:
            q = Pattern(p.n + 1, list(p.edges) + [(u, p.n)],
                        tuple(p.labels) + (l,))
            out[q.canonical()] = True
    return list(out)


def _level_supports(g: Graph, level: list, counter: CountingEngine,
                    apct, plan_cache, res: FSMResult,
                    support_fn, count_store=None) -> dict:
    """MINI supports for one candidate frontier.  ``apct`` not None =>
    compile the frontier jointly (domain plans, cross-sibling CSE, plan
    cache); on a failure other than ``KernelError`` — or with the
    compiler disabled — every pattern falls back to ``support_fn`` over
    the shared engine.

    ``count_store`` (a ``compiler.morph.CountStore``) makes the frontier
    feed and read the morphing algebra: level plans compile with
    ``morph=``, so homs already held (from earlier levels' reads) serve
    without contracting, and the level's exact counts are read once and
    harvested back — level k warms the store for level k+1."""
    if apct is not None:
        try:
            from repro_torch import compiler
            # no caller-provided cache => compile uncached: frontier
            # pattern sets essentially never repeat across runs, so
            # feeding the process-global cache would only grow it
            cp = compiler.compile(tuple(level), g, apct=apct,
                                  counter=counter,
                                  cache=plan_cache if plan_cache is not None
                                  else False,
                                  domains=True,
                                  morph=count_store
                                  if count_store is not None else False)
            supports = {p: cp.mini_support(p) for p in level}
            if count_store is not None:
                # the counts() read evaluates the scalar count outputs
                # (domain reads alone touch only tensors) and harvests
                # them — the feeding cost morphing opts into
                cp.counts()
            res.compiled_levels += 1
            return supports
        except KernelError:
            raise
        except Exception:
            res.fallbacks += 1
    return {p: support_fn(counter, p) for p in level}


def fsm(g: Graph, min_support: int, max_vertices: int = 3,
        max_edges: int | None = None,
        counter: CountingEngine | None = None, *,
        use_compiler: bool = True, apct=None, plan_cache=None,
        support_fn=mini_support, count_store=None,
        device=None) -> FSMResult:
    """Level-wise FSM with downward-closure pruning.

    ``use_compiler`` routes every lattice level through one joint
    ``compiler.compile(..., domains=True)``; ``apct`` / ``plan_cache``
    are shared across levels (a small-sample APCT is profiled on
    demand).  Without an explicit ``plan_cache`` levels compile uncached
    — frontier sets rarely repeat, and write-once entries would bloat
    the process cache; pass a ``PlanCache`` to persist plans across
    repeated runs over the same graph.  ``support_fn(counter, p)``
    serves the non-compiled path.  ``device=None`` means the CUDA device
    (a ``counter`` brings its own).  ``count_store`` (a
    ``compiler.morph.CountStore``) threads the morphing count algebra
    through every level compile: each frontier's exact counts are
    harvested into the store and later levels' held homs serve without
    contracting.
    """
    if g.labels is None:
        raise ValueError("FSM requires a labelled graph")
    counter = counter or CountingEngine(g, device=device)
    if use_compiler and apct is None:
        from repro_torch.core.apct import APCT
        apct = APCT(g, num_samples=4096)   # one profile, every level
    elif not use_compiler:
        apct = None
    labels = range(g.num_labels)
    res = FSMResult({})
    level = [p.canonical() for p in _seed_patterns(g)]
    seen = set(level)
    while level:
        res.levels += 1
        res.evaluated += len(level)
        supports = _level_supports(g, level, counter, apct, plan_cache,
                                   res, support_fn, count_store)
        survivors = []
        for p in level:
            s = supports[p]
            if s >= min_support:
                res.frequent[p] = s
                survivors.append(p)
            else:
                res.pruned += 1
        nxt = []
        for p in survivors:
            for q in _extensions(p, labels):
                if q in seen:
                    continue
                seen.add(q)
                if q.n > max_vertices:
                    continue
                if max_edges is not None and q.m > max_edges:
                    continue
                nxt.append(q)
        level = nxt
    return res
