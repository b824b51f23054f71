"""Joint decomposition-space search (paper §4.3, Fig 23) and the
pseudo-clique miner (paper §3's PC application on the partial-embedding
API).

For an application with n concrete patterns, each with m candidate cutting
sets, the joint space is m^n (cross-pattern reuse couples the choices).
Circulant tuning iterates over patterns round-robin, re-picking each
pattern's cutting set greedily against the *current* assignment of all
others, until a full pass changes nothing — a coordinate-descent local
optimum.  Baselines: independent/separate tuning, random sampling, and
simulated annealing (the paper's comparison set).  The searches run on
the host, over the APCT's estimates; each takes a seeded
``random.Random`` exactly as the reference package's does, so on the same
APCT they return the same cuts.

``mine_pseudo_cliques`` is the advanced-app consumer of the
partial-embedding API: per-vertex participation counts of every k-clique-
minus-``missing``-edges pattern, read off anchored local-count vectors
(one per automorphism orbit per pattern) instead of materialised
embeddings — the hotspot ranking Peregrine-style systems pay a full
enumeration for.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import cost_model as CM
from repro_torch.core.decomposition import candidates
from repro_torch.core.pattern import pseudo_clique


@dataclass
class SearchResult:
    cuts: list                       # chosen cutting set per pattern
    cost: float
    search_time_s: float
    evals: int = 0
    history: list = field(default_factory=list)   # (time, best_cost)


def _cost(patterns, cuts, apct, n) -> float:
    return CM.application_cost(list(zip(patterns, cuts)), apct, n)


def separate_tuning(patterns, apct, n) -> SearchResult:
    """Tune each pattern independently (no reuse awareness)."""
    t0 = time.perf_counter()
    cuts, evals = [], 0
    for p in patterns:
        best, bc = None, math.inf
        for cand in candidates(p):
            c = CM.pattern_cost(p, cand, apct, n)
            evals += 1
            if c < bc:
                best, bc = cand, c
        cuts.append(best)
    return SearchResult(cuts, _cost(patterns, cuts, apct, n),
                        time.perf_counter() - t0, evals)


def independent_sampling(patterns, apct, n, num_samples: int = 64,
                         seed: int = 0) -> SearchResult:
    t0 = time.perf_counter()
    rng = random.Random(seed)
    cands = [candidates(p) for p in patterns]
    best, bc = None, math.inf
    hist = []
    for _ in range(num_samples):
        cuts = [rng.choice(cs) for cs in cands]
        c = _cost(patterns, cuts, apct, n)
        if c < bc:
            best, bc = cuts, c
        hist.append((time.perf_counter() - t0, bc))
    return SearchResult(best, bc, time.perf_counter() - t0, num_samples, hist)


def circulant_tuning(patterns, apct, n, init=None,
                     max_rounds: int = 20) -> SearchResult:
    """Algorithm of Fig 23: round-robin coordinate descent over the joint
    cutting-set assignment until convergence."""
    t0 = time.perf_counter()
    cands = [candidates(p) for p in patterns]
    cuts = (list(init) if init is not None
            else separate_tuning(patterns, apct, n).cuts)
    best = _cost(patterns, cuts, apct, n)
    evals = 0
    hist = [(time.perf_counter() - t0, best)]
    for _ in range(max_rounds):
        converged = True
        for i, p in enumerate(patterns):
            previous = cuts[i]
            for cand in cands[i]:
                if cand == cuts[i]:
                    continue
                backup = cuts[i]
                cuts[i] = cand
                c = _cost(patterns, cuts, apct, n)
                evals += 1
                if c < best:
                    best = c
                    hist.append((time.perf_counter() - t0, best))
                else:
                    cuts[i] = backup
            if cuts[i] != previous:
                converged = False
        if converged:
            break
    return SearchResult(cuts, best, time.perf_counter() - t0, evals, hist)


def simulated_annealing(patterns, apct, n, steps: int = 300,
                        t_start: float = 2.0, seed: int = 0) -> SearchResult:
    t0 = time.perf_counter()
    rng = random.Random(seed)
    cands = [candidates(p) for p in patterns]
    cuts = [rng.choice(cs) for cs in cands]
    cur = _cost(patterns, cuts, apct, n)
    best, bcuts = cur, list(cuts)
    hist = [(time.perf_counter() - t0, best)]
    for s in range(steps):
        temp = t_start * (1 - s / steps) + 1e-3
        i = rng.randrange(len(patterns))
        old = cuts[i]
        cuts[i] = rng.choice(cands[i])
        c = _cost(patterns, cuts, apct, n)
        if c < cur or rng.random() < math.exp(min((cur - c) / (abs(cur) * temp
                                                              + 1e-9), 0)):
            cur = c
            if c < best:
                best, bcuts = c, list(cuts)
                hist.append((time.perf_counter() - t0, best))
        else:
            cuts[i] = old
    return SearchResult(bcuts, best, time.perf_counter() - t0, steps, hist)


def genetic(patterns, apct, n, pop: int = 16, gens: int = 12,
            seed: int = 0) -> SearchResult:
    """Genetic baseline (paper §4.3): uniform crossover + point mutation
    over the joint cutting-set assignment."""
    t0 = time.perf_counter()
    rng = random.Random(seed)
    cands = [candidates(p) for p in patterns]

    def rand_ind():
        return [rng.choice(cs) for cs in cands]

    popl = [rand_ind() for _ in range(pop)]
    scored = [(_cost(patterns, ind, apct, n), ind) for ind in popl]
    evals = pop
    hist = [(time.perf_counter() - t0, min(s for s, _ in scored))]
    for g in range(gens):
        scored.sort(key=lambda t: t[0])
        elite = [ind for _, ind in scored[:pop // 4]]
        children = list(elite)
        while len(children) < pop:
            a, b = rng.sample(elite, 2) if len(elite) >= 2 else (elite[0],
                                                                 elite[0])
            child = [x if rng.random() < 0.5 else y for x, y in zip(a, b)]
            if rng.random() < 0.5:
                i = rng.randrange(len(child))
                child[i] = rng.choice(cands[i])
            children.append(child)
        scored = [(_cost(patterns, ind, apct, n), ind) for ind in children]
        evals += len(children)
        hist.append((time.perf_counter() - t0, min(s for s, _ in scored)))
    best, ind = min(scored, key=lambda t: t[0])
    return SearchResult(ind, best, time.perf_counter() - t0, evals, hist)


METHODS = {
    "separate": separate_tuning,
    "random": independent_sampling,
    "circulant": circulant_tuning,
    "annealing": simulated_annealing,
    "genetic": genetic,
}


# -- pseudo-clique mining off the partial-embedding API ---------------------------

@dataclass
class PseudoCliqueResult:
    """Per-vertex pseudo-clique participation.  ``per_vertex[u]`` (an f64
    tensor on the engine's device) is the number of edge-induced
    embeddings across all k-clique-minus-``missing``-edges patterns that
    contain graph vertex u; ``totals[pattern]`` the global count per
    pattern; ``hotspots`` the vertices with ``per_vertex >= min_count``,
    highest first (ties by vertex id)."""
    k: int
    missing: int
    per_vertex: torch.Tensor
    totals: dict
    hotspots: list


def mine_pseudo_cliques(graph, k: int, missing: int = 1, *,
                        min_count: int = 1, counter=None, cache=None,
                        use_compiler: bool = True,
                        device=None) -> PseudoCliqueResult:
    """Mine pseudo-cliques (k-cliques with ``missing`` edges deleted)
    through anchored local counts: each pattern contributes one anchored
    vector per automorphism orbit — the completion counts with that
    orbit pinned per graph vertex — weighted into per-vertex embedding
    participation (``api.vertex_counts``).  No embedding is ever
    materialised; the global count falls out of the same vectors
    (Σ_u vertex_counts[u] = n_p · #embeddings, exactly).  A shared
    ``CountingEngine`` CSE-merges the patterns' quotient contractions,
    and ``cache=None`` (the process plan cache) makes repeat mines
    compile-free.  ``device=None`` means the CUDA device (a ``counter``
    brings its own).
    """
    from repro_torch.api import vertex_counts
    from repro_torch.core.counting import CountingEngine
    counter = counter or CountingEngine(graph, device=device)
    pats = pseudo_clique(k, missing)
    per_vertex = torch.zeros(graph.n, dtype=torch.float64,
                             device=counter.device)
    totals = {}
    for p in pats:
        vc = vertex_counts(p, graph, counter=counter, cache=cache,
                           use_compiler=use_compiler)
        per_vertex += vc
        totals[p] = vc.sum().item() / p.n
    # vertex ids ascending, then a stable sort by value descending
    hot = torch.nonzero(per_vertex >= min_count).flatten()
    hot = hot[torch.sort(-per_vertex[hot], stable=True).indices]
    return PseudoCliqueResult(k, missing, per_vertex, totals, hot.tolist())
