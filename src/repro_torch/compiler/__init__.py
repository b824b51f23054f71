"""Pattern-to-plan compiler: DwarvesGraph's compilation tier.

The paper's headline design is *compilation-based* graph pattern mining:
generate candidate algorithms for every decomposition choice, cost them
with an accurate model, and ship the best one as an executable.  This
package is that tier, as a pipeline of stages:

    pattern set ──frontend──► candidate plan IR fragments
                 (decomposition.candidates × homomorphism orders,
                  CutJoin/Shrinkage decomposition joins)
    fragments  ──costing───► winning joint plan
                 (APCT cost model, cross-pattern CSE: shared quotient
                  contractions scheduled once across the application)
    plan IR    ──lowering──► executables on one device
                 (CountingEngine einsum contractions, clique ordered
                  enumeration, the CUDA join and triangle kernels)
    plan IR    ──cache─────► keyed by (canonical pattern set, graph
                  signature): compile once, execute many

Vertex labels are first-class through every stage: labelled patterns
generate the same candidate space (decomposition joins included — the
label mask lives inside each CutJoin factor, so the |cut| <= 3 kernel
tiers run unchanged), costing scales count bounds by label selectivity,
and lowering binds the pattern's label indices to the bound graph's
one-hot indicator rows at plan-bind time — one plan serves any graph
with a compatible label alphabet (out-of-alphabet labels bind to the
zero vector).

``compile(patterns, graph)`` is the single entry point; it returns a
``CompiledPlan`` whose ``.plan`` is the serializable IR (``to_json``,
byte-compatible with the reference package's) and whose ``.count(p)`` /
``.counts()`` execute it on the CUDA device (``device="cpu"`` to ask
for the CPU).  With ``domains=True`` the plan additionally carries FSM
MINI-domain nodes served by ``.domains(p)`` / ``.mini_support(p)``; with
``local=True`` it carries the partial-embedding outputs (paper §5)
served by ``.local_counts(p, anchor)`` / ``.exists(p)`` — see
``repro_torch.api``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Union

import numpy as np

from repro_torch import device as _device
from repro_torch.core.pattern import Pattern
from repro_torch.graph.storage import Graph
from repro_torch.compiler import costing, frontend
from repro_torch.compiler import morph as _morph
from repro_torch.compiler.cache import (PlanCache, config_compatible,
                                        graph_signature, plan_key)
from repro_torch.compiler.ir import Plan, local_key, pattern_key
from repro_torch.compiler.lowering import CompiledPlan, lower
from repro_torch.compiler.morph import CountStore, default_store
from repro_torch.distributed import meshes as _meshes

__all__ = ["compile", "Plan", "PlanCache", "CompiledPlan", "CountStore",
           "pattern_key", "plan_key", "local_key", "default_cache",
           "default_store", "config_compatible"]

_DEFAULT_CACHE = PlanCache()


def default_cache() -> PlanCache:
    """The process-wide plan cache used when ``compile(cache=None)``."""
    return _DEFAULT_CACHE


def _label_fracs(patterns, graph):
    """label -> vertex fraction of the bound graph, for selectivity
    pricing; None unless a labelled pattern meets a labelled graph."""
    if graph.labels is None or all(p.labels is None for p in patterns):
        return None
    counts = np.bincount(graph.labels, minlength=graph.num_labels)
    return {l: counts[l] / max(graph.n, 1) for l in range(graph.num_labels)}


def _add_local_outputs(plan, patterns, graph, apct, budget, counter,
                       label_fracs, max_cutjoin_cut, node_costs=None):
    """Partial-embedding outputs for every pattern: the unanchored local
    tensor (cheapest eligible cutting set, absent for cliques) plus one
    anchored vector per automorphism orbit (decomposed when a cut
    contains the orbit, flat Möbius otherwise).  Candidates are priced
    against the committed count plan's node pool, so local plans
    preferentially ride the cut tensors the counts already materialise
    — partial embeddings off the decomposition join, not a second
    pipeline."""
    shared = {k: 0.0 for k in plan.nodes}
    local_cuts = {}

    def pick(cands):
        best, bc = None, math.inf
        for cand in cands:
            c = costing.candidate_cost(cand, apct, graph.n, shared, budget,
                                       counter, label_fracs)
            if c < bc:
                best, bc = cand, c
        if best is None and cands:
            # every candidate prices infinite (genuinely too wide for the
            # budget): keep the last candidate (anchored: the flat Möbius
            # fallback) so the output exists, but do NOT commit its nodes
            # to the shared pool — mirroring select_candidates, execution
            # chunks or raises PlanTooWide and callers fall back.
            best = cands[-1]
            for node in best.nodes:
                plan.add(node)
            return best
        if best is not None:
            costing.commit(best, apct, graph.n, shared, budget, counter,
                           label_fracs)
            for node in best.nodes:
                plan.add(node)
            if node_costs is not None:
                # setdefault: the seeded 0.0 of already-committed count
                # nodes must not overwrite their real selection cost
                for node in best.nodes:
                    node_costs.setdefault(node.key, shared[node.key])
        return best

    for p in patterns:
        # every local candidate — unanchored AND anchored — is built on
        # the CANONICAL form: the unanchored key collapses isomorphic
        # renumberings, so its axes must name canonical vertices; anchored
        # node keys embed local vertex ids under the canonical
        # ``pattern_key`` namespace, so one numbering per plan makes equal
        # keys mean equal content.  Anchored *values* are numbering-
        # invariant, so serving the canonical rep's vector for the
        # instance anchor is exact.
        pc = p.canonical()
        perm = p.canonical_perm()            # old (instance) -> canonical
        cand = pick(frontend.local_candidates(pc, graph_n=graph.n,
                                              budget=budget,
                                              max_cut=max_cutjoin_cut))
        if cand is not None:
            plan.set_local_output(pc, cand.out_key)
            local_cuts[local_key(pc)] = sorted(cand.cut)
        for orbit in p.vertex_orbits():
            cand = pick(frontend.local_candidates(
                pc, graph_n=graph.n, anchor=perm[orbit[0]], budget=budget,
                max_cut=max_cutjoin_cut))
            plan.set_local_output(p, cand.out_key, anchor=orbit[0])
            local_cuts[local_key(p, orbit[0])] = (sorted(cand.cut)
                                                  if cand.cut else None)
    plan.meta["local_cuts"] = local_cuts


def compile(patterns: Union[Pattern, Iterable[Pattern]], graph: Graph, *,
            apct=None, counter=None, cache: Optional[PlanCache] = None,
            budget: int = 1 << 27, max_cutjoin_cut: int = 3,
            use_pallas: bool = False, cutjoin_kernel: bool = True,
            domains: bool = False, local: bool = False,
            verify: bool = True, mesh=None, morph=False,
            device=None) -> CompiledPlan:
    """Compile a pattern (or application pattern set) for one graph.

    Cache hit: deserialise the stored plan and lower it (no search).
    Cache miss: build candidates per pattern, pick the joint winner under
    the shared-pool cost model, store the plan, lower it.

    ``device=None`` binds the plan to the CUDA device and raises when
    there is none; pass ``device="cpu"`` to run on the CPU.

    ``max_cutjoin_cut=3`` (the default) emits decomposition-join
    candidates up to the tri-join kernel tier: |cut| = 3 joins use the
    axis-subset form (each factor spans only the cut vertices its
    subpattern touches) and the cost model's factor-tensor budget
    decides — per graph — whether a 3-D-factor formulation fits or the
    selection falls back to pair-only / |cut| <= 2 / dense candidates.

    ``cache=False`` disables caching; ``cache=None`` uses the process
    cache.  ``apct``/``counter`` let callers share their profiling table
    and hom memo with the compiled plan — the counter's materialised
    hom/free-hom memos also feed costing, so re-compiles against a warm
    engine prefer decompositions whose cut tensors already exist.
    ``cutjoin_kernel=False`` keeps CutJoin and LocalCount on the dense
    f64 routes (``_join_reduce`` / ``_join_keep``).  ``use_pallas=True``
    counts triangles (``Intersect`` k = 3) with the fused CUDA kernel
    Σ A ⊙ (A @ A) instead of host clique enumeration (the name is the
    reference package's).

    ``domains=True`` additionally emits FSM MINI-domain nodes per
    pattern (one free-hom Möbius combination per automorphism orbit),
    served by ``CompiledPlan.domains`` / ``.mini_support``.
    ``local=True`` additionally emits partial-embedding outputs (the
    paper's §5 API): per pattern, the unanchored local-count tensor over
    its cheapest eligible cutting set plus one anchored vector per
    automorphism orbit, served by ``CompiledPlan.local_counts`` /
    ``.exists``; ``plan.meta["local_cuts"]`` records each output's cut.
    A cached plan lacking a requested flavour misses and recompiles with
    the union of the requested and the stored flags; the converse hit is
    fine — such nodes are lazy.

    ``verify=True`` (the default) statically verifies every freshly
    assembled plan *before* it is cached or lowered
    (``repro_torch.analysis.verify``): a frontend/costing bug that emits
    malformed IR raises ``PlanVerifyError`` at compile time instead of
    poisoning the cache, joins the degree bound precertifies skip the
    runtime ``exact_block`` guard scan (``plan.meta["precert"]``), and
    joins that could never take the kernel route are flagged to the
    metrics registry (``analysis.always_refused``).

    ``morph`` turns the pattern-morphing count algebra on
    (``compiler.morph``): ``True`` uses the process-wide
    ``default_store()``, or pass a ``CountStore``.  Before searching,
    every query pattern is expanded over the store's held counts
    (inclusion–exclusion over the pattern lattice); when the whole query
    set closes algebraically the compiler skips candidate search and
    serves a direct-shaped plan whose hom reads come back from the store
    (``plan.meta["morph"]``, route ``morph-derive``, ``obs`` counter
    ``morph.hits``): zero contractions and no kernel launch.  Partially
    closed queries still search, but held homs price at 0
    (``costing.select_candidates(held=)``) and are served from the store
    at execution; each pattern with missing homs counts
    ``morph.missing_compiles``.  Every count read of the returned plan
    harvests its exact scalars back into the store.  Morph-compiled
    plans are never written to the plan cache (their selection is
    store-biased), and ``morph=False`` (the default) changes nothing.

    ``mesh`` (a ``distributed.meshes.DataMesh``, e.g. ``data_mesh(4,
    device="cuda")``) binds the plan to the sharded tier end to end:
    Contract nodes of the default engine run sliced over the mesh's slots
    (``distributed/contract.py`` — the n x n adjacency never exists
    whole), guarded CutJoin/LocalCount nodes split their cut grid over cut
    axis 0 (``distributed/cutjoin.py``), all bit-for-bit identical to one
    device, and selection prices contractions and joins per slot with a
    collective surcharge (``costing``, ``devices=``).  Without ``device``
    or ``counter`` the plan lives on the mesh's first slot.  The mesh does
    not enter the cache key, but its slot count (``plan.meta
    ["mesh_devices"]``) is part of the compatibility check on a hit
    (``cache.config_compatible``): a plan selected for one slot count is
    not served to another.
    """
    if isinstance(patterns, Pattern):
        patterns = (patterns,)
    patterns = tuple(patterns)
    if not patterns:
        raise ValueError("compile() needs at least one pattern")

    if counter is not None:
        budget = counter.budget              # cost exactly what will execute
        device = counter.device
    elif device is None and mesh is not None:
        device = mesh.home
    device = _device.resolve(device)
    use_cache = cache is not False
    if cache is None:
        cache = _DEFAULT_CACHE
    morph_store = None
    if morph is not False and morph is not None:
        morph_store = (morph if isinstance(morph, _morph.CountStore)
                       else _morph.default_store())
    mesh_devices = _meshes.num_shards(mesh)
    key = plan_key(patterns, graph)
    if use_cache:
        plan = cache.get(key)
        # a stored plan is only valid under the compile configuration
        # that selected it — budget, max_cutjoin_cut, and the execution
        # mesh's device count (see cache.config_compatible); a
        # cross-config hit recompiles instead of serving a plan the
        # executor must refuse.  A domains=True / local=True request
        # needs those nodes present; a plan that has them serves plain
        # requests unchanged.
        if plan is not None and config_compatible(
                plan, budget=budget, max_cutjoin_cut=max_cutjoin_cut,
                mesh_devices=mesh_devices):
            if (not domains or plan.meta.get("domains")) \
                    and (not local or plan.meta.get("local")):
                return lower(plan, graph, counter=counter,
                             use_pallas=use_pallas, from_cache=True,
                             budget=budget, cutjoin_kernel=cutjoin_kernel,
                             mesh=mesh, count_store=morph_store,
                             device=device)
            # config matches but the stored plan lacks a requested
            # flavour: recompile with the UNION of requested and stored
            # flags, so the overwrite supersets the entry instead of
            # ping-ponging between domains-only and local-only plans on
            # alternating request kinds
            domains = domains or bool(plan.meta.get("domains"))
            local = local or bool(plan.meta.get("local"))

    held = None
    if morph_store is not None:
        from repro_torch import obs
        gsig = graph_signature(graph)
        derived = [_morph.derive(p, morph_store, gsig) for p in patterns]
        if all(d.complete for d in derived) and not domains and not local:
            # the whole query set closes algebraically over held counts:
            # skip candidate search and serve the direct-shaped plan —
            # lowering answers every hom node from the store (route
            # "morph-derive"), so no contraction runs
            for _ in patterns:
                obs.counter("morph.hits")
            plan = frontend.assemble(
                [(p, frontend.direct_candidate(p)) for p in patterns])
            plan.meta.update({
                "key": key, "budget": budget,
                "max_cutjoin_cut": max_cutjoin_cut,
                "mesh_devices": mesh_devices,
                "domains": False, "local": False,
                "estimated_cost": 0.0, "morph": True,
                "styles": {pattern_key(p): "morph" for p in patterns},
                "cuts": {pattern_key(p): None for p in patterns},
            })
            if verify:
                from repro_torch import analysis
                ginfo = analysis.GraphInfo.from_graph(graph)
                plan.meta["graph_info"] = ginfo.to_dict()
                analysis.verify(plan, graph_info=ginfo,
                                budget=budget).raise_if_failed()
            return lower(plan, graph, counter=counter,
                         use_pallas=use_pallas, from_cache=False,
                         budget=budget, cutjoin_kernel=cutjoin_kernel,
                         mesh=mesh, count_store=morph_store, device=device)
        for d in derived:
            if d.missing:
                obs.counter("morph.missing_compiles")
        # partial closure (or a domains/local request): search, with the
        # held hom pool priced at 0 and served from the store
        held = morph_store.held_hom_keys(gsig)

    if apct is None:
        from repro_torch.core.apct import APCT
        apct = APCT(graph)
    per_pattern = [(p, frontend.pattern_candidates(
        p, graph_n=graph.n, budget=budget,
        max_cutjoin_cut=max_cutjoin_cut)) for p in patterns]
    label_fracs = _label_fracs(patterns, graph)
    node_costs: dict = {}
    selections, total_cost = costing.select_candidates(
        per_pattern, apct, graph.n, budget, counter=counter,
        label_fracs=label_fracs, node_costs=node_costs,
        devices=mesh_devices, held=held)
    plan = frontend.assemble(selections)
    if domains:
        for p in patterns:
            for node in frontend.domain_candidate(p).nodes:
                plan.add(node)
    if local:
        _add_local_outputs(plan, patterns, graph, apct, budget, counter,
                           label_fracs, max_cutjoin_cut,
                           node_costs=node_costs)
    plan.meta.update({
        "key": key,
        "budget": budget,
        "max_cutjoin_cut": max_cutjoin_cut,
        "mesh_devices": mesh_devices,
        "domains": domains,
        "local": local,
        "estimated_cost": total_cost,
        # per-node APCT predictions for committed nodes; uncommitted
        # fallback nodes and inf-priced entries carry no prediction
        "node_costs": {k: v for k, v in node_costs.items()
                       if k in plan.nodes and math.isfinite(v)},
        "styles": {pattern_key(p): cand.style for p, cand in selections},
        "cuts": {pattern_key(p): sorted(cand.cut) if cand.cut else None
                 for p, cand in selections},
    })
    if verify:
        from repro_torch import analysis, obs
        ginfo = analysis.GraphInfo.from_graph(graph)
        # graph statistics ride in meta so cached plans re-verify their
        # budget pass without the graph; the precert copy is advisory —
        # lowering recomputes the certificate from the graph it actually
        # binds, never trusting cached meta
        plan.meta["graph_info"] = ginfo.to_dict()
        result = analysis.verify(plan, graph_info=ginfo, budget=budget)
        result.raise_if_failed()
        plan.meta["precert"] = dict(result.precert)
        for diag in result.warnings:
            if diag.code == "always-refused":
                obs.counter("analysis.always_refused")
    if use_cache and morph_store is None:
        # store-biased selections never enter the shared plan cache: a
        # later morph=False compile must behave as if morphing never was
        cache.put(key, plan)
    return lower(plan, graph, counter=counter, use_pallas=use_pallas,
                 from_cache=False, budget=budget,
                 cutjoin_kernel=cutjoin_kernel, mesh=mesh,
                 count_store=morph_store, device=device)
