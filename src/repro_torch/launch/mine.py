"""Graph-mining driver: the paper's workloads on synthetic graphs.

  PYTHONPATH=src python -m repro_torch.launch.mine --app motif --k 5 --n 2000
  PYTHONPATH=src python -m repro_torch.launch.mine --app fsm --support 100
  PYTHONPATH=src python -m repro_torch.launch.mine --app chain --k 7
  PYTHONPATH=src python -m repro_torch.launch.mine --app pc --k 7
  PYTHONPATH=src python -m repro_torch.launch.mine --app motif --device cpu

Runs on the CUDA device; ``--device cpu`` asks for the CPU (without it, a
machine with no card raises).  Flags and printed lines are the reference
package's (``python -m repro.launch.mine``).

Counting apps compile the whole pattern set jointly through
``repro_torch.compiler`` (one plan, shared quotient contractions, plan
cache); ``--no-compiler`` keeps the legacy per-pattern engine path, and
``--plan-cache DIR`` persists compiled plans across runs.

``--local-counts`` switches to the partial-embedding API (paper §5):
``chain`` prints the hottest vertices by per-vertex embedding
participation, ``pc`` mines pseudo-clique hotspots through anchored
local-count vectors, and ``existence`` takes the factor-level early
exit.  ``--trace FILE`` attaches one ``obs.Tracer`` to every compiled
plan the run builds (``motif`` and ``chain``) and writes the span tree
there.  ``--mesh N`` (N > 1) compiles the ``motif`` and ``chain`` plans
against ``data_mesh(N, device=<the run's device>)``: N slots on the one
device, with contractions and joins split over them and counts equal to
the run without a mesh.
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch import api, compiler, obs
from repro_torch import device as _device
from repro_torch.core.cliques import pseudo_clique_count
from repro_torch.core.counting import CountingEngine, solve_overlay
from repro_torch.core.engine import MiningEngine
from repro_torch.core.fsm import fsm
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import chain, clique
from repro_torch.core.search import mine_pseudo_cliques
from repro_torch.graph import generators as gen


def build_graph(args):
    if args.graph == "er":
        return gen.erdos_renyi(args.n, args.deg, seed=args.seed,
                               num_labels=args.labels)
    if args.graph == "rmat":
        return gen.rmat(max(int(math.ceil(math.log2(args.n))), 4), args.deg,
                        seed=args.seed, num_labels=args.labels)
    if args.graph == "ws":
        return gen.small_world(args.n, int(args.deg), seed=args.seed,
                               num_labels=args.labels)
    return gen.triangle_rich(args.n, max(args.n // 30, 2), seed=args.seed,
                             num_labels=args.labels)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="motif",
                    choices=["motif", "chain", "pc", "fsm", "existence"])
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--graph", default="er",
                    choices=["er", "rmat", "ws", "tri"])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--deg", type=float, default=8.0)
    ap.add_argument("--labels", type=int, default=0)
    ap.add_argument("--support", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                    "device, raising without one; 'cpu' asks for the CPU)")
    ap.add_argument("--no-compiler", action="store_true",
                    help="legacy per-pattern engine path (no plan IR)")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="persist compiled plans in DIR across runs")
    ap.add_argument("--plan-cache-entries", type=int, default=None,
                    metavar="N", help="cap the on-disk plan store at N "
                    "entries (LRU-by-mtime eviction)")
    ap.add_argument("--local-counts", action="store_true",
                    help="partial-embedding API: per-vertex counts "
                    "(chain), pseudo-clique hotspots (pc), early-exit "
                    "existence")
    ap.add_argument("--top-k", type=int, default=10, metavar="K",
                    help="hottest vertices to report for --local-counts "
                    "(the streaming top-k reader; the full per-vertex "
                    "vector is never returned)")
    ap.add_argument("--verify-plans", action="store_true",
                    help="print the static verifier's report for every "
                         "compiled plan (diagnostics + exact_block "
                         "precertification summary)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record per-node execution spans on compiled "
                    "plans and write the trace to FILE (JSON; a "
                    "*.chrome.json suffix writes chrome://tracing "
                    "format instead)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the process metrics registry "
                    "(counters/gauges/histograms) after the run")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard compiled-plan execution over N slots of "
                    "the run's device (1-D data mesh): Contract nodes run "
                    "sliced over the adjacency's row blocks, CutJoin/"
                    "LocalCount routes split their cut grid — results "
                    "stay bit-for-bit equal to one slot")
    args = ap.parse_args(argv)

    device = args.device
    mesh = None
    if args.mesh is not None and args.mesh > 1:
        from repro_torch.distributed import meshes
        mesh = meshes.data_mesh(args.mesh, device=_device.resolve(device))
        print(f"mesh: {args.mesh} device(s) on axis 'data'")
    tracer = obs.Tracer() if args.trace else None

    def verify_report(cp):
        """Re-verify a compiled plan and print the findings — what an
        operator checks when a served count looks off (the compile path
        already verified; this proves the *cached/loaded* plan still
        does)."""
        if not args.verify_plans:
            return
        from repro_torch import analysis
        res = analysis.verify(cp.plan)
        pre = cp.plan.meta.get("precert") or {}
        guarded = sum(1 for n in cp.plan.nodes.values()
                      if getattr(n, "cut_size", 0) and hasattr(n, "factors"))
        print(f"  verify: {'OK' if res.ok else 'FAILED'} — "
              f"{len(cp.plan.nodes)} nodes, {len(res.errors)} error(s), "
              f"{len(res.warnings)} warning(s); "
              f"{len(pre)}/{guarded} join(s) precertified "
              f"(skip the runtime guard scan)")
        for d in res.diagnostics:
            print(f"    {d}")

    if args.app == "fsm" and args.labels == 0:
        args.labels = 6
    g = build_graph(args)
    print(f"graph: {g}")
    t0 = time.perf_counter()

    plan_cache = None
    if args.plan_cache:
        plan_cache = compiler.PlanCache(
            args.plan_cache, max_disk_entries=args.plan_cache_entries)

    if args.app == "motif":
        pats = motif_patterns(args.k)
        if args.no_compiler:
            eng = MiningEngine(g, device=device)
            cuts = {p: eng.choose_cut(p) for p in pats}
            table = eng.counter.motif_table(args.k, cuts=cuts)
        else:
            cp = compiler.compile(pats, g, cache=plan_cache, mesh=mesh,
                                  device=device)
            cp.tracer = tracer
            t_compile = time.perf_counter() - t0
            e = {p: cp.count(p) for p in pats}
            table = solve_overlay(args.k, e)
            print(f"  compiled {len(pats)} patterns -> "
                  f"{len(cp.plan.nodes)} plan nodes "
                  f"({'cache hit' if cp.from_cache else 'cache miss'}, "
                  f"{t_compile:.2f}s)")
            verify_report(cp)
        for p, v in sorted(table.items(), key=lambda t: t[0].m):
            print(f"  {args.k}-motif m={p.m:2d} {sorted(p.edges)}: "
                  f"{v:,.0f}")
    elif args.app == "chain":
        p = chain(args.k)
        hot = None
        if args.no_compiler:
            eng = MiningEngine(g, device=device)
            c = eng.get_pattern_count(p, use_compiler=False)
            if args.local_counts:
                hot = api.vertex_counts(p, g, counter=eng.counter,
                                        use_compiler=False, top_k=args.top_k)
        else:
            cp = compiler.compile(p, g, cache=plan_cache,
                                  local=args.local_counts, mesh=mesh,
                                  device=device)
            cp.tracer = tracer
            verify_report(cp)
            c = cp.count(p)
            if args.local_counts:
                # the top-k reader straight off the plan just compiled
                # — its node-value memo already holds the anchored
                # orbit vectors, so no recompile and no relowering
                hot = api.top_vertices(api.plan_vertex_counts(cp, p),
                                       args.top_k)
        print(f"  {args.k}-chain (edge-induced): {c:,.0f}")
        if hot is not None:
            print("  hottest vertices (embeddings containing u):")
            for v, u in hot:
                print(f"    v{u}: {v:,.0f}")
    elif args.app == "pc":
        if args.local_counts:
            r = mine_pseudo_cliques(g, args.k, missing=1, device=device)
            tot = sum(r.totals.values())
            print(f"  {args.k}-pseudo-clique (missing=1) embeddings: "
                  f"{tot:,.0f} across {len(r.totals)} patterns")
            print("  hotspots (participation):")
            for u in r.hotspots[:args.top_k]:
                print(f"    v{u}: {r.per_vertex[u].item():,.0f}")
        else:
            total = pseudo_clique_count(g, args.k)
            print(f"  {args.k}-pseudo-clique (k=1) count: {total:,.0f}")
    elif args.app == "existence":
        if args.local_counts:
            eng = CountingEngine(g, device=device)
            for k in range(3, args.k + 1):
                print(f"  K{k} exists: "
                      f"{api.exists(clique(k), g, counter=eng)}")
        else:
            eng = MiningEngine(g, device=device)
            for k in range(3, args.k + 1):
                print(f"  K{k} exists: {eng.pattern_exists(clique(k))}")
    elif args.app == "fsm":
        r = fsm(g, args.support, max_vertices=args.k if args.k >= 2 else 3,
                use_compiler=not args.no_compiler, plan_cache=plan_cache,
                device=device)
        print(f"  frequent patterns: {len(r.frequent)} "
              f"(evaluated {r.evaluated}, pruned {r.pruned}; "
              f"{r.compiled_levels}/{r.levels} levels compiled)")
        for p, s in sorted(r.frequent.items(),
                           key=lambda t: (-t[1], t[0].n))[:10]:
            print(f"    support {s}: n={p.n} edges={sorted(p.edges)} "
                  f"labels={p.labels}")
    print(f"done in {time.perf_counter() - t0:.2f}s")
    if tracer is not None:
        if tracer.roots:
            tracer.save(args.trace)
            cov = tracer.coverage()
            print(f"trace: {args.trace} ({len(tracer.roots)} root spans"
                  + (f", node coverage {cov:.1%}" if cov is not None
                     else "") + ")")
        else:
            print(f"trace: no compiled-plan execution to record "
                  f"(--app {args.app}"
                  + (" --no-compiler" if args.no_compiler else "")
                  + " runs off the traced path)")
    if args.metrics:
        print("metrics:")
        print(obs.dump(indent=2))


if __name__ == "__main__":
    main()
