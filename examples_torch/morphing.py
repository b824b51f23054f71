"""Pattern-morphing count algebra on the PyTorch/CUDA port: serve a motif
family from the store.

Warm a ``CountStore`` with a few compiled plans (every
``CompiledPlan.count`` read harvests the scalar homs and injective counts
its plan materialised), then ask for every size-4 connected motif.
Members whose inclusion–exclusion identity closes over the held counts
are served *algebraically* — the compile fast path skips decomposition
search and contraction entirely — while the rest fall back to a normal
search with held homs priced at 0 by the cost model.

    PYTHONPATH=src python examples_torch/morphing.py
    PYTHONPATH=src python examples_torch/morphing.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import analysis, compiler, obs  # noqa: E402
from repro_torch.compiler import morph  # noqa: E402
from repro_torch.compiler.cache import graph_signature  # noqa: E402
from repro_torch.core.pattern import Pattern, chain  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

graph = erdos_renyi(200, 6.0, seed=1)
gsig = graph_signature(graph)
store = morph.CountStore()          # in-memory; pass a path to persist

# --- 1. warm the store with three 5-vertex plans --------------------------
gem = Pattern(5, [(0, 1), (1, 2), (2, 3), (0, 4), (1, 4), (2, 4), (3, 4)])
tailed_c4 = Pattern(5, [(0, 1), (1, 2), (2, 3), (0, 3), (3, 4)])
for p in (chain(5), gem, tailed_c4):
    cp = compiler.compile((p,), graph, cache=False, morph=store,
                          device=args.device)
    print(f"warm  {p!r:48s} count = {cp.count(p):,.0f}")
print(f"store now holds {len(store)} exact counts "
      f"({sorted(store.held_hom_keys(gsig))})")

# --- 2. serve the whole size-4 motif family -------------------------------
print(f"\n{'pattern':14s} {'count':>14s}  route")
for p in morph.motif_family(4):
    cp = compiler.compile((p,), graph, cache=False, morph=store,
                          device=args.device)
    route = ("algebraic (no search, no contraction)"
             if cp.plan.meta.get("morph") else "compiled (fell back)")
    name = f"{p.n}v/{p.m}e"
    print(f"{name:14s} {cp.count(p):14,.0f}  {route}")

print(f"\nmorph.hits = {int(obs.get('morph.hits', 0.0))}, "
      f"morph.derivations = {int(obs.get('morph.derivations', 0.0))}, "
      f"morph.missing_compiles = "
      f"{int(obs.get('morph.missing_compiles', 0.0))}")

# --- 3. what a derivation looks like --------------------------------------
wedge = chain(3)
cand = morph.derive(wedge, store, gsig)
terms = " ".join(f"{c:+d}*hom({q.n}v/{q.m}e)" for c, q in cand.terms)
print(f"\ninj(wedge) = {terms};  count = inj / {cand.divisor} "
      f"= {cand.value:,d}")
print(f"morph_check: ok = {analysis.morph_check(cand).ok}")

# --- 4. coverage frontier -------------------------------------------------
fam5 = morph.motif_family(5)
served = [p for p in fam5 if morph.derive(p, store, gsig).complete]
print(f"\nsize-5 family determined by the same store: "
      f"{len(served)}/{len(fam5)}")
