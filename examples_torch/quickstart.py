"""Quickstart: pattern counting with the DwarvesGraph engine (paper Fig 10),
on the PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/quickstart.py               # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.engine import MiningEngine  # noqa: E402
from repro_torch.core.pattern import Pattern, chain, clique  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

# load the input graph && other initialisations
graph = erdos_renyi(1000, 8.0, seed=0)
print(f"input graph: {graph}")

# the compilation step of the paper: the engine profiles the dataset
# (APCT) and will choose a decomposition per pattern via the cost model
app = MiningEngine(graph, device=args.device)

# --- "three_chain.cc": get_pattern_count --------------------------------
p = chain(3)                                     # construct the 3-chain
print(f"three-chain-count: {app.get_pattern_count(p):,.0f}")

cut = app.choose_cut(p)
print(f"  chosen cutting set: {sorted(cut) if cut else 'direct (fallback)'}")

# a bigger pattern: decomposition beats direct enumeration here
p5 = Pattern(5, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 4)])
print(f"custom 5-pattern count: {app.get_pattern_count(p5):,.0f} "
      f"(cut={sorted(app.choose_cut(p5) or [])})")

# vertex-induced counts via the same-size overlay transform (paper §2.1)
print(f"vertex-induced 3-chain: "
      f"{app.get_pattern_count(p, induced='vertex'):,.0f}")
print(f"triangles: {app.get_pattern_count(clique(3)):,.0f}")

# 4-motif table in one call (cross-pattern computation reuse)
table = app.counter.motif_table(4)
print("4-motif table:")
for q, v in sorted(table.items(), key=lambda t: t[0].m):
    print(f"  m={q.m}: {v:,.0f}")
print(f"hom contractions evaluated: {app.counter.stats['hom_evals']}, "
      f"reused: {app.counter.stats['hom_hits']}")
