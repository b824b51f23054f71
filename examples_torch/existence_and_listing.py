"""Pattern existence query (Fig 14) and counting with bounded embedding
listing (Fig 13), on the PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/existence_and_listing.py
    PYTHONPATH=src python examples_torch/existence_and_listing.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import exists  # noqa: E402
from repro_torch.core.engine import MiningEngine  # noqa: E402
from repro_torch.core.pattern import Pattern, chain, clique, cycle  # noqa: E402,E501
from repro_torch.graph.generators import small_world  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

graph = small_world(500, 6, 0.2, seed=3)
app = MiningEngine(graph, device=args.device)

# --- existence queries (partial-embedding fast path) ----------------------
# api.exists evaluates the decomposition factors one subpattern at a
# time: an all-zero factor decides False before the join or any
# shrinkage correction runs (the early exit); a positive local entry
# decides True.
for p, name in [(clique(3), "triangle"), (clique(5), "K5"),
                (cycle(5), "C5"), (chain(6), "6-chain")]:
    print(f"{name} exists: {exists(p, graph, counter=app.counter)}")

# --- Fig 13: count everything, materialise only the first 100 -----------
pattern = Pattern(4, [(0, 1), (1, 2), (2, 3)])    # 4-chain
num_to_list = 100
listed, total = [], [0]


def process_partial_embedding(pe, count):
    if pe.subpattern_id == 0:
        remained = num_to_list - len(listed)
        if remained > 0:
            listed.extend(app.materialize(pattern, pe,
                                          min(remained, count)))
        total[0] += count


app.run_partial_embeddings(pattern, process_partial_embedding)
print(f"4-chain embedding tuples: {total[0]:,} "
      f"(= {total[0] // pattern.aut_order():,} embeddings)")
print(f"materialised first {len(listed)}; e.g. {listed[:3]}")
check = app.get_pattern_count(pattern) * pattern.aut_order()
print(f"cross-check vs get_pattern_count: {int(check) == total[0]}")
