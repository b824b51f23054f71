"""FSM with MINI support on a labelled graph (paper §3 Fig 15/16), on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/fsm_mining.py
    PYTHONPATH=src python examples_torch/fsm_mining.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.counting import CountingEngine  # noqa: E402
from repro_torch.core.engine import MiningEngine  # noqa: E402
from repro_torch.core.fsm import fsm, mini_support  # noqa: E402
from repro_torch.graph.generators import triangle_rich  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

graph = triangle_rich(600, 20, seed=7, num_labels=4)
print(f"labelled input graph: {graph}")

for support in (200, 60, 20):
    r = fsm(graph, min_support=support, max_vertices=3, device=args.device)
    print(f"support >= {support}: {len(r.frequent)} frequent patterns "
          f"({r.evaluated} evaluated, {r.pruned} pruned by downward closure)")
for p, s in sorted(r.frequent.items(), key=lambda t: -t[1])[:6]:
    print(f"  support {s}: edges={sorted(p.edges)} labels={p.labels}")

# the Fig 15 UDF path computes the same MINI support through the
# partial-embedding programming model:
p = sorted(r.frequent, key=lambda q: (-q.n, sorted(q.edges)))[0]
eng = MiningEngine(graph, device=args.device)
domains = [set() for _ in range(p.n)]


def udf(pe, count):
    if count > 0:
        for i, v in pe.determined:
            domains[i].add(v)


eng.run_partial_embeddings(p, udf)
udf_support = min(len(d) for d in domains)
tensor_support = mini_support(CountingEngine(graph, device=args.device), p)
print(f"UDF-path MINI support = {udf_support}, "
      f"tensor-path = {tensor_support} (must match: "
      f"{udf_support == tensor_support})")
assert udf_support == tensor_support
