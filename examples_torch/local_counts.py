"""Partial-embedding API walkthrough on the PyTorch/CUDA port:
pseudo-clique hotspots and per-vertex motif significance without
materialising a single embedding.

    PYTHONPATH=src python examples_torch/local_counts.py
    PYTHONPATH=src python examples_torch/local_counts.py --device cpu

Both applications read their answers off the decomposition join's cut
tensors — the factor product *before* the final reduce — so the cost is
the same contractions the global count already pays, not an enumeration
of embeddings.  Local counts are f64 tensors on the engine's device.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.api import exists, local_counts, vertex_counts  # noqa: E402
from repro_torch.core.counting import CountingEngine  # noqa: E402
from repro_torch.core.pattern import chain, cycle, tailed_triangle  # noqa: E402,E501
from repro_torch.core.search import mine_pseudo_cliques  # noqa: E402
from repro_torch.graph.generators import triangle_rich  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

graph = triangle_rich(400, 16, seed=7)
engine = CountingEngine(graph, device=args.device)  # shared memo

# --- anchored local counts ------------------------------------------------
# completion counts of the tailed triangle with its tail vertex pinned:
# lc.counts[u] = how many embeddings put the tail at graph vertex u
p = tailed_triangle()
lc = local_counts(p, graph, anchor=3, counter=engine)
print(f"tailed-triangle tails: {int(lc.total()):,} injective maps, "
      f"{int(torch.count_nonzero(lc.counts))} distinct tail vertices "
      f"(route: {lc.style})")

# the full local tensor over the chosen cutting set
lt = local_counts(p, graph, counter=engine)
print(f"local tensor over cut {lt.axes}: shape {tuple(lt.counts.shape)}, "
      f"sum == inj == {int(lt.total()):,}")

# --- pseudo-clique mining (paper §3's PC application) ---------------------
r = mine_pseudo_cliques(graph, 4, missing=1, counter=engine)
total = sum(r.totals.values())
print(f"\n4-pseudo-cliques (one edge short of K4): {total:,.0f}")
print("hotspot vertices (embeddings containing v):")
for u in r.hotspots[:5]:
    print(f"  v{u}: {r.per_vertex[u].item():,.0f}")

# --- per-vertex motif significance ----------------------------------------
# which vertices sit in unusually many 4-cycles relative to 4-chains?
vc_cycle = vertex_counts(cycle(4), graph, counter=engine)
vc_chain = vertex_counts(chain(4), graph, counter=engine)
sig = vc_cycle / vc_chain.clamp(min=1.0)
top = torch.sort(-sig, stable=True).indices[:5].tolist()
print("\n4-cycle significance (cycles per chain) leaders:")
for u in top:
    print(f"  v{u}: {sig[u].item():.3f} "
          f"({vc_cycle[u].item():,.0f} cycles / "
          f"{vc_chain[u].item():,.0f} chains)")

# --- early-exit existence -------------------------------------------------
for q, name in [(cycle(5), "C5"), (tailed_triangle(), "tailed tri")]:
    print(f"{name} exists: {exists(q, graph, counter=engine)}")
