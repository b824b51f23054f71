"""Mesh-sharded mining on the PyTorch/CUDA port: the decomposition join
spread over the slots of a 1-D ``("data",)`` mesh.

    PYTHONPATH=src python examples_torch/mesh_mining.py          # 8 slots, card
    PYTHONPATH=src python examples_torch/mesh_mining.py --device cpu --slots 4

Three layers ride the same mesh:

* sliced adjacency — an engine bound with ``mesh=`` holds the graph's
  adjacency as per-slot row blocks (``repro_torch.distributed.contract``):
  Contract nodes contract each slot's slice and sum the slots' partials,
  and the dense n x n adjacency is never built;
* block-sharded joins — a plan compiled with ``mesh=`` routes its
  CutJoin/LocalCount nodes through ``repro_torch.distributed.cutjoin``:
  every factor is sliced along cut axis 0, each slot reduces its rows
  with the same guarded kernels (on the card: K1–K4, K4-keep), and the
  f64 partials are added in slot order.  Counts are bit-for-bit identical
  to one device — the exactness guard makes every partial an exact
  integer, and f64 integer addition is associative below 2^53;
* data-parallel serving — ``PatternQueryBatcher(mesh=...)`` fans a
  step's requests over the slots.

The slots all sit on the one device named by ``--device`` (the
counterpart of the reference's forced host devices): on one card this
runs the sharded path for real and measures its cost, not a speed-up.
``data_mesh(N)`` without ``device=`` puts one slot on each of N cards.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import compiler, device as _device, obs  # noqa: E402
from repro_torch.core.counting import CountingEngine  # noqa: E402
from repro_torch.core.motifs import motif_patterns  # noqa: E402
from repro_torch.core.pattern import cycle  # noqa: E402
from repro_torch.distributed import meshes  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.serve.batching import PatternQueryBatcher, PatternRequest  # noqa: E402,E501

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of every slot (default: the CUDA "
                "device; 'cpu' asks for the CPU)")
ap.add_argument("--slots", type=int, default=8,
                help="mesh slots on the device (default 8)")
args = ap.parse_args()

device = _device.resolve(args.device)
graph = erdos_renyi(400, 8.0, seed=1)
mesh = meshes.data_mesh(args.slots, device=device)
print(f"graph: {graph}; mesh: {meshes.num_shards(mesh)} slot(s) on {device}")

# --- the adjacency itself split over the mesh -----------------------------
shard_engine = CountingEngine(graph, mesh=mesh)   # adjacency row blocks
t = shard_engine.hom_free_tensor(cycle(4), free=(0, 1))
assert shard_engine._A_dense is None      # no n x n adjacency, ever
print(f"C4 cut tensor contracted over the slots: shape {tuple(t.shape)}")

# --- one plan, contractions + joins sharded over the mesh -----------------
patterns = motif_patterns(4)
tracer = obs.Tracer()
cp = compiler.compile(patterns, graph, counter=shard_engine, cache=False,
                      mesh=mesh)
cp.tracer = tracer
single = compiler.compile(patterns, graph,
                          counter=CountingEngine(graph, device=device),
                          cache=False)
for p in patterns:
    got, ref = cp.count(p), single.count(p)
    assert got == ref, (p, got, ref)      # bit-for-bit, not approximately
    print(f"  {p.n}-vertex motif m={p.m}: {got:,.0f}")
print(f"{len(patterns)} motif counts match one device bit-for-bit")
assert shard_engine._A_dense is None

routes = {}
for span in tracer.walk():
    r = span.attrs.get("route")
    if r:
        routes[r] = routes.get(r, 0) + 1
print(f"routes taken: {routes}")          # kernel-sharded where granted
if args.slots > 1:
    assert "kernel-sharded" in routes, routes

# --- serving requests fanned over the slots -------------------------------
batcher = PatternQueryBatcher(graph, mesh=mesh)
for uid in range(8):
    batcher.submit(PatternRequest(uid=uid, patterns=(cycle(4),)))
batcher.run_to_completion()
counts = {req.uid: next(iter(req.counts.values()))
          for req in batcher.finished}
assert len(set(counts.values())) == 1     # same graph, same answer
print(f"served {len(counts)} requests; C4 count {counts[0]:,.0f}")
print(f"batcher stats: steps={batcher.stats['steps']} "
      f"compiles={batcher.stats['compiles']} "
      f"cache_hits={batcher.stats['cache_hits']}")
