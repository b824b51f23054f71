"""Static plan verification and exact_block precertification, on the
PyTorch/CUDA port.

1. a corrupted cache entry — one flipped byte that still parses as valid
   JSON — is rejected by the structural verifier at load time instead of
   lowering and serving a wrong count;
2. plans whose factor magnitudes the degree-bound abstract interpreter
   certifies at compile time skip the per-evaluation guard scan (visible
   in the trace), bit-for-bit with the dense route.

    PYTHONPATH=src python examples_torch/verify_plans.py
    PYTHONPATH=src python examples_torch/verify_plans.py --device cpu
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import analysis, compiler, obs  # noqa: E402
from repro_torch.compiler.cache import PlanCache  # noqa: E402
from repro_torch.compiler.ir import Plan  # noqa: E402
from repro_torch.core.counting import CountingEngine  # noqa: E402
from repro_torch.core.pattern import cycle  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

graph = erdos_renyi(200, 8.0, seed=5)
pattern = cycle(4)

# --- compile; the verifier runs before the plan is committed --------------
cp = compiler.compile(pattern, graph,
                      counter=CountingEngine(graph, device=args.device),
                      cache=False)
result = analysis.verify(cp.plan)           # meta carries graph + budget
print(f"plan: {len(cp.plan.nodes)} nodes, verify "
      f"{'OK' if result.ok else 'FAILED'} "
      f"({len(result.errors)} errors, {len(result.warnings)} warnings)")

# --- precertification: which joins never need the runtime guard ----------
pre = cp.plan.meta["precert"]
print(f"precertified joins: {pre or '(none)'}")

tracer = obs.Tracer()
cp.tracer = tracer
count = cp.count(pattern)
scans = [s for s in tracer.walk() if s.kind == "guard-scan"]
print(f"count = {count:,.0f}; guard-scan spans in trace: {len(scans)}")

oracle = compiler.compile(pattern, graph,
                          counter=CountingEngine(graph, device=args.device),
                          cache=False, cutjoin_kernel=False)
same = count == oracle.count(pattern)
print(f"bit-for-bit with the dense f64 route: {same}")
assert same

# --- cache corruption: a bit-flip the schema cannot see ------------------
with tempfile.TemporaryDirectory() as d:
    cache = PlanCache(d)
    cache.put("demo", cp.plan)
    (entry,) = list(pathlib.Path(d).glob("plan-*"))

    data = bytearray(entry.read_bytes())
    i = bytes(data).index(b'"cut_size": 2') + len(b'"cut_size": ')
    data[i] ^= 0x01                          # '2' -> '3': still valid JSON
    entry.write_bytes(bytes(data))
    json.loads(entry.read_text())            # parses fine...

    fresh = PlanCache(d)                     # ...but the verifier catches it
    assert fresh.get("demo") is None
    print(f"corrupted entry: clean miss "
          f"(verify_rejects={fresh.verify_rejects}, "
          f"format_misses={fresh.format_misses})")

    # what the verifier actually saw
    bad = analysis.verify(Plan.from_json(entry.read_text()))
    for diag in bad.errors[:3]:
        print(f"  {diag}")
