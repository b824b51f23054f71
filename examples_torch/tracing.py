"""Plan-execution tracing and the cost-model drift report, on the
PyTorch/CUDA port.

Attach a tracer to a compiled plan, read the span tree it records (one
span per IR node evaluation, nested as the evaluation recursion nests),
export it for chrome://tracing, and aggregate the (predicted cost,
measured time) pairs into the calibration report.

    PYTHONPATH=src python examples_torch/tracing.py
    PYTHONPATH=src python examples_torch/tracing.py --device cpu --out DIR
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import compiler, obs  # noqa: E402
from repro_torch.core.pattern import Pattern  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
ap.add_argument("--out", default=None,
                help="directory for the trace files (default: a fresh "
                "temporary directory)")
args = ap.parse_args()

graph = erdos_renyi(300, 8.0, seed=1)

# 5-clique minus one edge: its only cutting set has three vertices, so
# the compiler commits a |cut| = 3 decomposition join — the tri-join
# kernel tier, the most interesting thing to watch execute.
p = Pattern(5, [(u, v) for u in range(5) for v in range(u + 1, 5)
                if (u, v) != (3, 4)])

# --- 1. attach a tracer and execute ---------------------------------------
# Tracing is off by default (one is-None check per node eval).  Values
# are fenced (torch.cuda.synchronize on the card) before each span
# closes, so spans time the work, not the enqueue.
tracer = obs.Tracer()
cp = compiler.compile(p, graph, cache=False, device=args.device)
cp.tracer = tracer
count = cp.count(p)
print(f"count = {count:,.0f} on {graph}")

# --- 2. read the span tree ------------------------------------------------
for span in tracer.walk():
    route = span.attrs.get("route", "")
    print(f"  {span.kind:16s} {span.name:28s} {route:12s} "
          f"{span.duration_s * 1e3:8.2f} ms (self {span.self_s * 1e3:.2f})")
print(f"node coverage of wall time: {tracer.coverage():.1%}")

# --- 3. export ------------------------------------------------------------
out = args.out or tempfile.mkdtemp(prefix="k5me_trace_")
tracer.save(os.path.join(out, "k5me_trace.json"))
tracer.save(os.path.join(out, "k5me_trace.chrome.json"))
print(f"wrote k5me_trace.json and k5me_trace.chrome.json to {out}")

# --- 4. the drift report --------------------------------------------------
pairs = obs.drift.pairs_from_trace(tracer.to_dict())
report = obs.drift.aggregate(pairs)
print()
print(obs.drift.render(report))

# --- 5. the metrics registry ----------------------------------------------
print("metrics registry:")
print(obs.dump(indent=2))
