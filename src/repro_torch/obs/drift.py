"""Cost-model drift accounting: predicted APCT cost vs measured time.

Every compiled plan records the per-node costs the APCT model charged at
selection time (``plan.meta["node_costs"]``); every traced execution
records each node's measured self time.  This module pairs the two and
aggregates per (node class × cut size × route) into a calibration
report.  Routes are free-form span attributes, so the port's routes
(``kernel``, ``kernel-f64``, ``kernel-keep-f64``, ``dense-f64``,
``dense-f64-keep``, ``kernel-f64-sharded``, ``kernel-f64-sharded-keep``,
``dense-f64-sharded``, ``dense-f64-sharded-keep``, ...) group into their own rows, apart from the reference package's
(``xla-dense``, ``xla-keep``, ``xla-sharded``, ``xla-sharded-keep``)
when traces of both are read together; no label is mapped here:

* **rank correlation** (Spearman) — the quantity DwarvesGraph actually
  relies on: the model only has to *order* candidates correctly, so a
  rank correlation near 1 means the plan picker is trustworthy even if
  the absolute scale is off;
* **ratio spread** — max/min of measured/predicted within one class: a
  tight spread means one per-class scale factor calibrates the model
  (the autotune on-ramp); a wide spread means the class's cost formula
  is structurally wrong, not just unscaled.

Consumes either trace-tree JSON (``Tracer.to_json``, from either
package) or a JSON file holding a ``drift_pairs`` table (the reference
package's benchmark results embed one):

    python -m repro_torch.obs.drift out.json
    python -m repro_torch.obs.drift BENCH_obs.json

Stdlib-only on purpose — it must run anywhere a trace file lands.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

#: span kinds that are IR node evaluations (everything the tracer emits
#: except the per-read "execute" roots)
NODE_KINDS = ("Contract", "Intersect", "MobiusCombine", "CutJoin",
              "ShrinkageCorrect", "LocalCount")


# -- statistics (stdlib implementations) -------------------------------------------

def _ranks(xs: List[float]) -> List[float]:
    """Average ranks (1-based), ties averaged — Spearman's convention."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2 + 1
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(xs: List[float], ys: List[float]) -> Optional[float]:
    """Spearman rank correlation; None for fewer than two pairs or a
    degenerate (constant) side."""
    if len(xs) != len(ys) or len(xs) < 2:
        return None
    rx, ry = _ranks(list(xs)), _ranks(list(ys))
    mx = sum(rx) / len(rx)
    my = sum(ry) / len(ry)
    sxx = sum((a - mx) ** 2 for a in rx)
    syy = sum((b - my) ** 2 for b in ry)
    if sxx == 0.0 or syy == 0.0:
        return None
    sxy = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    return sxy / (sxx * syy) ** 0.5


# -- pair extraction ---------------------------------------------------------------

def _walk(span: dict):
    yield span
    for c in span.get("children", ()):
        yield from _walk(c)


def pairs_from_trace(trace: dict) -> List[dict]:
    """(predicted, measured) pairs from one trace-tree dict: every node
    span whose plan recorded a predicted cost, measured by *self* time
    (children's work is their own nodes' pairs)."""
    backend = trace.get("meta", {}).get("backend", "unknown")
    out = []
    for root in trace.get("spans", ()):
        for s in _walk(root):
            if s.get("kind") not in NODE_KINDS:
                continue
            pred = s.get("attrs", {}).get("predicted")
            if pred is None:
                continue
            out.append({"key": s.get("name"), "cls": s["kind"],
                        "cut": s.get("attrs", {}).get("cut_size"),
                        "route": s.get("attrs", {}).get("route", "host"),
                        "backend": backend,
                        "predicted": float(pred),
                        "measured_us": float(s.get("self_us", 0.0))})
    return out


def group_key(pair: dict) -> str:
    cut = pair.get("cut")
    cut_s = f"cut={cut}" if cut is not None else "cut=-"
    return f"{pair['cls']}|{cut_s}|{pair.get('route', 'host')}"


# -- aggregation -------------------------------------------------------------------

def aggregate(pairs: List[dict]) -> dict:
    """Calibration report over (predicted, measured) pairs, grouped per
    node class × cut size × route (the backend rides in each pair and is
    reported per group — one smoke run is single-backend)."""
    groups: Dict[str, List[dict]] = {}
    for pr in pairs:
        groups.setdefault(group_key(pr), []).append(pr)
    out_groups = {}
    for key, prs in sorted(groups.items()):
        preds = [p["predicted"] for p in prs]
        meas = [p["measured_us"] for p in prs]
        ratios = [m / p for m, p in zip(meas, preds) if p > 0 and m > 0]
        spread = (max(ratios) / min(ratios)
                  if len(ratios) >= 2 and min(ratios) > 0 else None)
        med = sorted(ratios)[len(ratios) // 2] if ratios else None
        out_groups[key] = {
            "n": len(prs),
            "backends": sorted({p.get("backend", "unknown") for p in prs}),
            "rank_corr": spearman(preds, meas),
            "ratio_median": med,
            "ratio_spread": spread,
            "predicted_sum": sum(preds),
            "measured_us_sum": sum(meas),
        }
    return {"n_pairs": len(pairs),
            "overall_rank_corr": spearman([p["predicted"] for p in pairs],
                                          [p["measured_us"] for p in pairs]),
            "groups": out_groups}


def bench_summary(report: dict) -> dict:
    """Compact per-group summary: n, rank correlation and ratio spread
    per group (the shape of the ``drift`` key of the reference's
    ``BENCH_obs.json``)."""
    return {key: {"n": g["n"], "rank_corr": g["rank_corr"],
                  "ratio_spread": g["ratio_spread"]}
            for key, g in report["groups"].items()}


def render(report: dict) -> str:
    """Human-readable calibration table."""
    lines = ["# Cost-model drift report",
             f"pairs: {report['n_pairs']}, overall rank correlation: "
             f"{_fmt(report['overall_rank_corr'])}", "",
             "| class|cut|route | n | rank corr | ratio median "
             "(us/cost) | ratio spread (max/min) |",
             "|---|---|---|---|---|"]
    for key, g in report["groups"].items():
        lines.append(f"| {key} | {g['n']} | {_fmt(g['rank_corr'])} | "
                     f"{_fmt(g['ratio_median'])} | "
                     f"{_fmt(g['ratio_spread'])} |")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.3f}"


def load_pairs(path: str) -> List[dict]:
    """Pairs from one file: a result holding a ``drift_pairs`` table or
    a trace-tree JSON (``spans``)."""
    with open(path) as fh:
        d = json.load(fh)
    if "drift_pairs" in d:
        return list(d["drift_pairs"])
    if "spans" in d:
        return pairs_from_trace(d)
    raise ValueError(f"{path}: neither a trace (spans) nor a bench "
                     f"result (drift_pairs)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="trace JSONs and/or files holding drift_pairs")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of a table")
    args = ap.parse_args(argv)
    pairs = []
    for f in args.files:
        pairs.extend(load_pairs(f))
    report = aggregate(pairs)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(render(report), end="")
    return report


if __name__ == "__main__":
    main()
