"""Autoshard: the paper's circulant tuning reused for sharding-layout search.

The reference package's ``repro.distributed.autoshard``.  The
decomposition searcher (``core/search.py``, Fig 23) optimises a joint
assignment of per-pattern cutting sets under a cost model with shared
subcomputations.  Layout search is the same problem shape: a joint
assignment of per-knob sharding choices (FSDP axes, TP axes, microbatch
count, KV layout) under the roofline cost model — so it runs the same
round-robin coordinate descent, with the dry run as the cost oracle.

Each evaluation is the port's dry run of the cell
(``launch.dryrun.run_cell``: one meta trace on the CPU, its per-device
terms and collectives from the resolved specs), seconds to minutes.
Records are cached as JSON by (cell, assignment) under
``build/repro_torch/autoshard/``, so re-runs and overlapping searches
share evaluations — the analogue of the paper's cross-pattern reuse.  A
record carries the version stamp of the code that priced it (a hash of
every ``*.py`` of the ``repro_torch`` package: the dry run, the ring
model, the meshes' rules and recorder hooks, and the models, configs and
steps whose ops the trace runs); a record of another version is
evaluated again.
"""
from __future__ import annotations

import hashlib
import json
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch" / "autoshard"


# knob -> candidate values.  Values are rule overrides except the
# pseudo-knob "microbatches".
TRAIN_KNOBS = {
    "embed": [(), ("data",), ("pod", "data")],          # FSDP extent
    "heads": [("model",), ()],
    "mlp": [("model",), ()],
    "vocab": [("model",), ()],
    "batch": [("pod", "data"), ("pod", "data", "model")],
    "microbatches": [1, 2, 4, 8, 16],
}
DECODE_KNOBS = {
    "heads": [("model",), ()],
    "kv": [("model",), ()],
    "kv_seq": [(), ("model",), ("data",), ("pod", "data")],
    "batch": [("pod", "data"), ("pod", "data", "model")],
}


def _key(arch, shape, mesh_kind, assign):
    blob = json.dumps([arch, shape, mesh_kind, sorted(assign.items())],
                      default=list, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def dryrun_version(root=None) -> str:
    """The stamp of the code that prices a cell: every ``*.py`` under the
    package's ``root``, by relative path and contents."""
    root = pathlib.Path(root or pathlib.Path(__file__).resolve().parents[1])
    h = hashlib.sha1()
    for f in sorted(root.rglob("*.py")):
        h.update(str(f.relative_to(root)).encode() + b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def evaluate(arch: str, shape_name: str, mesh_kind: str, assign: dict,
             objective: str = "bound_time") -> dict:
    """Dry-run the cell under this assignment and return its roofline
    record (cached)."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    f = CACHE_DIR / f"{_key(arch, shape_name, mesh_kind, assign)}.json"
    version = dryrun_version()
    if f.exists():
        rec = json.loads(f.read_text())
        if rec.get("dryrun_version") == version:
            return rec
    from repro_torch.launch.dryrun import run_cell
    overrides = {k: tuple(v) for k, v in assign.items()
                 if k != "microbatches"}
    rec = run_cell(arch, shape_name, mesh_kind, overrides,
                   assign.get("microbatches"), tag="autoshard", save=False)
    rec["dryrun_version"] = version
    f.write_text(json.dumps(rec, indent=1))
    return rec


def objective_of(rec: dict, objective: str = "bound_time") -> float:
    if "skipped" in rec:
        return float("inf")
    if objective == "bound_time":
        return max(rec["t_compute"], rec["t_memory"], rec["t_collective"])
    return rec[objective]


def circulant_autoshard(arch: str, shape_name: str, mesh_kind: str,
                        knobs: dict | None = None, init: dict | None = None,
                        max_rounds: int = 3, budget_evals: int = 40,
                        log=print) -> tuple:
    """Round-robin coordinate descent over the layout knobs (Fig 23 applied
    to sharding).  Returns (best assignment, best record, history)."""
    from repro_torch.configs.base import SHAPES
    knobs = knobs or (TRAIN_KNOBS if SHAPES[shape_name].kind == "train"
                      else DECODE_KNOBS)
    assign = {k: v[0] for k, v in knobs.items()}
    assign.update(init or {})
    history = []
    best_rec = evaluate(arch, shape_name, mesh_kind, assign)
    best = objective_of(best_rec)
    evals = 1
    history.append((dict(assign), best))
    log(f"[autoshard] init {best:.3f}s  {assign}")
    for r in range(max_rounds):
        converged = True
        for knob, options in knobs.items():
            for opt in options:
                if opt == assign[knob] or evals >= budget_evals:
                    continue
                trial = dict(assign, **{knob: opt})
                try:
                    rec = evaluate(arch, shape_name, mesh_kind, trial)
                except Exception as e:              # noqa: BLE001
                    log(f"[autoshard] {knob}={opt}: compile failed: {e}")
                    evals += 1
                    continue
                evals += 1
                c = objective_of(rec)
                history.append((trial, c))
                log(f"[autoshard] {knob}={opt}: {c:.3f}s"
                    f" (best {best:.3f}s)")
                if c < best:
                    best, best_rec, assign = c, rec, trial
                    converged = False
        if converged or evals >= budget_evals:
            break
    return assign, best_rec, history
