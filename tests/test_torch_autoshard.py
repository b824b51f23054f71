"""The port's layout search (``repro_torch.distributed.autoshard``,
``repro_torch.launch.hillclimb``) against the reference's, on the CPU.

  * ``_key`` equal to the reference's on a dozen assignments.
  * ``circulant_autoshard`` of both packages on one deterministic
    synthetic objective of the sorted assignment (one assignment of which
    raises, as a failed compile does): equal assignment, best record and
    history for the train and decode knobs, at budgets 3 and 40, with 1
    and 3 rounds.
  * A real evaluation: qwen3-4b ``decode_32k`` on the single-pod mesh,
    cached in a temporary directory; the second call reads the file and
    traces nothing; a record of another dry-run version is traced again;
    the version stamp changes with any module of the package.
  * The CLI in a subprocess with CUDA hidden: it writes its log and never
    initialises CUDA.
"""
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.distributed import autoshard as ref
from repro_torch.distributed import autoshard
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ASSIGNMENTS = [
    {}, {"heads": ("model",)}, {"heads": ()},
    {"embed": ("pod", "data"), "microbatches": 4},
    {"microbatches": 4, "embed": ("pod", "data")},
    {k: v[0] for k, v in ref.TRAIN_KNOBS.items()},
    {k: v[-1] for k, v in ref.TRAIN_KNOBS.items()},
    {k: v[0] for k, v in ref.DECODE_KNOBS.items()},
    {k: v[-1] for k, v in ref.DECODE_KNOBS.items()},
    {"kv_seq": ("data",), "batch": ("pod", "data", "model")},
    {"kv_seq": ["data"], "batch": ["pod", "data", "model"]},
    {"vocab": (), "mlp": (), "microbatches": 16},
]


def test_knobs_equal_the_reference():
    assert autoshard.TRAIN_KNOBS == ref.TRAIN_KNOBS
    assert autoshard.DECODE_KNOBS == ref.DECODE_KNOBS


@pytest.mark.parametrize("i", range(len(ASSIGNMENTS)))
def test_key_equals_the_reference(i):
    for arch, shape, mesh in (("qwen3-4b", "train_4k", "single"),
                              ("deepseek-v3-671b", "decode_32k", "multi")):
        a = ASSIGNMENTS[i]
        assert autoshard._key(arch, shape, mesh, a) == \
            ref._key(arch, shape, mesh, a)


def _synthetic(arch, shape_name, mesh_kind, assign, objective="bound_time"):
    """A deterministic record of the sorted assignment; one assignment
    fails as a compile does."""
    blob = json.dumps(sorted(assign.items()), default=list)
    if assign.get("batch") == ("pod", "data", "model"):
        raise RuntimeError("no layout")
    h = int(hashlib.sha1(blob.encode()).hexdigest()[:8], 16)
    return {"t_compute": (h % 997) / 100.0, "t_memory": (h % 89) / 10.0,
            "t_collective": (h % 53) / 7.0, "arch": arch,
            "shape": shape_name, "mesh": mesh_kind}


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("budget", [3, 40])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_search_equals_the_reference(monkeypatch, shape, budget, rounds):
    monkeypatch.setattr(ref, "evaluate", _synthetic)
    monkeypatch.setattr(autoshard, "evaluate", _synthetic)
    logs: dict = {"ref": [], "port": []}
    want = ref.circulant_autoshard("qwen3-4b", shape, "single",
                                   max_rounds=rounds, budget_evals=budget,
                                   log=logs["ref"].append)
    got = autoshard.circulant_autoshard("qwen3-4b", shape, "single",
                                        max_rounds=rounds,
                                        budget_evals=budget,
                                        log=logs["port"].append)
    assert got == want and logs["port"] == logs["ref"]
    assert len(got[2]) >= 1
    if budget == 40:                # the search reaches the failing layout
        assert any("compile failed" in m for m in logs["port"])


def test_objective_is_the_bound_time():
    rec = {"t_compute": 1.0, "t_memory": 3.0, "t_collective": 2.0}
    assert autoshard.objective_of(rec) == ref.objective_of(rec) == 3.0
    assert autoshard.objective_of({"skipped": "x"}) == float("inf")
    assert autoshard.objective_of(rec, "t_memory") == 3.0


def test_evaluate_caches_by_assignment_and_version(monkeypatch, tmp_path):
    monkeypatch.setattr(autoshard, "CACHE_DIR", tmp_path)
    traced = []
    real = dryrun.run_cell

    def run_cell(*a, **kw):
        traced.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    assign = {k: v[0] for k, v in autoshard.DECODE_KNOBS.items()}
    first = autoshard.evaluate("qwen3-4b", "decode_32k", "single", assign)
    assert len(traced) == 1 and first["chips"] == 256
    assert first["t_collective"] > 0 and first["tag"] == "autoshard"
    assert first["rules"]["kv_seq"] == [] and first["rules"]["heads"] == \
        ["model"]
    f = tmp_path / (autoshard._key("qwen3-4b", "decode_32k", "single",
                                   assign) + ".json")
    assert f.exists()
    again = autoshard.evaluate("qwen3-4b", "decode_32k", "single", assign)
    assert len(traced) == 1
    assert again == json.loads(json.dumps(first))
    assert again["dryrun_version"] == autoshard.dryrun_version()
    stale = dict(again, dryrun_version="0" * 16)
    f.write_text(json.dumps(stale))
    third = autoshard.evaluate("qwen3-4b", "decode_32k", "single", assign)
    assert len(traced) == 2
    assert third["dryrun_version"] == autoshard.dryrun_version()


def test_the_version_stamp_covers_the_code_the_trace_runs(tmp_path):
    """The stamp hashes every module of the package, not only the dry run:
    an edit to the MoE layer, the meshes' rules or a config makes cached
    records stale."""
    pkg = pathlib.Path(autoshard.__file__).resolve().parents[1]
    copy = tmp_path / "repro_torch"
    shutil.copytree(pkg, copy, ignore=shutil.ignore_patterns("__pycache__"))
    assert autoshard.dryrun_version(copy) == autoshard.dryrun_version()
    seen = {autoshard.dryrun_version(copy)}
    for rel in ("models/moe.py", "distributed/meshes.py",
                "configs/qwen3_4b.py", "train/train_step.py"):
        f = copy / rel
        f.write_text(f.read_text() + "\n# edited\n")
        seen.add(autoshard.dryrun_version(copy))
    assert len(seen) == 5


def test_cli_runs_without_a_card_and_writes_its_log(tmp_path):
    code = textwrap.dedent(f"""
        import pathlib, sys, torch
        from repro_torch.distributed import autoshard
        from repro_torch.launch import hillclimb
        autoshard.CACHE_DIR = pathlib.Path({str(tmp_path / "cache")!r})
        hillclimb.OUT = pathlib.Path({str(tmp_path)!r})
        sys.argv = ["hillclimb", "--arch", "qwen3-4b", "--shape",
                    "decode_32k", "--budget", "2", "--rounds", "1"]
        hillclimb.main()
        print("cuda initialised:", torch.cuda.is_initialized())
    """)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "cuda initialised: False"
    log = json.loads((tmp_path / "hillclimb_qwen3-4b__decode_32k__single"
                      ".json").read_text())
    assert log["arch"] == "qwen3-4b" and len(log["history"]) == 2
    assert set(log["best"]) == {"t_compute", "t_memory", "t_collective",
                                "dominant", "useful_flops_ratio"}
    assert log["best_assignment"]["heads"] in (["model"], [])
    assert len(list((tmp_path / "cache").glob("*.json"))) == 2
