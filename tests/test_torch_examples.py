"""The port's examples (``examples_torch/``) run on the CPU.

Each example runs as its user would start it, in a subprocess with
``--device cpu``, and must exit 0.  The counts that ``quickstart`` and
``mesh_mining`` print must equal the reference's for the same graph and
patterns, computed here through the ``reference`` fixture with the
reference's ``CountingEngine`` (printed with the examples' own format).
``examples/`` itself is not run: it needs the reference's shim.  The
other three examples are in ``test_torch_examples_mining.py``.
``train_lm`` runs at its CPU default (reduced width, 30 steps) with its
checkpoints in the test's temporary directory, then again to resume.
"""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import train as tlaunch

from test_torch_reference import reference  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def run_example(name: str, *args: str) -> list:
    """Run one example on the CPU; its stdout lines (exit 0 required)."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         "--device", "cpu", *args], cwd=str(ROOT), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _fmt(v) -> str:
    return f"{float(v):,.0f}"


def test_quickstart_prints_the_reference_counts(reference):
    lines = run_example("quickstart")
    P = reference.pattern
    g = reference.generators.erdos_renyi(1000, 8.0, seed=0)
    eng = reference.counting.CountingEngine(g)
    p5 = P.Pattern(5, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 4)])
    want = [f"three-chain-count: {_fmt(eng.edge_induced(P.chain(3)))}",
            f"vertex-induced 3-chain: {_fmt(eng.vertex_induced(P.chain(3)))}",
            f"triangles: {_fmt(eng.edge_induced(P.clique(3)))}"]
    for line in want:
        assert line in lines, line
    custom = next(ln for ln in lines if ln.startswith("custom 5-pattern"))
    assert custom.startswith(f"custom 5-pattern count: "
                             f"{_fmt(eng.edge_induced(p5))} ")
    table = eng.motif_table(4)
    rows = [f"  m={q.m}: {_fmt(v)}"
            for q, v in sorted(table.items(), key=lambda t: t[0].m)]
    at = lines.index("4-motif table:")
    assert lines[at + 1:at + 1 + len(rows)] == rows


def test_mesh_mining_prints_the_reference_counts(reference):
    lines = run_example("mesh_mining", "--slots", "8")
    g = reference.generators.erdos_renyi(400, 8.0, seed=1)
    eng = reference.counting.CountingEngine(g)
    from repro.core.motifs import motif_patterns
    rows = [f"  {p.n}-vertex motif m={p.m}: {_fmt(eng.edge_induced(p))}"
            for p in motif_patterns(4)]
    got = [ln for ln in lines if re.match(r"  \d-vertex motif", ln)]
    assert got == rows
    c4 = _fmt(eng.edge_induced(reference.pattern.cycle(4)))
    assert f"served 8 requests; C4 count {c4}" in lines
    assert "6 motif counts match one device bit-for-bit" in lines
    routes = next(ln for ln in lines if ln.startswith("routes taken"))
    assert "'kernel-sharded'" in routes and "'einsum-sharded'" in routes


@pytest.mark.parametrize("name", ["fsm_mining", "serve_batched",
                                  "verify_plans"])
def test_example_runs(name):
    assert run_example(name)


def test_tracing_example_writes_its_traces(tmp_path):
    lines = run_example("tracing", "--out", str(tmp_path))
    assert any(ln.startswith("count = ") for ln in lines)
    assert (tmp_path / "k5me_trace.json").is_file()
    assert (tmp_path / "k5me_trace.chrome.json").is_file()


def test_train_lm_trains_and_resumes(tmp_path):
    """``train_lm`` at its CPU default: 30 steps of reduced repro-100m with
    checkpoints under ``TMPDIR``, the loss falling; the directory it names
    resumes from step 30."""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "train_lm.py"),
         "--device", "cpu"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "arch=repro-100m params=0.1M tokens/step=1024"
    m = re.match(r"loss: (\S+) -> (\S+) over 30 steps$", lines[-2])
    assert m and float(m[2]) < float(m[1]), lines[-2:]
    ckpt = re.match(r"checkpoints in (\S+) ", lines[-1])[1]
    assert sorted(os.listdir(ckpt)) == ["step_10", "step_20", "step_30"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = tlaunch.main(["--arch", "repro-100m", "--reduced",
                               "--steps", "32", "--batch", "8", "--seq",
                               "128", "--ckpt-dir", ckpt, "--device", "cpu"])
    assert buf.getvalue().splitlines()[0] == "resumed from step 30"
    assert len(losses) == 2
