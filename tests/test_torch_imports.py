"""The port stands alone: no import of ``jax`` or of the reference package
``repro`` anywhere in ``src/repro_torch`` (``repro_torch.distributed``
included), ``examples_torch/`` or ``chip_smoke.py``, the device
policy raises rather than picking the CPU, and the smoke script fails
where there is no card.  Nothing numeric is compared here (the files
beside this one compare with tolerance 0: exact equality of integers
held in f64).
"""
import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}
EXAMPLES = ("quickstart", "existence_and_listing", "fsm_mining",
            "local_counts", "morphing", "serve_batched", "tracing",
            "verify_plans", "mesh_mining", "train_lm")
PORT_FILES = sorted(PORT.rglob("*.py")) + \
    sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def test_port_has_the_expected_modules():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for want in ("device.py", "interop.py", "obs/metrics.py",
                 "obs/trace.py", "obs/drift.py", "analysis/lint.py",
                 "graph/storage.py", "graph/generators.py",
                 "core/pattern.py", "core/quotient.py",
                 "core/decomposition.py", "core/motifs.py",
                 "core/homomorphism.py", "core/cliques.py",
                 "core/counting.py", "core/apct.py", "core/cost_model.py",
                 "kernels/matreduce.py", "kernels/ops.py", "kernels/build.py",
                 "compiler/ir.py", "compiler/frontend.py",
                 "compiler/costing.py", "compiler/cache.py",
                 "compiler/lowering.py", "compiler/__init__.py",
                 "compiler/morph.py", "analysis/verify.py", "analysis/__init__.py",
                 "api/__init__.py", "api/local.py",
                 "kernels/sddmm.py", "kernels/bitset.py", "core/engine.py",
                 "core/search.py", "core/fsm.py", "core/symmetry.py",
                 "core/blocksparse.py", "launch/__init__.py",
                 "launch/mine.py", "configs/__init__.py", "configs/base.py",
                 "configs/registry.py", "configs/qwen3_4b.py",
                 "configs/command_r_35b.py", "configs/dbrx_132b.py",
                 "models/moe.py", "models/ssm.py", "models/mla.py",
                 "configs/deepseek_7b.py", "configs/deepseek_v3_671b.py",
                 "configs/granite_20b.py", "configs/jamba_1_5_large_398b.py",
                 "configs/llama_3_2_vision_11b.py", "configs/mamba2_1_3b.py",
                 "configs/musicgen_large.py", "configs/repro_100m.py",
                 "models/__init__.py", "models/params.py",
                 "models/layers.py", "models/transformer.py",
                 "kernels/flashattn.py", "serve/__init__.py",
                 "serve/engine.py", "serve/batching.py", "launch/serve.py",
                 "distributed/__init__.py", "distributed/meshes.py",
                 "distributed/cutjoin.py", "distributed/contract.py",
                 "core/distributed.py", "train/__init__.py", "train/tree.py",
                 "train/data.py", "train/optimizer.py",
                 "train/train_step.py", "train/checkpoint.py",
                 "train/fault_tolerance.py", "train/compression.py",
                 "launch/train.py", "launch/dryrun.py", "launch/mesh.py",
                 "distributed/collectives.py", "distributed/autoshard.py",
                 "launch/hillclimb.py"):
        assert want in names, want
    for example in EXAMPLES:
        assert (ROOT / "examples_torch" / f"{example}.py").is_file(), example
    for source in ("cutjoin.cu", "matreduce.cu", "bitset.cu", "flashattn.cu",
                   "flashattn_bwd.cu"):
        assert (PORT / "kernels" / "csrc" / source).is_file(), source


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference_package(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def _run(code: str, **env):
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-c", code], env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_compiler_pulls_in_neither_jax_nor_repro():
    proc = _run(
        "import sys\n"
        "import repro_torch.compiler, repro_torch.kernels.ops, "
        "repro_torch.analysis, repro_torch.interop, repro_torch.api, "
        "repro_torch.launch.mine, repro_torch.core.symmetry, "
        "repro_torch.core.blocksparse, repro_torch.launch.serve, "
        "repro_torch.serve.batching, repro_torch.configs.registry, "
        "repro_torch.distributed.cutjoin, repro_torch.distributed.contract, "
        "repro_torch.core.distributed, repro_torch.launch.train, "
        "repro_torch.train.checkpoint, repro_torch.train.compression, "
        "repro_torch.train.fault_tolerance, repro_torch.launch.dryrun, "
        "repro_torch.launch.mesh\n"
        "from repro_torch.configs.registry import ALL_IDS, get_config\n"
        "[get_config(a) for a in ALL_IDS]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert 'torch' in sys.modules\n"
        "sys.exit(1 if bad else 0)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def test_device_none_raises_without_cuda(monkeypatch):
    from repro_torch import compiler, device
    from repro_torch.core.counting import CountingEngine
    from repro_torch.core.pattern import cycle
    from repro_torch.graph.generators import erdos_renyi
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = erdos_renyi(12, 3.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        compiler.compile(cycle(4), g, cache=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CountingEngine(g)
    assert device.resolve("cpu").type == "cpu"
    assert CountingEngine(g, device="cpu").device.type == "cpu"


def test_device_policy_has_no_quiet_cpu_branch():
    """``is_available`` may only decide whether to raise, never a device:
    the one place that reads it is ``device.resolve``."""
    readers = [p for p in PORT.rglob("*.py")
               if "is_available" in p.read_text()]
    assert [p.name for p in readers] == ["device.py"]


def test_kernel_modules_import_without_a_compiler_and_build_nothing():
    proc = _run(
        "import repro_torch.kernels.matreduce as m, "
        "repro_torch.kernels.build as b, repro_torch.kernels.sddmm as s, "
        "repro_torch.kernels.bitset as t, repro_torch.kernels.ops, "
        "repro_torch.kernels.flashattn as f, repro_torch.models.layers\n"
        "assert m._LIB is None and s._LIB is None and t._LIB is None\n"
        "assert not f._BOUND\n"
        "assert f.launches == {'flashattn': 0, 'flashattn_bwd': 0}\n"
        "assert not b._LIBS\n"
        "assert m.launches == {'vecjoin': 0, 'pairjoin': 0, 'trijoin': 0, "
        "'pairjoin_keep': 0, 'trijoin_keep': 0, 'matreduce': 0, "
        "'matreduce_tilelist': 0}\n"
        "assert not any(m.matreduce_entries.values())\n"
        "assert s.launches == {'sddmm': 0}\n"
        "assert t.launches == {'bitset': 0, 'bitset_edges': 0, "
        "'bitset_pack': 0}\n"
        "assert not any(t.edge_entries.values())\n",
        PATH="/nonexistent")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_where_there_is_no_card():
    try:
        has_card = torch.cuda.is_available()
    except Exception:                                  # pragma: no cover
        has_card = False
    if has_card:
        pytest.skip("a CUDA card is present: chip_smoke.py would succeed")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_reference_shim_did_not_outlive_its_fixture():
    """Whatever jax offers on its own is what other test files see: the
    shared fixture's stand-in for ``jax.experimental.enable_x64`` is
    removed at module teardown."""
    import jax
    attr = getattr(jax.experimental, "enable_x64", None)
    assert not isinstance(attr, functools.partial)
