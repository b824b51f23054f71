"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on
— ``configs.base.input_specs``, ``Model.abstract_params`` /
``param_axes``, ``train_step.abstract_state`` / ``state_axes``, the
logical-axis rules of ``distributed.meshes`` and the device-free meshes
of ``launch.mesh`` — against the reference, on the CPU, tolerance 0.

The reference runs in two subprocesses started together once per module,
as ``tests/test_distributed.py`` runs it: one with 512 forced host
devices builds every (arch, shape) cell on both production meshes (no
lowering) and writes its trees, specs and rules as JSON; one with 8
compiles four reduced cells on a (2, 4) host mesh and writes XLA's
``memory_analysis()``.
  * ``input_specs``: keys, shapes and dtypes for every ``ARCH_IDS`` x
    ``SHAPES`` cell, every tensor on meta; ``cell_is_applicable``.
  * Abstract trees: parameters and their axes, the state in f32 and bf16
    moments and its axes, leaf by leaf (path, shape, dtype, axes); the
    abstract state against ``init_state`` of the reduced config on the
    CPU (order, shapes, dtypes, ``requires_grad``).
  * Rules: ``DEFAULT_RULES``, ``rules_for``, ``default_microbatches``,
    ``input_axes``; the resolved spec of every leaf (params, state,
    caches, inputs, outputs) on both production meshes, and the eight
    ``long_500k`` skips.
  * Bytes: on the four reduced cells, per-device argument, output and
    alias bytes equal to XLA's (temp is reported by both, not compared).
  * FLOPs: the meta count of reduced steps equal to ``FlopCounterMode``'s
    count of the same steps run on CPU tensors; the dense reduced train
    cell's count equal to a closed form.
  * Per device and collectives: each reduced cell's collectives, traffic
    and FLOPs per device beside the reference's ``hlo_analysis.analyze``
    of the same compiled cell (both non-zero; equality is not expected:
    XLA picks its own collectives); on a (1, 1) mesh no collective and
    per-device counts equal to the totals; a pure data-parallel step
    all-reduces each gradient once; the expert-parallel exchanges equal
    their closed form; two ``heads`` layouts price differently; the memo
    keyed on operand layouts.
  * The meter on small functions, the mesh factories, and the CLI in a
    subprocess with CUDA hidden (CUDA never initialised).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, cell_is_applicable,
                                      input_specs, reduced_config)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import collectives, meshes
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models.transformer import Model
from repro_torch.train import tree
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (abstract_state, init_state,
                                          state_axes)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
MESHES = ("single", "multi")
STATE_DTYPES = ("float32", "bfloat16")
# the reference's reduced cells on a (2, 4) host mesh: reduced_config at
# 4 layers, seq 128, batch 8, 2 microbatches for train
REDUCED = (("qwen3-4b", "train_4k"), ("qwen3-4b", "decode_32k"),
           ("qwen3-4b", "prefill_32k"), ("deepseek-v3-671b", "decode_32k"))
# XLA's argument bytes of those cells (compiled on 8 forced host devices)
XLA_ARGUMENT_BYTES = {("qwen3-4b", "train_4k"): 254_852,
                      ("qwen3-4b", "decode_32k"): 297_760,
                      ("qwen3-4b", "prefill_32k"): 168_704,
                      ("deepseek-v3-671b", "decode_32k"): 368_160}

_COMMON = """
    import json, sys
    from jax.tree_util import DictKey, SequenceKey, tree_flatten_with_path

    def key(k):
        if isinstance(k, DictKey):
            return k.key
        if isinstance(k, SequenceKey):
            return k.idx
        raise TypeError(k)

    def is_axes(t):
        return isinstance(t, tuple) and all(
            isinstance(e, (str, type(None))) for e in t)

    def leaves(t, is_leaf=None):
        flat, _ = tree_flatten_with_path(t, is_leaf=is_leaf)
        return [[[key(k) for k in p], x] for p, x in flat]

    def sds(t):
        return [[p, list(x.shape), str(x.dtype)] for p, x in leaves(t)]

    def axes(t):
        return [[p, list(a)] for p, a in leaves(t, is_axes)]

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def shardings(t):
        return [[p, spec(s)] for p, s in leaves(t)]
"""

_PRODUCTION = _COMMON + """
    sys.argv = ["dryrun"]
    from repro.launch import dryrun as D
    from repro.configs.base import SHAPES, cell_is_applicable, input_specs
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.distributed.meshes import DEFAULT_RULES, sharding_ctx
    from repro.launch.mesh import make_production_mesh
    from repro.models.transformer import Model
    from repro.train.optimizer import OptConfig
    from repro.train.train_step import abstract_state, state_axes

    out = {"default_rules": {k: list(v) for k, v in DEFAULT_RULES.items()},
           "archs": {}, "cells": {}}
    meshes = {mk: make_production_mesh(multi_pod=mk == "multi")
              for mk in ("single", "multi")}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        m = Model(cfg)
        out["archs"][arch] = {
            "params": sds(m.abstract_params()),
            "param_axes": axes(m.param_axes()),
            "state": {dt: sds(abstract_state(cfg, OptConfig(state_dtype=dt)))
                      for dt in ("float32", "bfloat16")},
            "state_axes": axes(state_axes(cfg))}
        for name, shape in SHAPES.items():
            rules = D.rules_for(cfg, shape)
            c = {"applicable": cell_is_applicable(cfg, shape),
                 "inputs": [[k, list(v.shape), str(v.dtype)]
                            for k, v in input_specs(cfg, shape).items()],
                 "rules": {k: list(v) for k, v in rules.items()},
                 "microbatches": D.default_microbatches(cfg, shape),
                 "input_axes": {k: list(v) for k, v in
                                D.input_axes(cfg, shape).items()}}
            if c["applicable"]:
                for mk, mesh in meshes.items():
                    with sharding_ctx(mesh, rules):
                        fn, args, in_sh, out_sh, donate = D.build_cell(
                            cfg, shape, mesh, rules)
                    c[mk] = {"args": sds(args), "in": shardings(in_sh),
                             "out": shardings(out_sh),
                             "donate": list(donate)}
            out["cells"][arch + "|" + name] = c
    with open(OUT, "w") as f:
        json.dump(out, f)
"""

_REDUCED = """
    import dataclasses, json, sys
    sys.argv = ["dryrun", "--host-devices", "8"]
    import jax
    from repro.launch.dryrun import build_cell, rules_for
    from repro.configs.base import SHAPES, reduced_config
    from repro.configs.registry import get_config
    from repro.distributed import hlo_analysis
    from repro.distributed.meshes import sharding_ctx
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, name in CELLS:
        cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                  num_layers=4)
        shape = dataclasses.replace(SHAPES[name], seq=128, batch=8)
        rules = rules_for(cfg, shape)
        with sharding_ctx(mesh, rules):
            fn, args, in_sh, out_sh, donate = build_cell(
                cfg, shape, mesh, rules, microbatches=2)
            c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                        donate_argnums=donate).lower(*args).compile()
        m = c.memory_analysis()
        r = hlo_analysis.analyze(c, 8)
        out[arch + "|" + name] = {
            "argument_bytes": m.argument_size_in_bytes,
            "output_bytes": m.output_size_in_bytes,
            "alias_bytes": m.alias_size_in_bytes,
            "temp_bytes": m.temp_size_in_bytes,
            "collective_traffic_per_device":
                r.collective_traffic_per_device,
            "num_collectives": r.num_collectives,
            "flops_per_device": r.flops_per_device}
    with open(OUT, "w") as f:
        json.dump(out, f)
"""


def _start(code: str, devices: int):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Both reference subprocesses, run at once: (production, reduced)."""
    d = tmp_path_factory.mktemp("ref_dryrun")
    prod_out, red_out = d / "production.json", d / "reduced.json"
    procs = [
        _start(f"OUT = {str(prod_out)!r}\n" + textwrap.dedent(_PRODUCTION),
               512),
        _start(f"CELLS = {list(REDUCED)!r}\nOUT = {str(red_out)!r}\n"
               + textwrap.dedent(_REDUCED), 8)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=540)
        assert p.returncode == 0, stdout + stderr
    return (json.loads(prod_out.read_text()),
            json.loads(red_out.read_text()))


@pytest.fixture(scope="module")
def production(reference):
    return reference[0]


# -- the port's trees, flattened as the reference's ---------------------------

def _leaves(t, is_leaf=lambda x: False, path=()):
    """[path, leaf] in jax's order: dict keys sorted, sequences in order."""
    if is_leaf(t):
        return [[list(path), t]]
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k], is_leaf,
                                                       path + (k,))]
    if isinstance(t, (list, tuple)):
        return [x for i, v in enumerate(t) for x in _leaves(v, is_leaf,
                                                             path + (i,))]
    return [[list(path), t]]


def _dtype(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _sds(t):
    out = []
    for p, x in _leaves(t):
        assert x.device.type == "meta", (p, x.device)
        out.append([p, list(x.shape), _dtype(x.dtype)])
    return out


def _axes(t):
    return [[p, list(a)] for p, a in _leaves(t, meshes._is_axes)]


def _spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _shardings(t):
    return [[p, _spec(s.spec)] for p, s in _leaves(
        t, lambda x: isinstance(x, meshes.NamedSharding))]


# -- input_specs, rules --------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(production, arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    want = production["cells"][f"{arch}|{shape}"]
    got = input_specs(cfg, sh)
    assert all(v.device.type == "meta" for v in got.values())
    assert [[k, list(v.shape), _dtype(v.dtype)]
            for k, v in got.items()] == want["inputs"]
    assert cell_is_applicable(cfg, sh) == want["applicable"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_rules_equal_the_reference(production, arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    want = production["cells"][f"{arch}|{shape}"]
    assert {k: list(v) for k, v in dryrun.rules_for(cfg, sh).items()} \
        == want["rules"]
    assert dryrun.default_microbatches(cfg, sh) == want["microbatches"]
    assert {k: list(v) for k, v in dryrun.input_axes(cfg, sh).items()} \
        == want["input_axes"]


def test_default_rules_equal_the_reference(production):
    assert {k: list(v) for k, v in meshes.DEFAULT_RULES.items()} \
        == production["default_rules"]


# -- abstract trees ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_axes_equal_the_reference(production, arch):
    want = production["archs"][arch]
    m = Model(get_config(arch))
    assert _sds(m.abstract_params()) == want["params"]
    assert _axes(m.param_axes()) == want["param_axes"]


@pytest.mark.parametrize("dtype", STATE_DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_and_axes_equal_the_reference(production, arch,
                                                     dtype):
    want = production["archs"][arch]
    cfg = get_config(arch)
    state = abstract_state(cfg, OptConfig(state_dtype=dtype))
    assert _sds(state) == want["state"][dtype]
    assert _axes(state_axes(cfg)) == want["state_axes"]
    assert len(tree.leaves(state)) == len(_axes(state_axes(cfg)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_is_the_tree_init_state_builds(arch):
    cfg = reduced_config(get_config(arch))
    for dtype in STATE_DTYPES:
        opt = OptConfig(state_dtype=dtype)
        real, real_structure = tree.flatten(init_state(cfg, opt, 0,
                                                       device="cpu"))
        meta, meta_structure = tree.flatten(abstract_state(cfg, opt))
        assert meta_structure == real_structure
        assert [(p, tuple(x.shape), x.dtype, x.requires_grad)
                for p, x in _leaves(abstract_state(cfg, opt))] == \
            [(p, tuple(x.shape), x.dtype, x.requires_grad)
             for p, x in _leaves(init_state(cfg, opt, 0, device="cpu"))]
        assert all(x.device.type == "meta" for x in meta)
        assert len(real) == len(meta)


# -- resolved specs on the production meshes -----------------------------------

@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_resolved_specs_equal_the_reference(production, mesh_kind, arch,
                                            shape):
    want = production["cells"][f"{arch}|{shape}"]
    cfg, sh = get_config(arch), SHAPES[shape]
    if not want["applicable"]:
        rec = dryrun.run_cell(arch, shape, mesh_kind, save=False)
        assert rec == {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "skipped": "long_500k requires sub-quadratic mixing"}
        return
    want = want[mesh_kind]
    mesh = tmesh.make_production_mesh(multi_pod=mesh_kind == "multi")
    rules = dryrun.rules_for(cfg, sh)
    with meshes.sharding_ctx(mesh, rules):
        _, args, in_sh, out_sh, donate = dryrun.build_cell(cfg, sh, mesh,
                                                           rules)
    assert _sds(args) == want["args"]
    assert _shardings(in_sh) == want["in"]
    assert _shardings(out_sh) == want["out"]
    assert list(donate) == want["donate"]


# -- per-device bytes of the reduced cells against XLA -------------------------

def _reduced_cell(arch, shape):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), num_layers=4)
    return cfg, dataclasses.replace(SHAPES[shape], seq=128, batch=8)


@pytest.mark.parametrize("arch,shape", REDUCED)
def test_reduced_cell_bytes_equal_xla(reference, arch, shape):
    xla = reference[1][f"{arch}|{shape}"]
    assert xla["argument_bytes"] == XLA_ARGUMENT_BYTES[arch, shape]
    cfg, sh = _reduced_cell(arch, shape)
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, sh, mesh, dryrun.rules_for(cfg, sh),
                              microbatches=2)
    got = rec["memory"]
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got[k] == xla[k], (k, got[k], xla[k])
    assert got["temp_bytes"] >= 0
    assert got["peak_est_bytes"] == (got["argument_bytes"]
                                     + got["temp_bytes"]
                                     + got["output_bytes"]
                                     - got["alias_bytes"])
    assert rec["chips"] == 8 and rec["compile_s"] is None
    assert rec["num_collectives"] > 0
    assert rec["t_collective"] == rec["collective_traffic_per_device"] \
        / dryrun.LINK_BW > 0
    assert rec["dominant"] == max(
        ("compute", "memory", "collective"), key=lambda k: rec["t_" + k])


@pytest.mark.parametrize("arch,shape", REDUCED)
def test_reduced_collectives_beside_the_reference(reference, arch, shape):
    """The port's collectives, link traffic and FLOPs per device on the
    reduced cell beside what the reference's ``hlo_analysis`` reads from
    XLA's compiled program: both find collectives (not equal: XLA picks
    its own), and the link bytes and FLOPs per device lie within a factor
    of two of the reference's (``PERF.md`` §6 has the ratios, 0.72 to
    1.27 and 0.82 to 0.97).  The line printed is ``PERF.md``'s (run with
    ``-s``)."""
    xla = reference[1][f"{arch}|{shape}"]
    cfg, sh = _reduced_cell(arch, shape)
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, sh, mesh, dryrun.rules_for(cfg, sh),
                              microbatches=2)
    keys = ("num_collectives", "collective_traffic_per_device",
            "flops_per_device")
    side = {k: {"port": rec[k], "reference": xla[k]} for k in keys}
    print(json.dumps({"cell": f"{arch}|{shape}", **side}))
    for k in keys:
        assert side[k]["port"] > 0 and side[k]["reference"] > 0, (k, side)
    for k in ("collective_traffic_per_device", "flops_per_device"):
        assert 0.5 <= side[k]["port"] / side[k]["reference"] <= 2, (k, side)


# -- FLOPs ----------------------------------------------------------------------

FLOP_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
              ("qwen3-4b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
              ("deepseek-v3-671b", "decode_32k"), ("mamba2-1.3b", "train_4k"),
              ("llama-3.2-vision-11b", "prefill_32k"),
              ("musicgen-large", "train_4k"))


def _on_cpu(t, high: int, gen: torch.Generator):
    """A CPU tensor for each meta leaf: small normals, or integers below
    ``high``; ``requires_grad`` kept."""
    if isinstance(t, dict):
        return {k: _on_cpu(v, high, gen) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_on_cpu(v, high, gen) for v in t)
    if t.dtype.is_floating_point:
        x = (torch.randn(t.shape, generator=gen) * 0.05).to(t.dtype)
    else:
        x = torch.randint(0, high, t.shape, generator=gen, dtype=t.dtype)
    return x.requires_grad_(t.requires_grad)


@pytest.mark.parametrize("arch,shape", FLOP_CELLS)
def test_meta_flops_equal_a_cpu_run(arch, shape):
    cfg = reduced_config(get_config(arch))
    sh = dataclasses.replace(SHAPES[shape], seq=64, batch=4)
    mesh = tmesh.make_host_mesh((1, 1), ("data", "model"))
    rules = dryrun.rules_for(cfg, sh)
    with meshes.sharding_ctx(mesh, rules):
        fn, args, *_ = dryrun.build_cell(cfg, sh, mesh, rules,
                                         microbatches=2)
        _, counts = dryrun.trace(fn, args)
        cpu = _on_cpu(args, min(cfg.vocab_size, sh.seq),
                      torch.Generator().manual_seed(0))
        fn_cpu = dryrun.build_cell(cfg, sh, mesh, rules, microbatches=2)[0]
    # the CPU run under a live slot mesh of the same shape, so that both
    # runs take the same MoE path (expert-parallel under a "model" axis)
    live = tmesh.make_host_mesh((1, 1), ("data", "model"), device="cpu")
    fc = FlopCounterMode(display=False)
    with fc, meshes.sharding_ctx(live, rules):
        fn_cpu(*cpu)
    assert counts["flops"] == fc.get_total_flops() > 0


def test_dense_reduced_train_flops_equal_the_closed_form():
    """Reduced qwen3-4b, 4 layers, 8 x 128 tokens in 2 microbatches, flash
    block 32.  Per layer forward: the projections, the scores and P·V of
    every KV block (the plain K9 computes all of them) and the SwiGLU
    MLP; the tied unembedding once.  The step runs the forward, remat's
    second forward of each layer — without the layer's last product,
    h @ wo, whose output no backward needs (non-reentrant checkpointing
    stops recomputing once every saved tensor is back) — and a backward
    of two products per product."""
    cfg, sh = _reduced_cell("qwen3-4b", "train_4k")
    d, H, KV, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    B, S, n = sh.batch, sh.seq, cfg.num_layers
    T = B * S
    proj = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d
    attn = 2 * (2 * B * H * S * S * hd)
    mlp_in, mlp_out = 2 * (2 * T * d * ff), 2 * T * ff * d
    layer = proj + attn + mlp_in + mlp_out
    logits = 2 * T * d * V
    want = n * (3 * layer + (layer - mlp_out)) + 3 * logits
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, sh, mesh, dryrun.rules_for(cfg, sh),
                              microbatches=2)
    assert rec["flops_total"] == want


# -- the meter -----------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_meter_counts_bytes_and_peak():
    def f(x):
        y = x * 2
        return y.sum()

    out, c = dryrun.trace(f, (_meta(1000),))
    assert c["bytes"] == (4000 + 4000) + (4000 + 4)
    assert c["peak_beyond_args"] == 4000 + 4 and c["ops"] == 2
    assert c["flops"] == 0 and out.device.type == "meta"


def test_meter_counts_memo_hits_and_moves_nothing_for_views():
    def f(x):
        a = x * 2
        b = x * 2                   # same signature: a memo hit
        return (a + b).view(10, 100).t()

    out, c = dryrun.trace(f, (_meta(1000),))
    assert c["ops"] == 5 and tuple(out.shape) == (100, 10)
    assert c["bytes"] == 8000 + 8000 + 12000
    assert c["peak_beyond_args"] == 12000


def test_meter_memo_counts_what_the_first_call_counted():
    """An op that moves nothing (``empty``) moves nothing on a memo hit
    either; the counts equal those of a meter with no memo."""
    def f(x):
        parts = [torch.empty_like(x) for _ in range(3)]
        return [x * 2 for _ in range(3)] + parts

    _, memo = dryrun.trace(f, (_meta(1000),))
    assert memo["bytes"] == 3 * 8000 and memo["ops"] == 6


class _NoMemo(dict):
    """A memo that keeps nothing: every op is planned afresh."""

    def __setitem__(self, key, value):
        pass


def _memo_off(monkeypatch):
    init = dryrun._Meter.__init__

    def without(self, *a, **kw):
        init(self, *a, **kw)
        self.memo = _NoMemo()

    monkeypatch.setattr(dryrun._Meter, "__init__", without)


@pytest.mark.parametrize("arch,shape", REDUCED)
def test_memo_changes_no_count(monkeypatch, arch, shape):
    """The whole reduced cell traced on its (2, 4) mesh from its input
    shardings to its output shardings, with the memo and with a memo that
    keeps nothing: every count equal — FLOPs and bytes per device, the
    collectives, the fallback gathers."""
    cfg, sh = _reduced_cell(arch, shape)
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))

    def counts():
        rules = dryrun.rules_for(cfg, sh)
        with meshes.sharding_ctx(mesh, rules):
            fn, args, in_sh, out_sh, _ = dryrun.build_cell(
                cfg, sh, mesh, rules, microbatches=2)
            c = dryrun.trace(fn, args, (sh.seq, cfg.flash_block), mesh,
                             in_sh, out_sh)[1]
        return {k: v for k, v in c.items() if k != "seconds"}

    with_memo = counts()
    assert with_memo["num_collectives"] > 0
    _memo_off(monkeypatch)
    assert counts() == with_memo


def test_memo_replans_a_split_after_its_merge():
    """A reshape's layout depends on the merges the trace remembers: a
    split planned before a merge was remembered is planned again after
    it, and then gives the merged dims their axes back (no gather)."""
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))

    def f(y, x, y2):
        y.view(4, 2)                        # split, no merge remembered
        x.reshape(8)                        # merges (4, 2) -> 8 over data
        return y2.view(4, 2) + x            # the split undoes that merge

    args = (_meta(8), _meta(4, 2), _meta(8))
    in_sh = tuple(meshes.NamedSharding(mesh, s) for s in
                  (("data",), (None, "data"), ("data",)))
    out_sh = meshes.NamedSharding(mesh, (None, "data"))
    c = dryrun.trace(f, args, mesh=mesh, in_shardings=in_sh,
                     out_shardings=out_sh)[1]
    assert c["num_collectives"] == 0, c["collectives"]


def test_meter_counts_matmul_flops_and_score_bytes():
    def f(q, k):
        return torch.einsum("bqd,btd->bqt", q, k)

    _, c = dryrun.trace(f, (_meta(2, 64, 8), _meta(2, 16, 8)),
                        score_dims=(64, 16))
    assert c["flops"] == 2 * 2 * 64 * 16 * 8
    assert c["score_bytes"] > 0 and c["score_bytes"] <= c["bytes"]
    _, c = dryrun.trace(f, (_meta(2, 64, 8), _meta(2, 16, 8)),
                        score_dims=(64, 64))
    assert c["score_bytes"] == 0


# -- per device and collectives -----------------------------------------------

@pytest.mark.parametrize("arch,shape", REDUCED)
def test_one_device_moves_nothing_and_counts_everything(arch, shape):
    cfg, sh = _reduced_cell(arch, shape)
    mesh = tmesh.make_host_mesh((1, 1), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, sh, mesh, dryrun.rules_for(cfg, sh),
                              microbatches=2)
    assert rec["num_collectives"] == 0 and rec["t_collective"] == 0
    assert rec["collective_summary"] == [] and rec["fallback_gathers"] == {}
    assert rec["flops_per_device"] == rec["flops_total"] > 0
    assert rec["hbm_bytes_per_device"] == rec["hbm_bytes_total"] > 0


def test_pure_data_parallel_step_all_reduces_each_gradient_once():
    """Reduced qwen3-4b, 16 x 128 tokens in 2 microbatches, every weight
    whole on every device and the batch over ("data", "model"): each
    parameter's gradient (f32, summed over both microbatches first) is
    all-reduced over the 8 devices once.  Besides: each microbatch's loss
    scalar, settled where the aux term is added to it, and the microbatch
    split — row block i of the batch lies on data row i, and
    ``_split_micro`` pins each microbatch's rows over both axes, so
    inputs and labels are gathered over data."""
    cfg, sh = _reduced_cell("qwen3-4b", "train_4k")
    sh = dataclasses.replace(sh, batch=16)
    rules = {k: () for k in meshes.DEFAULT_RULES}
    rules["batch"] = ("data", "model")
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, sh, mesh, rules, microbatches=2)
    want = collectives.Collectives()
    params = abstract_state(cfg, OptConfig())["params"]
    for p in tree.leaves(params):
        want.add("all-reduce", p.numel() * 4, 8)
    want.add("all-reduce", 4, 8, mult=2)
    for t in input_specs(cfg, sh).values():
        want.add("all-gather", t.numel() * t.element_size() // 4, 2)
    assert rec["num_collectives"] == want.count == len(tree.leaves(params)) \
        + 4
    assert rec["collective_traffic_per_device"] == want.traffic
    assert rec["collective_summary"] == want.summary()
    assert rec["flops_per_device"] == rec["flops_total"] / 8


def _ep_cell(mesh_shape):
    cfg, sh = _reduced_cell("deepseek-v3-671b", "decode_32k")
    return cfg, sh, tmesh.make_host_mesh(mesh_shape, ("data", "model"))


@pytest.mark.parametrize("mesh_shape,variant", [((2, 4), "ff"),
                                                ((1, 4), "full")])
def test_ep_exchanges_equal_their_closed_form(monkeypatch, mesh_shape,
                                              variant):
    """Reduced deepseek-v3's decode step (E = 4 experts, top-2) takes the
    expert-parallel path: "ff" on (2, 4), full-mesh EP on (1, 4).  Per MoE
    layer the dispatch and the return are all-to-alls over the group g of
    slots an expert's tokens come from, each slot sending its whole (E, C,
    d) buffer (C = capacity(T, k, E, factor) for its T tokens); "ff" also
    gathers each group's tokens over data and psums the partial outputs
    over data, data times that buffer each (``chip_smoke.py``'s
    ``ep_exchange_bytes`` counts the same buffers over every slot)."""
    from repro_torch.models import moe as moe_mod
    cfg, sh, mesh = _ep_cell(mesh_shape)
    calls = []
    real = moe_mod.moe_apply_ep
    monkeypatch.setattr(moe_mod, "moe_apply_ep",
                        lambda *a: calls.append(a) or real(*a))
    rules = dryrun.rules_for(cfg, sh)
    with meshes.sharding_ctx(mesh, rules):
        fn, args, in_sh, out_sh, _ = dryrun.build_cell(cfg, sh, mesh, rules)
        _, counts = dryrun.trace(fn, args, None, mesh, in_sh, out_sh)
    e = cfg.moe
    moe_layers = cfg.num_layers - cfg.dense_prefix
    assert len(calls) == moe_layers
    D, M = mesh_shape
    g = M if variant == "ff" else D * M
    T = (sh.batch // D) * 1                 # one position; S = 1 < M
    C = moe_mod.capacity(T, e.top_k, e.num_experts, e.capacity_factor)
    buf = e.num_experts * C * cfg.d_model * 4
    got = {(c["op"], c["result_bytes"], c["group"]): c["mult"]
           for c in counts["collectives"]}
    assert got[("all-to-all", buf, g)] == 2 * moe_layers
    assert sum(m for (op, _, _), m in got.items() if op == "all-to-all") \
        == 2 * moe_layers
    if variant == "ff":
        assert got[("all-gather", D * buf, D)] == moe_layers
        assert got[("all-reduce", D * buf, D)] == moe_layers


def test_the_layout_changes_the_price():
    """Reduced qwen3-4b's train step on (2, 4) with the heads over model
    and with them whole: different compute and collective terms, so the
    layout search's objective depends on the layout."""
    cfg, sh = _reduced_cell("qwen3-4b", "train_4k")
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    recs = [dryrun.analyze_cell(cfg, sh, mesh,
                                dryrun.rules_for(cfg, sh, {"heads": h}),
                                microbatches=2)
            for h in (("model",), ())]
    assert recs[0]["t_compute"] != recs[1]["t_compute"]
    assert recs[0]["t_collective"] != recs[1]["t_collective"]
    assert recs[0]["flops_total"] == recs[1]["flops_total"]


def test_memo_keys_on_operand_layouts():
    """One product on operands of equal shapes, once with its contraction
    split on one side and once whole: the second is no memo hit of the
    first (it moves nothing)."""
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    args = (_meta(8, 16), _meta(8, 16), _meta(16, 32))
    specs = ((None, "model"), (None, None), (None, None))
    in_sh = tuple(meshes.NamedSharding(mesh, s) for s in specs)
    _, c = dryrun.trace(lambda a, b, w: (a @ w, b @ w), args, mesh=mesh,
                        in_shardings=in_sh)
    _, one = dryrun.trace(lambda a, w: a @ w, (args[0], args[2]), mesh=mesh,
                          in_shardings=(in_sh[0], in_sh[2]))
    assert one["num_collectives"] == 1
    assert c["collectives"] == one["collectives"]


# -- meshes --------------------------------------------------------------------

def test_production_and_host_meshes(monkeypatch):
    m1 = tmesh.make_production_mesh()
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert m1.shape == {"data": 16, "model": 16} and m1.size == 256
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert meshes.num_chips(m2) == 512
    assert tmesh.make_host_mesh((2, 4), ("data", "model")).size == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_host_mesh().shape == {"data": 1, "model": 2}


def test_sharding_ctx_merges_rules_and_keeps_data_meshes():
    mesh = tmesh.make_production_mesh()
    assert meshes.current_rules() == meshes.DEFAULT_RULES
    with meshes.sharding_ctx(mesh, {"embed": ()}):
        assert meshes.active_mesh() is mesh
        assert meshes.current_rules() == dict(meshes.DEFAULT_RULES,
                                              embed=())
        s = meshes.sharding_for(("embed", "vocab"), (2560, 151936))
        assert s.spec == (None, "model")
        assert meshes.shard_shape((2560, 151936), s.spec, mesh) \
            == (2560, 9496)
    assert meshes.active_mesh() is None
    assert meshes.current_rules() == meshes.DEFAULT_RULES
    slots = meshes.data_mesh(2, device="cpu")
    with meshes.sharding_ctx(slots):
        assert meshes.active_mesh() is slots
    # axes that do not divide a dim, or are used already, are dropped
    multi = tmesh.make_production_mesh(multi_pod=True)
    rules = meshes.DEFAULT_RULES
    assert meshes.spec_for(("batch", "seq"), (32, 4096), multi, rules) \
        == (("pod", "data"), None)
    assert meshes.spec_for(("batch",), (2, ), multi, rules) == ("pod",)
    assert meshes.spec_for(("heads", "kv"), (32, 8), multi, rules) \
        == ("model", None)
    assert meshes.shard_shape((32, 4096), (("pod", "data"), None), multi) \
        == (1, 4096)


# -- the CLI -------------------------------------------------------------------

def test_cli_runs_without_a_card_and_writes_its_record(tmp_path):
    code = textwrap.dedent(f"""
        import runpy, sys, torch
        sys.argv = ["dryrun", "--arch", "qwen3-4b", "--shape", "decode_32k",
                    "--results", {str(tmp_path)!r}]
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__",
                         alter_sys=True)
        print("cuda initialised:", torch.cuda.is_initialized())
        sys.argv = ["dryrun", "--summary", "--results", {str(tmp_path)!r}]
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__",
                         alter_sys=True)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].split()[:3] == ["qwen3-4b", "decode_32k", "single"]
    assert lines[1] == "dry-run complete"
    assert lines[2] == "cuda initialised: False"
    assert lines[3] == "=== mesh: single ===" and lines[4] == lines[0]
    rec = json.loads((tmp_path / "single" / "qwen3-4b__decode_32k.json")
                     .read_text())
    assert lines[0] == dryrun.fmt_cell(rec)
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["memory"]["alias_bytes"] > 0 and rec["compile_s"] is None
    assert rec["collective_traffic_per_device"] > 0
    assert rec["num_collectives"] > 0 and rec["t_collective"] > 0
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["flops_total"] > rec["flops_per_device"]
