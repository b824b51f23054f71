"""Dry run of every (arch x shape x mesh) cell, on PyTorch's meta device.

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads XLA's memory and cost analyses.  PyTorch has no
ahead-of-time compiler to read, so here each cell's own step function
(``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``)
runs once on ``torch.device("meta")`` tensors, which have shapes and
dtypes and no storage.  Nothing is allocated on any device and CUDA is
never initialised, so the dry run needs no card; no kernel is reached (a
meta tensor takes each wrapper's plain version, as any non-CUDA tensor
does).  The logical-axis rules (``distributed.meshes``) resolve every
leaf's spec on a device-free production mesh (``launch.mesh``).

What each field of the record holds:

* ``memory.argument_bytes`` / ``output_bytes`` / ``alias_bytes`` —
  exact: the sum over the input (output; donated and returned) leaves
  of their per-device shard bytes under the resolved specs.  As XLA's
  ``memory_analysis`` does, the output size also holds the output
  tuple's table of leaf pointers (``TUPLE_POINTER_BYTES`` a leaf).
* ``flops_per_device`` — ``FlopCounterMode``'s count over the meta
  run, divided by ``chips``.  The step runs the whole cell on one
  device, so this (and every ``*_per_device`` count below) is an ideal
  split (``per_device_split`` says so).
* ``hbm_bytes_per_device`` — the bytes each dispatched op reads and
  writes (every tensor argument read whole, every output written whole;
  views move nothing), summed and divided by ``chips``: an unfused upper
  bound.  ``score_bytes_per_device`` is the part of it moved by ops on
  attention-score tensors (a dim of S and one of the flash block, as the
  reference's ``score_dims`` picks them: on meta, the plain K9's
  per-block scores), and ``t_memory_kernelized`` the memory term without
  it.
* ``memory.temp_bytes`` — the peak of live bytes beyond the arguments
  during the meta run, divided by ``chips``, less the outputs that are
  not aliased (live at the run's end, and counted in ``output_bytes``),
  so that ``peak_est_bytes`` = arguments + temp + outputs - aliased is
  the predicted peak.
* ``t_compute`` / ``t_memory`` — on the NVIDIA H100 80GB HBM3 (700 W):
  ``PEAK_FLOPS`` dense bf16, ``HBM_BW``.
* ``collective_traffic_per_device``, ``num_collectives``,
  ``t_collective`` — ``None``: no program is partitioned, so no
  collective is measured (ROADMAP queue 1, item 13h);
  ``dominant`` is taken over the terms that are not ``None``.
* ``lower_s`` — the meta trace's seconds; ``compile_s`` ``None``.

A train cell traces every microbatch as the step runs it.  Ops are
dispatched through a memo of their output metadata: an op that makes a
fresh tensor from inputs of the same shapes, strides and dtypes (and the
same other arguments) as an earlier call gets an empty meta tensor of
the earlier output's layout in place of a second shape inference; each
call is still counted.

Results are cached as JSON under ``build/repro_torch/dryrun/<mesh>/``
(``--results`` names another directory).  Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, cell_is_applicable, input_specs
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed.meshes import (NamedSharding, num_chips,
                                            shard_shape, sharding_ctx,
                                            tree_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import tree

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "repro_torch" / "dryrun")

# NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16 tensor-core peak, HBM3
PEAK_FLOPS = 989e12          # FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
TUPLE_POINTER_BYTES = 8      # XLA's output tuple: one pointer per leaf
PER_DEVICE_SPLIT = ("ideal: the whole cell traced on one device, "
                    "counts divided by chips")


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6·N·D for a fwd+bwd train step."""
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    """2·N per generated token (forward only)."""
    return 2.0 * n_active_params * tokens


# ---------------------------------------------------------------------------
# Per-cell rules (baseline; the autoshard hillclimber perturbs these)
# ---------------------------------------------------------------------------

def rules_for(cfg, shape, overrides=None):
    rules = {}
    if shape.kind == "train":
        # DEFAULT_RULES = FSDP + TP; fine-grained MoE (>=256 experts) gets
        # full-mesh expert parallelism (each device owns whole experts)
        if cfg.moe is not None and cfg.moe.num_experts % 256 == 0:
            rules["experts"] = ("data", "model")
            rules["expert_mlp"] = ()
    else:
        # serving: replicate weights across data (low-latency TP), except
        # MoE experts which are expert-parallel across the whole mesh.
        rules["embed"] = ()
        # MLA: shard the latent-cache dim over model for decode only
        # (hillclimbed: halves decode memory term and HBM/dev on
        # deepseek-v3; hurts prefill where the latent is recomputed)
        rules["lora"] = (("model",) if cfg.mla is not None
                         and shape.kind == "decode" else ())
        if cfg.moe is not None:
            total = 256
            if cfg.moe.num_experts % total == 0:
                rules["experts"] = ("data", "model")
                rules["expert_mlp"] = ()
            else:
                rules["experts"] = ("model",)
                rules["expert_mlp"] = ("data",)
        if shape.name == "long_500k":
            rules["kv_seq"] = ("pod", "data")    # sequence-parallel KV
    rules.update(overrides or {})
    return rules


def default_microbatches(cfg, shape) -> int:
    n = cfg.param_count()
    if n > 100e9:
        return 8
    if n > 10e9:
        return 4
    return 2


def input_axes(cfg, shape):
    ax = {}
    if shape.kind == "train":
        ax["inputs"] = (("batch", "seq", None) if cfg.input_mode == "embeddings"
                        else ("batch", "seq"))
        ax["labels"] = ("batch", "seq")
    elif shape.kind == "prefill":
        ax["inputs"] = (("batch", "seq", None) if cfg.input_mode == "embeddings"
                        else ("batch", "seq"))
    else:
        ax["inputs"] = (("batch", None, None) if cfg.input_mode == "embeddings"
                        else ("batch", None))
        ax["positions"] = ("batch",)
    if cfg.family == "vlm":
        ax["image_embeds"] = ("batch", "img", None)
    return ax


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def build_cell(cfg, shape, mesh, rules, microbatches=None):
    """Returns (fn, args, in_shardings, out_shardings, donate_argnums), the
    args meta tensors."""
    from repro_torch.models.transformer import Model, cache_specs, init_cache
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (abstract_state, make_train_step,
                                              state_axes)

    specs = input_specs(cfg, shape)
    in_ax = input_axes(cfg, shape)
    repl = NamedSharding(mesh, ())

    def shard_of(axes, abstract):
        return tree_shardings(axes, abstract, mesh, rules)

    if shape.kind == "train":
        state_dtype = "bfloat16" if cfg.param_count() > 50e9 else "float32"
        opt_cfg = opt_mod.OptConfig(state_dtype=state_dtype)
        mb = microbatches or default_microbatches(cfg, shape)
        fn = make_train_step(cfg, opt_cfg, microbatches=mb)
        state = abstract_state(cfg, opt_cfg)
        st_sh = shard_of(state_axes(cfg), state)
        batch_keys = [k for k in ("inputs", "labels", "image_embeds")
                      if k in specs]
        batch = {k: specs[k] for k in batch_keys}
        b_sh = {k: shard_of(in_ax[k], batch[k]) for k in batch_keys}
        metrics_sh = {k: repl for k in ("loss", "ce", "lr", "grad_norm")}
        return (fn, (state, batch), (st_sh, b_sh),
                (st_sh, metrics_sh), (0,))

    model = Model(cfg)
    params = model.abstract_params()
    p_sh = shard_of(model.param_axes(), params)
    cs = init_cache(cfg, shape.batch, shape.seq, device="meta")
    c_sh = shard_of(cache_specs(cfg, shape.batch, shape.seq)[1], cs)
    logits_sh = shard_of(("batch", "vocab"), (shape.batch, cfg.vocab_size))

    if shape.kind == "prefill":
        fn = make_prefill_step(cfg)
        args = [params, specs["inputs"]]
        in_sh = [p_sh, shard_of(in_ax["inputs"], specs["inputs"])]
        if "image_embeds" in specs:
            args.append(specs["image_embeds"])
            in_sh.append(shard_of(in_ax["image_embeds"], specs["image_embeds"]))
        return (fn, tuple(args), tuple(in_sh), (logits_sh, c_sh), ())

    # decode
    fn = make_decode_step(cfg)
    args = [params, cs, specs["inputs"], specs["positions"]]
    in_sh = [p_sh, c_sh,
             shard_of(in_ax["inputs"], specs["inputs"]),
             shard_of(in_ax["positions"], specs["positions"])]
    if "image_embeds" in specs:
        args.append(specs["image_embeds"])
        in_sh.append(shard_of(in_ax["image_embeds"], specs["image_embeds"]))
    return (fn, tuple(args), tuple(in_sh), (logits_sh, c_sh), (1,))


# ---------------------------------------------------------------------------
# Per-device bytes from the resolved specs
# ---------------------------------------------------------------------------

def sharded_leaves(values, shardings) -> list:
    """(tensor, sharding) pairs of a value tree and its sharding tree,
    which must have one structure."""
    vals, structure = tree.flatten(values)
    shs, want = tree.flatten(shardings)
    assert structure == want, "values and shardings differ in structure"
    return list(zip(vals, shs))


def shard_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    return math.prod(shard_shape(tuple(t.shape), sharding.spec,
                                 sharding.mesh)) * t.element_size()


def tree_bytes(values, shardings) -> int:
    """The per-device bytes of a tree: each leaf's shard."""
    return sum(shard_bytes(t, s) for t, s in sharded_leaves(values,
                                                              shardings))


# ---------------------------------------------------------------------------
# The meta trace
# ---------------------------------------------------------------------------

def _sig(x, tensors: list):
    """A hashable stand-in for an op argument; tensors are appended to
    ``tensors``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("T", x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y, tensors) for y in x)
    return (type(x), x)


def _layout(out):
    """The output's layout if it is a tensor or a tuple/list of tensors:
    (the sequence type or None, each tensor's shape, strides, dtype)."""
    if isinstance(out, torch.Tensor):
        return None, [(tuple(out.shape), out.stride(), out.dtype)]
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        return type(out), [(tuple(t.shape), t.stride(), t.dtype)
                           for t in out]
    return None


def _fabricate(layout):
    seq, parts = layout
    made = [torch.empty_strided(s, st, dtype=dt, device="meta")
            for s, st, dt in parts]
    return made[0] if seq is None else seq(made)


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Counts, per dispatched op, the bytes it moves (and those on score
    tensors), and keeps the live bytes of storages made during the run
    (a storage's bytes leave the count when PyTorch frees it)."""

    def __init__(self, args, score_dims=None):
        super().__init__()
        self.bytes = 0
        self.score_bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.memo: dict = {}
        self.score_dims = score_dims
        self.seen = {t.untyped_storage()._cdata for t in tree.leaves(args)}

    def _is_score(self, t: torch.Tensor) -> bool:
        S, blk = self.score_dims
        return S in t.shape and blk in t.shape

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        self.seen.add(key)
        nb = st.nbytes()
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nb)

    def _free(self, key, nb: int):
        self.seen.discard(key)
        self.live -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: list = []
        key = (func, _sig(args, ins), tuple(kwargs),
               _sig(tuple(kwargs.values()), ins))
        layout = self.memo.get(key)
        if layout is not None:
            out, moves = _fabricate(layout[0]), layout[1]
        else:
            out = func(*args, **kwargs)
            outs = _outputs(out)
            in_storages = {t.untyped_storage()._cdata for t in ins}
            fresh = all(t.untyped_storage()._cdata not in in_storages
                        for t in outs)
            mutates = func._schema.is_mutable
            moves = (fresh or mutates) and \
                not func.name().startswith("aten::empty")
            if fresh and not mutates:
                lay = _layout(out)
                if lay is not None:
                    self.memo[key] = (lay, moves)
        self.ops += 1
        outs = _outputs(out)
        for t in outs:
            self._track(t)
        if moves:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.bytes += b
            if self.score_dims and any(self._is_score(t)
                                       for t in ins + outs):
                self.score_bytes += b
        return out


def trace(fn, args, score_dims=None) -> tuple:
    """Run ``fn(*args)`` on meta tensors under the flop counter and the
    meter: (outputs, counts).  ``counts`` holds the whole run's flops,
    bytes moved, score bytes, peak live bytes beyond the arguments, ops
    and seconds."""
    if score_dims is not None and score_dims[0] == score_dims[1]:
        score_dims = None               # the reference's is_score rule
    meter = _Meter(args, score_dims)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with meter, flops:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return out, {"flops": flops.get_total_flops(), "bytes": meter.bytes,
                 "score_bytes": meter.score_bytes,
                 "peak_beyond_args": meter.peak, "ops": meter.ops,
                 "seconds": seconds}


def roofline(chips: int, flops: float, hbm_bytes: float,
             score_bytes: float) -> dict:
    """The reference's ``Roofline.as_dict`` keys, on the H100's constants;
    the collective terms ``None`` (nothing partitioned, nothing
    measured)."""
    f, b, s = flops / chips, hbm_bytes / chips, score_bytes / chips
    terms = {"compute": f / PEAK_FLOPS, "memory": b / HBM_BW}
    return {
        "chips": chips,
        "flops_per_device": f,
        "hbm_bytes_per_device": b,
        "collective_traffic_per_device": None,
        "num_collectives": None,
        "t_compute": terms["compute"],
        "t_memory": terms["memory"],
        "t_collective": None,
        "dominant": max(terms, key=terms.get),
        "t_memory_kernelized": max(b - s, 0.0) / HBM_BW,
        "score_bytes_per_device": s,
        "collective_summary": None,
        "raw_cost_analysis": None,
        "per_device_split": PER_DEVICE_SPLIT,
    }


def analyze_cell(cfg, shape, mesh, rules, microbatches=None) -> dict:
    """Build the cell, trace it on meta tensors and measure it: the
    record's memory and roofline fields plus ``lower_s`` and ``ops``."""
    chips = num_chips(mesh)
    with sharding_ctx(mesh, rules):
        fn, args, in_sh, out_sh, donate = build_cell(
            cfg, shape, mesh, rules, microbatches)
        arg_bytes = tree_bytes(args, in_sh)
        alias = sum(tree_bytes(args[i], in_sh[i]) for i in donate)
        score_dims = ((shape.seq, min(cfg.flash_block, shape.seq))
                      if shape.kind in ("train", "prefill") else None)
        out, counts = trace(fn, args, score_dims)
        pairs = sharded_leaves(out, out_sh)
    out_bytes = sum(shard_bytes(t, s) for t, s in pairs) \
        + TUPLE_POINTER_BYTES * len(pairs)
    temp = max(0, counts["peak_beyond_args"] // chips - (out_bytes - alias))
    return {
        "lower_s": counts["seconds"], "compile_s": None,
        "ops": counts["ops"],
        "memory": {
            "argument_bytes": arg_bytes,
            "temp_bytes": temp,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "peak_est_bytes": arg_bytes + temp + out_bytes - alias,
        },
        **roofline(chips, counts["flops"], counts["bytes"],
                   counts["score_bytes"]),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rule_overrides=None, microbatches=None, tag: str = "",
             save: bool = True, results_dir=None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not cell_is_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "long_500k requires sub-quadratic mixing"}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rules = rules_for(cfg, shape, rule_overrides)
    measured = analyze_cell(cfg, shape, mesh, rules, microbatches)

    tokens = shape.batch * (shape.seq if shape.kind == "train" else 1)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        mf = model_flops_train(n_active, tokens)
    else:
        mf = model_flops_decode(n_active, tokens)
        if shape.kind == "prefill":
            mf = model_flops_decode(n_active, shape.batch * shape.seq)
    total_flops = measured["flops_per_device"] * measured["chips"]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "chips": measured["chips"], "tag": tag,
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
        "microbatches": microbatches,
        "params": cfg.param_count(), "active_params": n_active,
        "model_flops": mf,
        "useful_flops_ratio": (mf / total_flops) if total_flops else 0,
        **measured,
    }
    if save:
        out = pathlib.Path(results_dir or RESULTS_DIR) / mesh_kind
        out.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}{('__' + tag) if tag else ''}.json"
        (out / name).write_text(json.dumps(rec, indent=1))
    return rec


def _ms(t) -> str:
    return f"{'n/a':>11s}" if t is None else f"{t * 1e3:9.2f}ms"


def fmt_cell(r):
    if "skipped" in r:
        return f"{r['arch']:22s} {r['shape']:12s} SKIP ({r['skipped']})"
    m = r["memory"]["peak_est_bytes"] / 2**30
    return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
            f"comp={_ms(r['t_compute'])} mem={_ms(r['t_memory'])} "
            f"coll={_ms(r['t_collective'])} dom={r['dominant']:10s} "
            f"useful={r['useful_flops_ratio']:5.1%} hbm/dev={m:6.2f}GiB "
            f"trace={r['lower_s']:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="rule override, e.g. --set embed=pod,data")
    ap.add_argument("--results", default=None,
                    help=f"results directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)
    results = pathlib.Path(args.results or RESULTS_DIR)

    if args.summary:
        for mk in ("single", "multi"):
            d = results / mk
            if not d.exists():
                continue
            print(f"=== mesh: {mk} ===")
            for f in sorted(d.glob("*.json")):
                print(fmt_cell(json.loads(f.read_text())))
        return

    overrides = {}
    for s in args.set:
        k, _, v = s.partition("=")
        overrides[k] = tuple(x for x in v.split(",") if x)

    cells = []
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            cells.append((a, s))

    failures = []
    for a, s in cells:
        out = (results / args.mesh /
               f"{a}__{s}{('__' + args.tag) if args.tag else ''}.json")
        if out.exists() and not args.force:
            print(f"cached {a} {s}")
            continue
        try:
            rec = run_cell(a, s, args.mesh, overrides or None,
                           args.microbatches, args.tag, results_dir=results)
            print(fmt_cell(rec), flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((a, s, repr(e)))
            print(f"FAIL {a} {s}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} failures")
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
