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
* ``flops_per_device`` / ``hbm_bytes_per_device`` — per device, as
  the resolved specs split each op (see the meter below): each op's
  FLOPs (``torch.utils.flop_counter``'s registry) and bytes divided by
  the devices that split its work — the product of the mesh axes its
  output is split over and of those its contraction is split over (a
  tensor's bytes at the layout it is read or written at).  An op on
  whole tensors counts whole on every device, as the reference's
  per-device HLO does (``per_device_split`` says "resolved specs").
  ``flops_total`` / ``hbm_bytes_total`` are the whole trace's counts.
  Bytes are every tensor argument read whole and every output written
  whole (views move nothing): an unfused upper bound.
  ``score_bytes_per_device`` is the part moved by ops on attention-score
  tensors (a dim of S and one of the flash block, as the reference's
  ``score_dims`` picks them: on meta, the plain K9's per-block scores),
  and ``t_memory_kernelized`` the memory term without it.
* ``memory.temp_bytes`` — the peak of live bytes beyond the arguments
  during the meta run, divided by ``chips``, less the outputs that are
  not aliased (live at the run's end, and counted in ``output_bytes``),
  so that ``peak_est_bytes`` = arguments + temp + outputs - aliased is
  the predicted peak.
* ``t_compute`` / ``t_memory`` — on the NVIDIA H100 80GB HBM3 (700 W):
  ``PEAK_FLOPS`` dense bf16, ``HBM_BW``.
* ``collective_traffic_per_device``, ``num_collectives``,
  ``t_collective``, ``collective_summary`` — the collectives the layouts
  imply, each priced by the reference's ring model
  (``distributed.collectives``): link bytes per device over the step,
  their count, the link term at ``LINK_BW`` (one published link figure
  for every group; no overlap with compute is assumed or modelled) and
  the 15 that move the most.  ``dominant`` is the largest of the three
  terms.  ``fallback_gathers`` counts, by aten name, the ops with no
  layout rule that gathered a split input: where the model is coarse.
* ``lower_s`` — the meta trace's seconds; ``compile_s`` ``None``.

The meter carries a layout per tensor: the mesh axes each dim is split
over, and the axes over which the value is a pending partial sum.
Inputs take their ``in_shardings``; ``constrain`` (``distributed.meshes``,
whose recorder the meter is during the trace) pins a layout, and so does
its transpose in the backward; the outputs end at their
``out_shardings``.  By op family: pointwise ops merge their operands'
layouts by broadcasting (where two disagree, the split one wins and the
other is gathered; a dim an op reads whole, as a softmax's, is
gathered); views and reshapes map dims through splits and merges (a
device flattens or splits its own block, a split undoes a merge it
remembers; axes that fit no new dim are gathered); ``mm`` / ``bmm``
take, of a few layouts of their batch, contraction and free dims, the
one whose gathers and settled sums move the fewest bytes (a contraction
split alike on both sides is a pending sum); sums over a split dim are
pending sums, other reductions all-reduce their result; indexing by a
tensor whose dim is split alike, or slot-local (``meshes.slot_local``),
stays on each device, a masked lookup or an accumulating write across
split axes is a pending sum; every other op gathers its split inputs and
returns a whole result (``fallback_gathers``).  A gather is an all-gather over the axes
it undoes; a pending sum is settled where a consumer, ``constrain`` or an
output needs it whole — a reduce-scatter over the axes its destination
is split over, an all-reduce over the rest — and a sum plus a sum stays
pending, so microbatch gradient sums settle once.  The expert-parallel
MoE tells the recorder what its slot axis is and reports its own
exchanges (``models.moe``).

A train cell traces every microbatch as the step runs it.  Ops are
dispatched through a memo keyed by their inputs' shapes, strides, dtypes
and layouts (and their other arguments): a call like an earlier one
reuses its layouts, collectives and per-device counts, and, if it made a
fresh tensor, gets an empty meta tensor of the earlier output's layout
in place of a second shape inference; each call is still counted.  An op
on a pending sum is not memoised: settling it depends on the sum.  Nor is
a reshape: its layout depends on the merges the trace has remembered so
far (``_Meter._reshape``).

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
from fractions import Fraction
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, cell_is_applicable, input_specs
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import meshes
from repro_torch.distributed.collectives import (LINK_BW, SUMMARY_TOP,
                                                 Collectives, _ring_traffic,
                                                 transposed)
from repro_torch.distributed.meshes import (NamedSharding, entry_axes,
                                            num_chips, shard_shape,
                                            sharding_ctx, tree_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import tree

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "repro_torch" / "dryrun")

# NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16 tensor-core peak, HBM3
PEAK_FLOPS = 989e12          # FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
TUPLE_POINTER_BYTES = 8      # XLA's output tuple: one pointer per leaf
PER_DEVICE_SPLIT = "resolved specs"


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

def _sig(x, tensors: list, key):
    """A hashable stand-in for an op argument; tensors are appended to
    ``tensors`` and stand in by shape, strides, dtype and ``key(t)``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("T", x.shape, x.stride(), x.dtype, key(x))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y, tensors, key) for y in x)
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


_SPEC = "_dryrun_spec"          # the attribute a traced tensor carries


class _Pending:
    """A sum still spread over mesh ``axes``: each device of those axes
    holds a part.  Tensors derived from it linearly (views, casts, scalar
    products) share the object, so it is settled once, at the bytes of the
    tensor it was made as (``nbytes`` per device)."""
    __slots__ = ("axes", "nbytes", "settled")

    def __init__(self, axes: tuple, nbytes: int):
        self.axes, self.nbytes, self.settled = axes, nbytes, False


class _Spec(NamedTuple):
    """What the meter knows of a tensor's layout."""
    dims: tuple                         # per dim, the mesh axes it is split over
    pend: Optional[_Pending] = None     # a sum pending over mesh axes
    zero: bool = False                  # all zeros (an accumulator's start)
    local: bool = False                 # a slot-local index (meshes.slot_local)


class _Plan(NamedTuple):
    """An op's layout rule applied, memoised with its signature: each
    output's (dims, pending: None, new axes or a shared ``_Pending``,
    zero, local), each input's dims as read, the devices splitting the
    work, collectives of its own, the aten name where it fell back."""
    outs: tuple
    eff: tuple
    work: int
    colls: tuple
    fallback: Optional[str]


# the aten ops the port's steps dispatch, by layout rule (any other op
# falls back to gathering its inputs, counted in ``fallback_gathers``)
_VIEWS = {"view", "_unsafe_view", "alias", "detach", "permute", "transpose",
          "t", "unsqueeze", "squeeze", "expand", "select", "slice", "split",
          "unbind"}
_RESHAPES = {"view", "_unsafe_view", "_reshape_alias", "reshape"}
_LINEAR_SUM = {"add", "add_", "sub"}
_LINEAR_SCALE = {"mul", "div", "div_"}
_LINEAR_UNARY = {"neg", "_to_copy", "clone"}
_POINTWISE = {
    "add", "add_", "sub", "mul", "div", "div_", "neg", "_to_copy", "clone",
    "copy_", "exp", "cos", "sin", "silu", "silu_backward", "gelu",
    "gelu_backward", "softplus", "softplus_backward", "tanh",
    "tanh_backward", "sqrt", "rsqrt", "pow", "reciprocal", "clamp",
    "maximum", "where", "eq", "ge", "gt", "le", "lt", "bitwise_and",
    "masked_fill_", "rsub", "tril", "flip", "constant_pad_nd"}
_ALONG_DIM = {"_softmax", "_softmax_backward_data", "cumsum", "sort"}
_REDUCE_LINEAR = {"sum", "mean"}
_REDUCE = {"amax", "logsumexp"}
_FACTORIES = {"zeros", "new_zeros", "ones", "full", "arange",
              "scalar_tensor"}
_LIKE = {"zeros_like", "ones_like"}
_INDEX = {"index", "index_put", "index_put_", "gather", "scatter",
          "scatter_add", "index_select", "index_add"}


def _bound(func, args, kwargs) -> dict:
    """The op's arguments by schema name."""
    out = {}
    for i, a in enumerate(func._schema.arguments):
        if i < len(args):
            out[a.name] = args[i]
        elif a.name in kwargs:
            out[a.name] = kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _norm_dims(d, nd: int) -> list:
    if d is None:
        return list(range(nd))
    d = [d] if isinstance(d, int) else list(d)
    return [x % nd for x in d] if nd else []


class _Meter(TorchDispatchMode):
    """Counts, per dispatched op, its FLOPs (``torch.utils.flop_counter``'s
    registry) and the bytes it moves (and those on score tensors), whole
    and per device, and keeps the live bytes of storages made during the
    run (a storage's bytes leave the count when PyTorch frees it).

    With a mesh it also carries a layout per tensor (``_Spec``, the
    attribute ``_SPEC`` of the tensor): the mesh axes each dim is split
    over and the axes over which the value is a pending partial sum.
    Inputs take their shardings; each op's rule (``_plan``) gives its
    outputs' layouts, the layouts it reads its inputs at, and the devices
    that split its work; a gather (an input read at fewer axes than it
    has) is an all-gather, and a pending sum is settled — a reduce-scatter
    over the axes its destination is split over, an all-reduce over the
    rest — where a consumer, ``constrain`` (the recorder's ``pin``) or an
    output's sharding needs it whole.  It is the recorder of
    ``distributed.meshes`` for the trace."""

    def __init__(self, args, score_dims=None, mesh=None):
        super().__init__()
        self.bytes = 0
        self.score_bytes = 0
        self.flops = 0
        self.flops_pd = Fraction(0)
        self.bytes_pd = 0
        self.score_bytes_pd = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.memo: dict = {}
        self.score_dims = score_dims
        self.seen = {t.untyped_storage()._cdata for t in tree.leaves(args)}
        self.sizes = {a: n for a, n in (mesh.shape.items() if mesh else ())
                      if n > 1}
        self.order = {a: i for i, a in enumerate(self.sizes)}
        self.merged: dict = {}          # (size, axes) -> the dims merged
        self.token = object()
        self.colls = Collectives()
        self.fallbacks: dict = {}

    # -- layouts -----------------------------------------------------------

    def spec(self, t) -> _Spec:
        e = t.__dict__.get(_SPEC)
        if e is None or e[0] is not self.token:
            return _Spec(((),) * t.dim())
        s = e[1]
        if s.pend is not None and s.pend.settled:
            s = s._replace(pend=None)
        return s

    def set_spec(self, t, s: _Spec):
        t.__dict__[_SPEC] = (self.token, s)

    def dims(self, spec) -> tuple:
        """A resolved spec (``meshes.spec_for``'s entries) as dims: the
        axes of size one dropped."""
        return tuple(tuple(a for a in entry_axes(e) if a in self.sizes)
                     for e in spec)

    def dims_of(self, t) -> tuple:
        return self.spec(t).dims

    def _parts(self, dims) -> int:
        return math.prod(self.sizes[a] for d in dims for a in d)

    def _group(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def _settle(self, pend: _Pending, dest):
        """The collectives that make a pending sum whole at ``dest``."""
        if pend.settled:
            return
        pend.settled = True
        want = {a for d in dest for a in d}
        scatter = tuple(a for a in pend.axes if a in want)
        rest = tuple(a for a in pend.axes if a not in want)
        rb = pend.nbytes
        if scatter:
            g = self._group(scatter)
            self.colls.add("reduce-scatter", rb // g, g)
            rb //= g
        if rest:
            self.colls.add("all-reduce", rb, self._group(rest))

    def _gathers(self, nbytes: int, have, want) -> list:
        """The all-gather that reads a value laid out at ``have`` at
        ``want`` (axes ``want`` adds are a free slice)."""
        kept = tuple(tuple(a for a in h if a in w) for h, w in zip(have, want))
        lost = [a for h, w in zip(have, want) for a in h if a not in w]
        if not lost:
            return []
        return [("all-gather", nbytes // self._parts(kept),
                 self._group(lost))]

    def _cost(self, t, have, want) -> float:
        """Link bytes per device of reading t, laid out at ``have``, at
        ``want``."""
        return sum(_ring_traffic(*c) for c in self._gathers(_nbytes(t),
                                                            have, want))

    def _move(self, t, s: _Spec, want):
        if s.pend is not None:
            self._settle(s.pend, want)
        if not s.zero:
            for c in self._gathers(_nbytes(t), s.dims, want):
                self.colls.add(*c)

    # -- the recorder (``distributed.meshes``) -------------------------------

    def pin(self, t, spec):
        """``constrain`` / ``pin``: t moved to the resolved ``spec``."""
        want = self.dims(spec)
        self._move(t, self.spec(t), want)
        self.set_spec(t, _Spec(want))

    def exchange(self, t, want, moved, transpose=False):
        """t laid out at ``want`` by the collectives ``moved`` (or, in the
        backward, their transposes); nothing else is priced."""
        for c in moved:
            c = transposed(*c) if transpose else c
            if c is not None:
                self.colls.add(*c)
        self.set_spec(t, _Spec(tuple(want)))

    def slot_local(self, t):
        self.set_spec(t, self.spec(t)._replace(local=True))

    # -- the rules ----------------------------------------------------------

    def _reshape(self, old, dims, new):
        """Dims of a reshape: runs of old and new dims of equal product are
        matched.  A run that merges dims keeps all their axes, in order (a
        device flattens its own block), and is remembered; a run that
        splits one dim back into the dims it was merged from gives each
        its axes again; otherwise the run's axes go to its new dims from
        the first, each while it divides what is left of the dim.  Axes
        left over are lost."""
        out, lost = [()] * len(new), []
        i = j = 0
        while i < len(old) or j < len(new):
            if i < len(old) and old[i] == 1:
                i += 1
                continue
            if j < len(new) and new[j] == 1:
                j += 1
                continue
            if i >= len(old) or j >= len(new):
                break
            gi, gj, pi, pj = [i], [j], old[i], new[j]
            i, j = i + 1, j + 1
            while pi != pj:
                if pi < pj:
                    gi.append(i)
                    pi *= old[i]
                    i += 1
                else:
                    gj.append(j)
                    pj *= new[j]
                    j += 1
            axes = tuple(a for k in gi for a in dims[k])
            parts = tuple((old[k], dims[k]) for k in gi)
            if len(gi) > 1 and len(gj) == 1 and axes:
                self.merged[(new[gj[0]], axes)] = parts
            was = self.merged.get((old[gi[0]], axes)) if len(gi) == 1 \
                else None
            if was is not None and [n for n, _ in was] == [new[k]
                                                          for k in gj]:
                for k, (_, e) in zip(gj, was):
                    out[k] = e
                continue
            pos = 0
            for k in gj:
                rem, take = new[k], []
                while pos < len(axes) and rem % self.sizes[axes[pos]] == 0:
                    rem //= self.sizes[axes[pos]]
                    take.append(axes[pos])
                    pos += 1
                out[k] = tuple(take)
            lost.extend(axes[pos:])
        return tuple(out), lost

    def _view(self, name, b, x, s, outs):
        """(out dims per output, x's dims as read) of a view."""
        d = list(s.dims)
        nd = x.dim()
        if name in ("detach", "alias", "lift_fresh", "view_as"):
            return [tuple(d)], tuple(d)
        if name in ("view", "_unsafe_view", "_reshape_alias", "reshape"):
            od, lost = self._reshape(tuple(x.shape), d, tuple(outs[0].shape))
            read = tuple(tuple(a for a in e if a not in lost) for e in d)
            return [od], read
        if name == "permute":
            return [tuple(d[i % nd] for i in b["dims"])], tuple(d)
        if name == "transpose":
            i, j = b["dim0"] % nd, b["dim1"] % nd
            d[i], d[j] = d[j], d[i]
            return [tuple(d)], tuple(s.dims)
        if name == "t":
            return [tuple(reversed(d))], tuple(d)
        if name == "unsqueeze":
            d.insert(b["dim"] % (nd + 1), ())
            return [tuple(d)], tuple(s.dims)
        if name == "squeeze":
            ds = set(_norm_dims(b["dim"], nd)) if "dim" in b else \
                set(range(nd))
            return [tuple(e for i, e in enumerate(d)
                          if not (i in ds and x.shape[i] == 1))], tuple(d)
        if name == "expand":
            o = outs[0]
            off = o.dim() - nd
            kept = [d[i] if x.shape[i] == o.shape[off + i] else ()
                    for i in range(nd)]
            return [tuple([()] * off + kept)], tuple(d)
        if name in ("select", "unbind"):
            dim = b["dim"] % nd
            read = tuple(() if i == dim else e for i, e in enumerate(d))
            od = tuple(e for i, e in enumerate(read) if i != dim)
            return [od] * len(outs), read
        if name in ("slice", "split", "split_with_sizes"):
            dim = b["dim"] % nd
            parts = self._group(d[dim])
            if any(o.shape[dim] % parts for o in outs):
                d[dim] = ()
            return [tuple(d)] * len(outs), tuple(d)
        raise KeyError(name)

    def _merge(self, shape, ops):
        """Broadcast-merged dims of pointwise operands (tensor, spec): the
        first operand split on a dim gives it its axes; an axis used on
        another dim already is dropped (that operand is gathered)."""
        nd = len(shape)
        merged, used = [()] * nd, set()
        for t, s in ops:
            if s.zero:
                continue
            off = nd - t.dim()
            for i, e in enumerate(s.dims):
                if e and merged[off + i] == () and \
                        t.shape[i] == shape[off + i] and not used & set(e):
                    merged[off + i] = e
                    used.update(e)
        return merged

    @staticmethod
    def _read_at(t, merged):
        off = len(merged) - t.dim()
        return tuple(merged[off + i] if t.shape[i] != 1 or not merged[off + i]
                     else () for i in range(t.dim()))

    def _plan(self, func, args, kwargs, outs, ins, specs):
        """The op's rule (see ``_Meter``), settling pending inputs it does
        not pass on."""
        name = func.overloadpacket.__name__
        b = _bound(func, args, kwargs)
        eff = [s.dims for s in specs]
        passed: set = set()              # inputs whose pending sum passes on
        colls: list = []
        fallback = None
        o = outs[0] if outs else None
        pos = {id(t): i for i, t in reversed(list(enumerate(ins)))}

        def new(dims, pend=None, zero=False, local=False):
            return (tuple(dims), pend, zero, local)

        pend_at = [i for i, s in enumerate(specs) if s.pend is not None]

        if name in _VIEWS:
            x = ins[0]
            od, read = self._view(name, b, x, specs[0], outs)
            eff[0] = read
            s = specs[0]
            moved = read != s.dims
            if not moved:
                passed.add(0)
            res = [new(d, None if moved else s.pend, s.zero, s.local)
                   for d in od]
            work = 1
        elif name in _FACTORIES or name in _LIKE or not ins:
            zero = name in ("zeros", "new_zeros", "zeros_like")
            like = specs[0].dims if name in _LIKE and ins else None
            res = [new(like if like is not None and len(like) == t.dim()
                       else ((),) * t.dim(), zero=zero) for t in outs]
            work = self._parts(res[0][0]) if res else 1
        elif name in ("mm", "bmm"):
            res, eff, work = self._matmul(name == "bmm", ins, specs, eff,
                                          o)
        elif name in _REDUCE_LINEAR or name in _REDUCE:
            x, s = ins[0], specs[0]
            nd = x.dim()
            red = _norm_dims(b.get("dim"), nd) if "dim" in b else \
                list(range(nd))
            if not red:
                red = list(range(nd))
            keep = b.get("keepdim", False)
            axes = tuple(a for i in red for a in s.dims[i])
            od = tuple(() if i in red else e for i, e in enumerate(s.dims)
                       if keep or i not in red)
            if name in _REDUCE_LINEAR:
                if s.pend is not None:
                    passed.add(0)
                    axes = s.pend.axes + axes
                res = [new(od, axes or None)]
            else:
                res = [new(od)] * len(outs)
                if axes:
                    colls.append(("all-reduce",
                                  _nbytes(o) // self._parts(od),
                                  self._group(axes)))
            work = self._parts(s.dims)
        elif name in _INDEX and (
                planned := self._index(name, b, specs, eff, o, pos)):
            (out, pend), work = planned
            res = [new(out, pend)]
        elif name in ("cat", "stack"):
            (out, pend), eff, work, passed = self._cat(name, b, specs, o)
            res = [new(out, pend)]
        elif name in ("slice_backward", "select_backward"):
            g, s = ins[0], specs[0]
            d = list(s.dims)
            dim = b["dim"] % o.dim()
            if name == "select_backward":
                d.insert(dim, ())
            elif d[dim] and o.shape[dim] % self._group(d[dim]):
                d[dim] = ()
                eff[0] = tuple(d)
            if eff[0] == s.dims:
                passed.add(0)
            res = [new(d, s.pend if 0 in passed else None)]
            work = self._parts(d)
        elif name in _POINTWISE or name in _ALONG_DIM:
            res, eff, work, passed = self._pointwise(name, b, ins, specs, eff,
                                                     outs, pend_at)
        else:
            fallback = func.name()
            if not any(any(d) for d in eff) and not pend_at:
                fallback = None
            eff = [((),) * t.dim() for t in ins]
            res = [new(((),) * t.dim()) for t in outs]
            work = 1
        for i in pend_at:
            if i not in passed:
                self._settle(specs[i].pend, eff[i])
        for i, (t, s) in enumerate(zip(ins, specs)):
            if not s.zero and eff[i] != s.dims:
                colls.extend(self._gathers(_nbytes(t), s.dims, eff[i]))
        return _Plan(tuple(res), tuple(eff), work, tuple(colls), fallback)

    def _matmul(self, batched, ins, specs, eff, o):
        """mm / bmm.  The layout is the cheapest of a few: the batch dim's
        axes are one side's, the axes both share, or none, and so are the
        contraction's; an axis taken there leaves the sides' other dims; an
        axis on a free dim of both sides stays on the side where gathering
        it would move more.  The cost is the bytes of the gathers that read
        each side at the layout and, for a contraction split alike on both
        sides (a pending sum), of settling the sum; ties go to the first
        candidate (the sides' own batch axes, then a gather)."""
        (a, b), (sa, sb) = ins[:2], specs[:2]
        ka, kb = a.dim() - 1, b.dim() - 2
        m = range(1, ka) if batched else range(ka)
        n = range(kb + 1, b.dim())

        def common(x, y):
            return tuple(v for v in x if v in y)

        def layout(bt, k):
            used = set(bt) | set(k)
            da = [tuple(x for x in e if x not in used) for e in sa.dims]
            db = [tuple(x for x in e if x not in used) for e in sb.dims]
            if batched:
                da[0] = db[0] = bt
            da[ka], db[kb] = k, k
            clash = {x for i in m for x in da[i]} & \
                {x for i in n for x in db[i]}
            for x in sorted(clash, key=self.order.get):
                drop_a = [tuple(y for y in e if y != x) if i in m else e
                          for i, e in enumerate(da)]
                drop_b = [tuple(y for y in e if y != x) if i in n else e
                          for i, e in enumerate(db)]
                if self._cost(a, da, drop_a) < self._cost(b, db, drop_b):
                    da = drop_a
                else:
                    db = drop_b
            cost = self._cost(a, sa.dims, da) + self._cost(b, sb.dims, db)
            if k:
                g = self._group(k)
                outer = {x for i in m for x in da[i]} | \
                    {x for i in n for x in db[i]} | set(bt)
                cost += 2 * (_nbytes(o) // self._group(outer)) * (g - 1) / g
            return cost, k, da, db

        batches = [()]
        if batched:
            ea, eb = sa.dims[0], sb.dims[0]
            batches = list(dict.fromkeys((ea or eb, eb or ea,
                                          common(ea, eb), ())))
        best = None
        for bt in batches:
            ea, eb = (tuple(x for x in e if x not in bt)
                      for e in (sa.dims[ka], sb.dims[kb]))
            ks = [ea] if ea == eb else list(dict.fromkeys(
                ((), ea, eb, common(ea, eb))))
            for k in ks:
                cand = layout(bt, k)
                if best is None or cand[0] < best[0]:
                    best = cand + (bt,)
        _, k, da, db, bt = best
        eff = [tuple(da), tuple(db)] + list(eff[2:])
        od = ((bt,) if batched else ()) + tuple(da[i] for i in m) \
            + tuple(db[i] for i in n)
        return [(od, k or None, False, False)], eff, \
            self._parts(od) * self._group(k)

    def _pointwise(self, name, b, ins, specs, eff, outs, pend_at):
        o = outs[0]
        passed: set = set()
        if pend_at:
            lin = self._linear(name, b, ins, specs, o, pend_at)
            if lin is not None:
                dims, pend, passed = lin
                res = [(dims, pend, False, False)] * len(outs)
                return res, [s.dims for s in specs], self._parts(dims), \
                    passed
        merged = self._merge(tuple(o.shape), list(zip(ins, specs)))
        # dims an op reads whole (a padded dim changes size, so no input's
        # layout carries to it)
        whole = [b["dim"]] if name in _ALONG_DIM else \
            b["dims"] if name == "flip" else []
        for dim in whole:
            merged[dim % o.dim()] = ()
        if name == "copy_":
            merged = list(specs[0].dims)
            passed.add(0)                   # overwritten: nothing to settle
        eff = [self._read_at(t, merged) for t in ins]
        res = [(tuple(merged), None, False, False)] * len(outs)
        return res, eff, self._parts(merged), passed

    def _linear(self, name, b, ins, specs, o, pend_at):
        """Layout of a linear op on pending sums, or None: sums and
        differences of sums (and zeros) pending over the same axes at the
        same dims are a new sum; a sum scaled by a scalar, negated, cast
        or copied shares its pending sum."""
        full = [i for i in pend_at if tuple(ins[i].shape) == tuple(o.shape)]
        if name in _LINEAR_SUM:
            if len(full) != len(pend_at) or \
                    not isinstance(b.get("other"), torch.Tensor):
                return None
            others = [i for i in range(len(ins)) if i not in pend_at]
            if any(not specs[i].zero for i in others):
                return None
            ps = [specs[i] for i in pend_at]
            if len({(s.dims, s.pend.axes) for s in ps}) != 1:
                return None
            if len(ps) == 1:
                return ps[0].dims, ps[0].pend, set(pend_at)
            return ps[0].dims, ps[0].pend.axes, set(pend_at)
        if name in _LINEAR_SCALE:
            if len(pend_at) != 1 or len(full) != 1:
                return None
            if name.startswith("div") and pend_at[0] != 0:
                return None
            if any(ins[i].dim() for i in range(len(ins)) if i != pend_at[0]):
                return None
            s = specs[pend_at[0]]
            return s.dims, s.pend, set(pend_at)
        if name in _LINEAR_UNARY and len(ins) == 1:
            return specs[0].dims, specs[0].pend, {0}
        return None

    def _index(self, name, b, specs, eff, o, pos):
        """Indexing by tensors, or None where an index is missing (the
        generic fallback).  An index split alike on the indexed tensor's
        dim (or slot-local) reads or writes each device's own rows; an
        indexed dim split over axes the index is not is a masked lookup
        whose result is pending over them; writes accumulated from an
        index split over axes the destination is not are pending over
        them."""
        def sp(t):
            return specs[pos[id(t)]]

        def read(t, dims):
            eff[pos[id(t)]] = tuple(dims)

        def axes_of(ts, ndims=None):
            return {a for t in ts for dd in sp(t).dims[:ndims] for a in dd}

        if name in ("index", "index_put", "index_put_"):
            x, idx = b["self"], list(b["indices"])
            if not idx or any(t is None for t in idx):
                return None
            k, d = len(idx), sp(x).dims
            e = axes_of(idx)
            if name == "index":
                lead = self._merge(tuple(o.shape[:o.dim() - x.dim() + k]),
                                   [(t, sp(t)) for t in idx])
                masked = tuple(a for dd in d[:k] for a in dd if a not in e)
                taken = {a for dd in lead for a in dd}
                rest = tuple(tuple(a for a in dd if a not in taken)
                             for dd in d[k:])
                read(x, d[:k] + rest)
                for t in idx:
                    read(t, self._read_at(t, lead))
                od = tuple(lead) + rest
                return (od, masked or None), self._parts(od) \
                    * self._group(masked)
            v = b["values"]
            e |= axes_of([v], v.dim() - (x.dim() - k))
            have = {a for dd in d for a in dd}
            pend = ()
            if b["accumulate"]:
                pend = tuple(a for a in e if a not in have)
            else:
                for t in idx + [v]:
                    read(t, (tuple(a for a in dd if a in have)
                             for dd in sp(t).dims))
            return (d, pend or None), self._parts(d) * self._group(pend)
        dim = b["dim"] % o.dim()
        x, idx = b["self"], b["index"]
        sx, si = sp(x), sp(idx)
        if name == "gather":
            masked = tuple(a for a in sx.dims[dim] if a not in si.dims[dim])
            merged = [si.dims[i] or (sx.dims[i] if i != dim else ())
                      for i in range(o.dim())]
            read(x, (sx.dims[dim] if i == dim else merged[i]
                     for i in range(x.dim())))
            read(idx, merged)
            return (merged, masked or None), self._parts(merged) \
                * self._group(masked)
        e = si.dims[0] if name in ("index_select", "index_add") else ()
        if name == "index_select":
            dx = list(sx.dims)
            if {a for i, dd in enumerate(dx) if i != dim for a in dd} & set(e):
                e = ()
                read(idx, ((),))
            # a slot-local index reads the rows of its own axes; rows split
            # over other axes are a masked lookup, summed over them
            dx[dim] = tuple(a for a in dx[dim] if si.local or a not in e)
            masked = tuple(a for a in dx[dim] if a not in e)
            read(x, dx)
            od = tuple(e if i == dim else dd for i, dd in enumerate(dx))
            return (od, masked or None), self._parts(od) \
                * self._group(masked)
        # scatter, scatter_add, index_add: src rows written at the index's
        src = b["src"] if "src" in b else b["source"]
        ops = [(t, sp(t)) for t in (x, idx, src)]
        merged = self._merge(tuple(o.shape), [
            (t, s._replace(dims=tuple(() if i == dim else dd
                                      for i, dd in enumerate(s.dims))))
            for t, s in ops])
        others = {a for i, dd in enumerate(merged) if i != dim for a in dd}
        pend = ()
        if si.local:
            merged[dim] = e
        else:
            merged[dim] = () if sx.zero or set(sx.dims[dim]) & others \
                else sx.dims[dim]
            if name == "index_add":
                pend = tuple(a for a in e if a not in others
                             and a not in merged[dim])
        for t, s in ops:
            read(t, (merged[i] if t.shape[i] == o.shape[i] or i == dim
                     and s.dims[i] == merged[i] else ()
                     for i in range(t.dim())) if t is not idx
                 or name != "index_add" else (e,))
        return (merged, pend or None), self._parts(merged) \
            * self._group(pend)

    def _cat(self, name, b, specs, o):
        ts = list(b["tensors"])
        ss = specs[:len(ts)]
        dim = b["dim"] % o.dim()
        if name == "cat":
            # the cat dim's layout is kept where every input has it
            merged = self._merge(tuple(o.shape[:dim]) + (1,)
                                 + tuple(o.shape[dim + 1:]), [
                (t, s._replace(dims=tuple(() if i == dim else dd
                                          for i, dd in enumerate(s.dims))))
                for t, s in zip(ts, ss)])
            cat_dims = {s.dims[dim] for s in ss if not s.zero}
            merged[dim] = cat_dims.pop() if len(cat_dims) == 1 else ()
            read = od = tuple(merged)
        else:
            read = tuple(self._merge(tuple(ts[0].shape), list(zip(ts, ss))))
            od = read[:dim] + ((),) + read[dim:]
        pends = [s for s in ss if s.pend is not None]
        passed: set = set()
        pend = None
        if pends and all(s.pend is not None or s.zero for s in ss) and \
                len({(s.dims, s.pend.axes) for s in pends}) == 1 and \
                pends[0].dims == read:
            pend = pends[0].pend.axes
            passed = {i for i, s in enumerate(ss) if s.pend is not None}
        return (od, pend), [read] * len(ts), self._parts(od), passed

    # -- bookkeeping ------------------------------------------------------------

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
        specs: list = []

        def layout_key(t):
            s = self.spec(t)
            specs.append(s)
            return s.dims, s.pend is not None, s.zero, s.local

        key = (func, _sig(args, ins, layout_key), tuple(kwargs),
               _sig(tuple(kwargs.values()), ins, layout_key))
        keep = not any(s.pend is not None for s in specs) and \
            func.overloadpacket.__name__ not in _RESHAPES
        hit = self.memo.get(key) if keep else None
        if hit is not None:
            lay, moves, plan, flops, nb, nb_pd, score = hit
            out = _fabricate(lay) if lay is not None else \
                func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            outs = _outputs(out)
            in_storages = {t.untyped_storage()._cdata for t in ins}
            fresh = all(t.untyped_storage()._cdata not in in_storages
                        for t in outs)
            mutates = func._schema.is_mutable
            moves = (fresh or mutates) and \
                not func.name().startswith("aten::empty")
            plan = self._plan(func, args, kwargs, outs, ins, specs)
            count = flop_registry.get(func.overloadpacket)
            flops = count(*args, **kwargs, out_val=out) if count else 0
            nb = nb_pd = 0
            score = False
            if moves:
                nb = sum(_nbytes(t) for t in ins) + \
                    sum(_nbytes(t) for t in outs)
                nb_pd = sum(_nbytes(t) // self._parts(e)
                            for t, e in zip(ins, plan.eff)) + \
                    sum(_nbytes(t) // self._parts(r[0])
                        for t, r in zip(outs, plan.outs))
                score = bool(self.score_dims) and any(
                    self._is_score(t) for t in ins + outs)
            if keep:
                lay = _layout(out) if fresh and not mutates else None
                self.memo[key] = (lay, moves, plan, flops, nb, nb_pd, score)
        self.ops += 1
        outs = _outputs(out)
        for t in outs:
            self._track(t)
        for t, (dims, pend, zero, local) in zip(outs, plan.outs):
            if isinstance(pend, tuple):
                pend = _Pending(tuple(sorted(pend, key=self.order.get)),
                                _nbytes(t) // self._parts(dims))
            self.set_spec(t, _Spec(dims, pend, zero, local))
        for c in plan.colls:
            self.colls.add(*c)
        if plan.fallback:
            self.fallbacks[plan.fallback] = \
                self.fallbacks.get(plan.fallback, 0) + 1
        if flops:
            self.flops += flops
            self.flops_pd += Fraction(flops, plan.work)
        self.bytes += nb
        self.bytes_pd += nb_pd
        if score:
            self.score_bytes += nb
            self.score_bytes_pd += nb_pd
        return out

    def resolve(self, values, shardings):
        """Each output leaf moved to its sharding (``out_shardings``)."""
        for t, s in sharded_leaves(values, shardings):
            self._move(t, self.spec(t), self.dims(s.spec))


def trace(fn, args, score_dims=None, mesh=None, in_shardings=None,
          out_shardings=None) -> tuple:
    """Run ``fn(*args)`` on meta tensors under the meter: (outputs,
    counts).  ``counts`` holds the whole run's FLOPs, bytes moved and
    score bytes, each also per device, the peak of live bytes beyond the
    arguments, the collectives, the ops that fell back to gathers, ops and
    seconds.  With a mesh, the arguments start at ``in_shardings`` (whole
    where None) and the outputs end at ``out_shardings``."""
    if score_dims is not None and score_dims[0] == score_dims[1]:
        score_dims = None               # the reference's is_score rule
    meter = _Meter(args, score_dims, mesh)
    if in_shardings is not None:
        for t, s in sharded_leaves(args, in_shardings):
            meter.set_spec(t, _Spec(meter.dims(s.spec)))
    t0 = time.perf_counter()
    with meshes.recording(meter), meter:
        out = fn(*args)
    if out_shardings is not None:
        meter.resolve(out, out_shardings)
    seconds = time.perf_counter() - t0
    return out, {"flops": meter.flops, "bytes": meter.bytes,
                 "score_bytes": meter.score_bytes,
                 "flops_pd": float(meter.flops_pd),
                 "bytes_pd": meter.bytes_pd,
                 "score_bytes_pd": meter.score_bytes_pd,
                 "collectives": meter.colls.records(),
                 "collective_traffic": meter.colls.traffic,
                 "num_collectives": meter.colls.count,
                 "fallback_gathers": dict(sorted(meter.fallbacks.items())),
                 "peak_beyond_args": meter.peak, "ops": meter.ops,
                 "seconds": seconds}


def roofline(chips: int, counts: dict) -> dict:
    """The reference's ``Roofline.as_dict`` keys on the H100's constants,
    from ``trace``'s counts: per device as the resolved specs split each
    op, the whole trace's counts beside them."""
    f, b = counts["flops_pd"], counts["bytes_pd"]
    s = counts["score_bytes_pd"]
    traffic = counts["collective_traffic"]
    terms = {"compute": f / PEAK_FLOPS, "memory": b / HBM_BW,
             "collective": traffic / LINK_BW}
    return {
        "chips": chips,
        "flops_per_device": f,
        "hbm_bytes_per_device": b,
        "flops_total": counts["flops"],
        "hbm_bytes_total": counts["bytes"],
        "collective_traffic_per_device": traffic,
        "num_collectives": counts["num_collectives"],
        "t_compute": terms["compute"],
        "t_memory": terms["memory"],
        "t_collective": terms["collective"],
        "dominant": max(terms, key=terms.get),
        "t_memory_kernelized": max(b - s, 0.0) / HBM_BW,
        "score_bytes_per_device": s,
        "collective_summary": counts["collectives"][:SUMMARY_TOP],
        "fallback_gathers": counts["fallback_gathers"],
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
        out, counts = trace(fn, args, score_dims, mesh, in_sh, out_sh)
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
        **roofline(chips, counts),
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
