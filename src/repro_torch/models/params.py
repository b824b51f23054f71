"""Parameter spec trees: shapes + logical axes + initializers.

A layer is described by a dict of ``P`` specs; ``init_tree`` materialises
parameters as tensors, ``axes_tree`` extracts the logical-axes tree,
``abstract_tree`` gives tensors on ``torch.device("meta")`` (shape and
dtype, no storage: the counterpart of the reference's
``jax.ShapeDtypeStruct`` stand-ins, for the allocation-free dry run).  A
tree is nested dicts and lists with ``P`` leaves, as in the reference
package.

The initialisers are the reference's (normal with std 1/√fan_in or
``scale``, zeros, ones, mamba2's ``a_log`` and ``dt_bias``), drawn from a
``torch.Generator``; the numbers differ from ``jax.random``'s, so tests
carry the reference's weights across (``interop.params_from_numpy``).
A "normal" leaf of more than ``SLICED_DRAW_ELEMENTS`` (2^30) elements is
drawn in f32 slice by slice along its leading axis into a tensor of the
target dtype; a leaf at or under 2^30 elements is drawn whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class P(NamedTuple):
    shape: tuple
    axes: tuple                     # logical axis names, len == len(shape)
    init: str = "normal"            # normal | zeros | ones | a_log | dt_bias
    scale: Optional[float] = None   # stddev override for "normal"


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree):
    """``fn`` on every ``P`` leaf of a tree of dicts and lists."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in order: specs, axis
    tuples, tensors, whatever is neither a dict nor a list."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


# A "normal" leaf of more elements than this is drawn in slices straight
# into a tensor of its dtype (``_normal_into``): drawn whole, dbrx-132b's
# stacked expert leaves at 8 layers (8.46 G elements each) would take
# 34 GB of f32 per draw and as much again scaled.  Leaves at or under it
# are drawn whole, as they always were, so their bits under a seed stay.
SLICED_DRAW_ELEMENTS = 2 ** 30


def _init_leaf(spec: P, gen: torch.Generator, dtype, device):
    shape = tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "a_log":        # mamba2 A_log: log U(1, 16)
        u = torch.empty(shape, device=device).uniform_(1.0, 16.0,
                                                       generator=gen)
        return torch.log(u).to(dtype)
    if spec.init == "dt_bias":      # softplus^-1 of U(1e-3, 1e-1)
        u = torch.empty(shape, device=device).uniform_(1e-3, 1e-1,
                                                       generator=gen)
        return torch.log(torch.expm1(u)).to(dtype)
    if spec.init == "normal":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        if math.prod(shape) > SLICED_DRAW_ELEMENTS:
            out = torch.empty(shape, dtype=dtype, device=device)
            _normal_into(out, std, gen)
            return out
        x = torch.randn(shape, generator=gen, device=device)
        return (x * std).to(dtype)
    raise ValueError(spec.init)


def _normal_into(out, std: float, gen: torch.Generator):
    """Fill ``out`` with N(0, std²) drawn in f32, in runs of whole
    leading-axis slices of at most ``SLICED_DRAW_ELEMENTS`` elements
    (a slice larger than that alone is filled the same way, one axis
    down), so the f32 transient is one run's, not the leaf's."""
    if out.numel() <= SLICED_DRAW_ELEMENTS:
        out.copy_(torch.randn(out.shape, generator=gen,
                              device=out.device).mul_(std))
        return
    rows = SLICED_DRAW_ELEMENTS // math.prod(out.shape[1:])
    if rows == 0:                   # one slice is too large: go down an axis
        for i in range(out.shape[0]):
            _normal_into(out[i], std, gen)
        return
    for i in range(0, out.shape[0], rows):
        _normal_into(out[i:i + rows], std, gen)


def init_tree(specs, gen: torch.Generator, dtype, device):
    """Parameters for every spec, drawn in leaf order from ``gen`` (a
    generator on ``device``)."""
    return tree_map(lambda s: _init_leaf(s, gen, dtype, device), specs)


def axes_tree(specs):
    return tree_map(lambda s: s.axes, specs)


def abstract_tree(specs, dtype):
    """A meta tensor of ``dtype`` for every spec: no storage is made."""
    return tree_map(lambda s: torch.empty(tuple(s.shape), dtype=dtype,
                                          device="meta"), specs)


def stacked(specs, n: int):
    """Add a leading (n,)-'layers' axis to every spec (for scan segments)."""
    return tree_map(
        lambda s: P((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in leaves(specs))
