"""Parameter spec trees: shapes + logical axes + initializers.

A layer is described by a dict of ``P`` specs; ``init_tree`` materialises
parameters as tensors, ``axes_tree`` extracts the logical-axes tree.  A
tree is nested dicts and lists with ``P`` leaves, as in the reference
package.  The reference's ``abstract_tree`` (``jax.ShapeDtypeStruct``
stand-ins for allocation-free lowering) has no counterpart here.

The initialisers are the reference's (normal with std 1/√fan_in or
``scale``, zeros, ones, mamba2's ``a_log`` and ``dt_bias``), drawn from a
``torch.Generator``; the numbers differ from ``jax.random``'s, so tests
carry the reference's weights across (``interop.params_from_numpy``).
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
        x = torch.randn(shape, generator=gen, device=device)
        return (x * std).to(dtype)
    raise ValueError(spec.init)


def init_tree(specs, gen: torch.Generator, dtype, device):
    """Parameters for every spec, drawn in leaf order from ``gen`` (a
    generator on ``device``)."""
    return tree_map(lambda s: _init_leaf(s, gen, dtype, device), specs)


def axes_tree(specs):
    return tree_map(lambda s: s.axes, specs)


def stacked(specs, n: int):
    """Add a leading (n,)-'layers' axis to every spec (for scan segments)."""
    return tree_map(
        lambda s: P((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in leaves(specs))
