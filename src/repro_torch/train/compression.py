"""Gradient compression for cross-pod all-reduces.

The reference package's ``repro.train.compression``, on tensors.  Two
standard schemes, both with error feedback (the residual from this step is
added to the next step's gradient, so compression error does not
accumulate in expectation):

  * int8 block quantisation: per-block absmax scales, 4x over f32 (2x over
    bf16) wire bytes;
  * top-k sparsification: keep the k largest-magnitude entries per tensor.

``torch.round`` rounds half to even, as ``jnp.round`` does, so int8 blocks
equal the reference's.  ``torch.topk`` and ``lax.top_k`` may break ties
between equal magnitudes differently.  Trees of gradients are the
reference's (``train.tree``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.train import tree


class Int8Blocks(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # f32 per-block scales
    shape: tuple


def quantize_int8(x, block: int = 256):
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Int8Blocks(q, scale[:, 0], tuple(x.shape))


def dequantize_int8(c: Int8Blocks):
    blocks = c.q.to(torch.float32) * c.scale[:, None]
    flat = blocks.reshape(-1)
    n = math.prod(c.shape) if c.shape else 1
    return flat[:n].reshape(c.shape)


def topk_sparsify(x, frac: float = 0.01):
    flat = x.reshape(-1).to(torch.float32)
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    kept = flat[idx]
    out = torch.zeros_like(flat).index_put((idx,), kept)
    return out.reshape(x.shape), idx, kept


def compress_with_feedback(grads, residuals, scheme: str = "int8",
                           block: int = 256, frac: float = 0.01):
    """Returns (compressed-approx grads, new residuals)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        if scheme == "int8":
            approx = dequantize_int8(quantize_int8(gf, block))
        elif scheme == "topk":
            approx, _, _ = topk_sparsify(gf, frac)
        else:
            raise ValueError(scheme)
        return approx.to(g.dtype), gf - approx

    flat, structure = tree.flatten(grads)
    pairs = [one(g, r) for g, r in zip(flat, tree.leaves(residuals))]
    return (tree.unflatten(structure, [a for a, _ in pairs]),
            tree.unflatten(structure, [r for _, r in pairs]))


def init_residuals(grads):
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def wire_bytes(x, scheme: str = "int8", block: int = 256,
               frac: float = 0.01) -> int:
    n = x.numel()
    if scheme == "int8":
        return n + 4 * ((n + block - 1) // block)
    if scheme == "topk":
        k = max(1, int(n * frac))
        return 8 * k
    return 4 * n
