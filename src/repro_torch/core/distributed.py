"""Distributed, fault-tolerant pattern counting.

  * the dense adjacency is split into row blocks over the slots of a 1-D
    ``("data",)`` mesh (``shard_adjacency``), and every hom contraction is
    a sliced bucket elimination over them (``distributed.contract``);
  * the count is a sum over blocks of the first eliminated vertex's image:
    each block is an independent work unit, so partial sums are
    checkpointable (resume after preemption) and blocks are issued
    block-cyclically (straggler mitigation: no worker owns a contiguous
    hot range of a skewed degree distribution).

The checkpoint is the reference package's file: a JSON object
``{"<block>": partial}`` written with ``json.dumps``, so either package
resumes from the other's.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import homomorphism as H
from repro_torch.core.pattern import Pattern
from repro_torch.core.quotient import quotient_terms
from repro_torch.distributed import contract as C
from repro_torch.distributed import meshes


def shard_adjacency(A, mesh) -> C.Sliced:
    """Row blocks of the dense (n, n) adjacency ``A`` (numpy or a tensor)
    over the mesh's slots, zero-padded to the slot multiple."""
    A = torch.as_tensor(A, dtype=torch.float64)
    n, d = A.shape[0], meshes.num_shards(mesh)
    Rp = C.padded_rows(n, mesh)
    rows = Rp // d
    parts = []
    for dev, (start, stop) in zip(mesh.devices, meshes.slot_ranges(n, d)):
        block = torch.zeros((rows, Rp), dtype=torch.float64, device=dev)
        block[:stop - start, :n] = A[start:stop].to(dev)
        parts.append(block)
    return C.Sliced(tuple(parts), rows, n)


def _hom(p: Pattern, A, mesh, order, unary_mask, budget) -> float:
    """hom(p) over a ``Sliced`` adjacency (with its mesh) or a dense
    tensor; ``unary_mask`` (an (n,) numpy vector or None) weights the last
    eliminated vertex's image."""
    order = order or H.greedy_plan(p)
    if isinstance(A, C.Sliced):
        unary = None
        if unary_mask is not None:
            pad = np.zeros(C.padded_rows(A.n, mesh))
            pad[:A.n] = unary_mask
            unary = {order[-1]: torch.from_numpy(pad).to(mesh.home)}
        return C.sharded_hom(p, A, mesh=mesh, n=A.n, order=order,
                             unary=unary, budget=budget).item()
    unary = None if unary_mask is None else \
        {order[-1]: torch.from_numpy(unary_mask).to(A.dtype).to(A.device)}
    return H.hom_count(p, A, order=order, unary=unary,
                       budget=budget).item()


def sharded_hom_count(p: Pattern, A, mesh, order=None,
                      budget: int = 1 << 27) -> float:
    """hom(p) with ``A`` the adjacency's row blocks over ``mesh`` (from
    ``shard_adjacency``), or a dense tensor on one device."""
    return _hom(p, A, mesh, order, None, budget)


def blockwise_hom_count(p: Pattern, A, mesh, num_blocks: int = 8,
                        order=None, checkpoint: Optional[str] = None,
                        budget: int = 1 << 27,
                        fail_at_block: Optional[int] = None) -> float:
    """hom(p) = Σ_b hom(p | x_{v0} ∈ block b): resumable accumulation.

    ``checkpoint``: JSON path storing {block: partial}; completed blocks
    are skipped on restart.  ``fail_at_block`` injects a failure for the
    fault-tolerance tests.
    """
    n = A.n if isinstance(A, C.Sliced) else A.shape[0]
    order = order or H.greedy_plan(p)    # eliminate last => outermost loop
    done = {}
    ckpt = pathlib.Path(checkpoint) if checkpoint else None
    if ckpt and ckpt.exists():
        done = {int(k): v for k, v in json.loads(ckpt.read_text()).items()}

    for b in range(num_blocks):
        if b in done:
            continue
        if fail_at_block is not None and b == fail_at_block:
            raise RuntimeError(f"injected failure at block {b}")
        mask = np.zeros(n, np.float64)
        mask[np.arange(b, n, num_blocks)] = 1.0      # block-cyclic rows
        done[b] = _hom(p, A, mesh, order, mask, budget)
        if ckpt:
            ckpt.write_text(json.dumps(done))
    return sum(done.values())


def sharded_inj(p: Pattern, A, mesh, budget: int = 1 << 27) -> float:
    total = 0.0
    for coeff, q in quotient_terms(p):
        total += coeff * sharded_hom_count(q, A, mesh, budget=budget)
    return total
