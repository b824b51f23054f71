"""Public wrappers for the join, triangle, SDDMM, bitset and attention
kernels: defaults, route counters, guard, placement.

Counter names and labels (``kernel.calls``, ``kernel.exact_block``) are
the reference package's, so route counters compare one-to-one.
``sddmm`` and ``common_neighbors`` take tensors or numpy arrays: a
tensor's device decides where they run, numpy input goes to
``device.resolve(device)`` — the CUDA device unless the caller names the
CPU.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch.kernels import bitset as _bitset
from repro_torch.kernels import flashattn as _fa
from repro_torch.kernels import matreduce as _mr
from repro_torch.kernels import sddmm as _sd

# The largest chunk the guard grants.  ``block`` is only a loop bound in
# the kernels, so one cap serves the card and the CPU alike, and it is
# the cap ``analysis.verify.precertify`` certifies against.
MAX_BLOCK = 1024


def cutjoin_reduce(factors, *, distinct=True, block=None,
                   offsets=None) -> float:
    """The decomposition join Σ_{e_c} Π_i M_i(e_c) as a fused kernel.

    ``factors`` is a sequence of equal-shape cut tensors: (n,) vectors for
    |cut| = 1 (``distinct`` is moot — one vertex is always injective) or
    (m, n) matrices for |cut| = 2, where ``distinct`` applies the
    off-diagonal injectivity mask in-kernel from the cell's indices.
    ``block`` bounds the cells one f32 partial accumulates; take it from
    ``cutjoin_exact_block`` so integer counts stay exact.  ``offsets``
    gives the factors' global start index per cut axis when the caller
    holds only a slice.
    """
    if block is None:
        block = MAX_BLOCK
    obs.counter("kernel.calls", op="cutjoin_reduce",
                cut=2 if getattr(factors[0], "ndim", 2) == 2 else 1)
    return _mr.prod_reduce(factors, distinct=distinct, block=block,
                           offsets=offsets)


def cutjoin_reduce_f64(factors) -> float:
    """The |cut| = 1 join Σ_x Π_i M_i(x) through the f64 instance of the
    vector kernel: f64 products and sums, exact while n · Π_i max|M_i| <=
    2^53 (``cutjoin_exact_f64``) — for the joins the f32 guard refuses."""
    obs.counter("kernel.calls", op="cutjoin_reduce_f64", cut=1)
    return _mr.prod_reduce(factors, f64=True)


def cutjoin_reduce3(factors, axes, *, n, distinct=True, block=None,
                    offsets=None) -> float:
    """The |cut| = 3 decomposition join Σ_{e_c pairwise distinct} Π_i
    M_i(e_c) as a fused kernel.

    ``factors[i]`` spans only the cut axes ``axes[i]`` (a sorted subset
    of (0, 1, 2)): (n,) vectors, (n, n) pair tensors, or full (n, n, n)
    tensors.  Axis-subset factors are read through stride-0 axes inside
    the kernel — they are never expanded to 3-D — and the pairwise-
    distinct mask is an index compare, so nothing O(n³) is materialised
    beyond whatever genuinely 3-D factors the caller already holds.
    """
    if block is None:
        block = MAX_BLOCK
    obs.counter("kernel.calls", op="cutjoin_reduce3", cut=3)
    return _mr.tri_reduce(factors, axes, n=n, distinct=distinct,
                          block=block, offsets=offsets)


def cutjoin_reduce_keep(factors, *, keep=0, distinct=True, block=None,
                        offsets=None):
    """Keep-axis decomposition join: out[x] = Σ_{y≠x} Π_i M_i(x, y) over
    (m, n) cut tensors — the anchored partial-embedding vector of a
    |cut| = 2 plan (``keep`` picks which cut axis survives), as an f64
    vector on the factors' device.  Same masking and chunked f32/f64
    exactness story as ``cutjoin_reduce``; ``cutjoin_exact_block``
    certifies the same chunk size for both."""
    if block is None:
        block = MAX_BLOCK
    obs.counter("kernel.calls", op="cutjoin_reduce_keep", cut=2)
    return _mr.prod_reduce_keep(factors, keep=keep, distinct=distinct,
                                block=block, offsets=offsets)


def cutjoin_reduce_keep_f64(factors, *, keep=0, distinct=True,
                            offsets=None):
    """Keep-axis |cut| = 2 join through the f64 instance of the keep
    kernel: f64 products and sums, exact while (reduced length) · Π_i
    max|M_i| <= 2^53 (``cutjoin_exact_f64``) — for the anchored reads the
    f32 guard refuses."""
    obs.counter("kernel.calls", op="cutjoin_reduce_keep_f64", cut=2)
    return _mr.prod_reduce_keep(factors, keep=keep, distinct=distinct,
                                offsets=offsets, f64=True)


def cutjoin_reduce3_keep(factors, axes, *, keep, n, distinct=True,
                         block=None, offsets=None):
    """Keep-axis |cut| = 3 join: out[w] = Σ over the two non-kept cut
    axes (pairwise-distinct triples only) of Π_i M_i — the anchored
    partial-embedding vector of a 3-cut plan.  Same axis-subset reads,
    in-kernel mask and chunked f32/f64 exactness story as
    ``cutjoin_reduce3``."""
    if block is None:
        block = MAX_BLOCK
    obs.counter("kernel.calls", op="cutjoin_reduce3_keep", cut=3)
    return _mr.tri_reduce_keep(factors, axes, keep=keep, n=n,
                               distinct=distinct, block=block,
                               offsets=offsets)


def masked_matmul_reduce(lhs, rhs, mask) -> float:
    """Σ mask ⊙ (lhs @ rhsᵀ) with the product tile never written out:
    lhs (M, K), rhs (N, K), mask (M, N), f32 product, f64 sum."""
    return _mr.matreduce(lhs, rhs, mask)


def triangle_count(adj) -> float:
    """Σ A ⊙ (A @ A) / 6 for a symmetric 0/1 adjacency: the number of
    triangles, exact while every vertex degree stays below 2^24."""
    a = torch.as_tensor(adj, dtype=torch.float32)
    return masked_matmul_reduce(a, a, a) / 6.0


def runtime_block(block: int) -> int:
    """Clamp a statically certified ``exact_block`` chunk to the cap
    ``cutjoin_exact_block`` applies.  A smaller chunk is always at least
    as exact, so clamping preserves the guarantee."""
    return min(int(block), MAX_BLOCK)


def cutjoin_exact_block(factors, *, maxes=None):
    """Chunk size for which ``cutjoin_reduce`` / ``cutjoin_reduce3`` is
    exact on the given integer-valued factors, or None when no f32
    chunking can guarantee it (callers should use an f64 path).
    ``maxes`` passes cached per-factor max magnitudes so plans skip the
    factor scan (see ``matreduce.exact_block``)."""
    block = _mr.exact_block(factors, max_block=MAX_BLOCK, maxes=maxes)
    obs.counter("kernel.exact_block",
                outcome="granted" if block is not None else "refused")
    return block


def cutjoin_exact_f64(maxes, cells: int) -> bool:
    """Whether the f64 instances (``cutjoin_reduce_f64``,
    ``cutjoin_reduce_keep_f64``) are exact for factors with these max
    magnitudes over ``cells`` reduced cells (see ``matreduce.exact_f64``);
    counted in ``kernel.exact_f64``."""
    ok = _mr.exact_f64(maxes, cells)
    obs.counter("kernel.exact_f64", outcome="granted" if ok else "refused")
    return ok


def _device_of(args, device) -> torch.device:
    """The device of the tensors among ``args``, else
    ``device.resolve(device)`` for numpy input."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"operands lie on different devices: {devs}")
    return devs.pop() if devs else _device.resolve(device)


def _placed(args, device):
    """Tensors for ``args`` on one device (``_device_of``)."""
    dev = _device_of(args, device)
    return [torch.as_tensor(a).to(dev) for a in args]


def sddmm(lhs, rhs, mask, *, device=None) -> torch.Tensor:
    """mask ⊙ (lhs @ rhsᵀ) as an f32 (M, N) tensor: lhs (M, K), rhs
    (N, K) in f32 or bf16, mask (M, N).  No padding: ragged shapes go to
    the kernel as they are."""
    return _sd.sddmm(*_placed((lhs, rhs, mask), device))


def common_neighbors(adj_bool, edges, *, device=None) -> torch.Tensor:
    """Per-edge common-neighbour counts, (E,) int32: the adjacency packed
    into 32-bit words, then one popcount(row u & row v) per edge, the two
    rows gathered inside the kernel.  Σ over a graph's edges is 3 · T.
    On the card the adjacency is packed there (``bitset_pack``), and pairs
    on the host (``Graph.edges``) are checked with numpy and uploaded
    without blocking: the call makes no host sync."""
    dev = _device_of((adj_bool, edges), device)
    adj = _bitset.upload(adj_bool, dev)
    return _bitset.bitset_intersect_edges(_bitset.pack_bitsets(adj), edges)


def flash_attention(q, k, v, *, causal=True, bq=128, bk=128) -> torch.Tensor:
    """(B, S, H, D) attention through K9 (``kernels.flashattn``).  The
    reference's tile sizes keep its assertion that they divide the
    sequences; the kernel tiles by its own 64 rows, and the plain version
    on a CPU tensor scans KV blocks of ``bk`` rows."""
    Sq, Skv = q.shape[1], k.shape[1]
    bq, bk = min(bq, Sq), min(bk, Skv)
    assert Sq % bq == 0 and Skv % bk == 0
    return _fa.flash_attention(q, k, v, causal=causal, block=bk)
