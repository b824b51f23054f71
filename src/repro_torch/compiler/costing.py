"""Costing: score candidate plan fragments with the APCT model and pick
winners under cross-pattern computation reuse.

Node costs reuse the existing DwarvesGraph model (``cost_model``): every
elimination step of a hom contraction costs the approximate count of the
subpattern processed so far (APCT query) plus a dense-tile floor.  The
``shared`` memo implements the paper's joint-search semantics: a node
already scheduled by an earlier pattern costs nothing again, so the
greedy selection naturally prefers candidates that reuse the pool —
exactly why the paper searches the joint space (§4.3).

Candidates whose contraction would materialise an intermediate beyond the
``PlanTooWide`` threshold get infinite cost, so the compiler avoids
emitting a plan the executor must refuse whenever a finite-cost
candidate exists; if *no* candidate is executable the direct plan is
kept (uncommitted, total cost inf) and the executor's ``PlanTooWide``
triggers the caller's fallback.

Two extensions of the shared pool:

* ``CutJoin`` with |cut| <= 3 is costed as the fused CUDA kernel tiers
  (``kernels.ops.cutjoin_reduce`` / ``cutjoin_reduce3``): per-tile
  streaming with the injectivity mask computed in-kernel, so it never
  pays (or gates on) an O(n^|cut|) mask materialisation — only wider
  cuts keep the dense-mask gate.  The tri tier's budget story gates on
  what it *does* materialise: Σ per-factor tensor elements (axis-subset
  factors at their own size) against the plan budget, refusing (inf)
  formulations whose 3-D factors would not fit and thereby preferring
  pair-tensor-only 3-cut joins on large graphs.
* when a ``CountingEngine`` is threaded in (``counter=``), hom scalars
  and free-hom tensors it has already materialised cost zero: its
  ``(pattern, free)``-keyed ``hom_free_memo`` (and canonical-pattern
  ``hom_memo``) extend the shared pool across cut choices *and* across
  compiles that reuse the engine (MiningEngine, the serving batcher), so
  costing prefers decompositions whose cut tensors already exist.

Labelled contractions are priced with label selectivity: the APCT only
profiles unlabelled skeletons (paper footnote 6), so the count-bound
term of a label-masked contraction is the skeleton estimate scaled by
the product of the pattern vertices' label frequencies (independence
assumption) — label masks shrink the effective match count, not the
dense-tile floor, which still streams full-N tiles.  ``label_fracs``
(label -> vertex fraction of the bound graph) is threaded from
``compile``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.core import cost_model as CM
from repro_torch.core import homomorphism as H
from repro_torch.core.decomposition import candidates as cut_candidates
from repro_torch.core.pattern import Pattern, clique
from repro_torch.compiler.frontend import Candidate
from repro_torch.compiler.ir import Contract, CutJoin, Intersect, LocalCount, \
    MobiusCombine, ShrinkageCorrect, free_skeleton

DENSE_TILE = CM.DENSE_TILE

# how much cheaper one streamed kernel-tier tile is than one dense f64
# gather-einsum tile: the CutJoin tiers run chunked f32 broadcast
# multiplies, while Contract floors model f64 einsum contractions —
# without the discount a tri join prices like a fourth contraction.
# The value is the reference package's: plan selection must stay
# identical between the two packages
KERNEL_STREAM_DISCOUNT = 4.0


def tile_floor(n: int, width: int, tile: int = DENSE_TILE) -> float:
    """Dense-tile streaming floor of one ``width``-dim pass over an
    ``n``-extent grid, in tile units.

    For n >= tile this is the historical ``(n / tile) ** width``.  Below
    one tile the historical formula collapsed to a flat 1.0 for every
    width and every candidate — the ROADMAP "sharp edge": at n <= 128
    all floors tied, so plan selection between candidates was decided
    by count terms alone and tests at small n never exercised the floor
    side of the model.  Instead the leading axis now scales with the
    *actual* tile extent ``min(n, tile)`` the kernels stream (they clamp
    their block to n and pad to it — see ``kernels/matreduce``), so the
    floor stays proportional to n and two candidates with different
    factor counts price differently at any n.  Width <= 0 (scalar
    outputs) floors at 1.0 — reading a result is never free."""
    if width <= 0:
        return 1.0
    return (max(n, 1) / tile) * (max(n, tile) / tile) ** (width - 1)


def _label_selectivity(labels, label_fracs) -> float:
    """Fraction of vertex tuples surviving the label mask: Π over the
    (sub)pattern's vertices of their label's vertex frequency."""
    if labels is None or not label_fracs:
        return 1.0
    s = 1.0
    for l in labels:
        s *= label_fracs.get(l, 0.0)
    return s


def _contract_cost(node: Contract, apct, n_vertices: int,
                   budget: int, label_fracs=None,
                   devices: int = 1) -> float:
    # decode free-hom marker labels back to the real-labelled skeleton;
    # the APCT itself understands only unlabelled skeletons (it strips
    # labels on query), so labelled count bounds are the skeleton
    # estimate scaled by label selectivity
    q = free_skeleton(node.pattern) if node.free else node.pattern
    steps = H.frontier_sizes(q, node.order, free=node.free)
    # execution-faithful per-step widths: free axes count only once a
    # factor actually carries them (the engine's einsum never unions
    # untouched output axes into an intermediate), so anchored
    # flat-Möbius candidates on large graphs price by what they
    # materialise, not by a free-axes-everywhere upper bound.  The
    # memory gate tests the step's *output* width (what ``_contract``
    # holds / chunks); the dense floor charges the *compute* width
    # (output ∪ the eliminated vertex — the volume the einsum streams)
    widths = H.elimination_widths(q, node.order, free=node.free)
    # devices > 1 prices the collective route (distributed/contract):
    # each elimination step splits its eliminated-vertex extent across
    # the mesh, so step work divides by d, plus a log2(d) surcharge per
    # step for the tree-reduce behind its closing psum — mirroring
    # _kernel_join_cost so contract vs join selection stays coherent,
    # and a 1-device mesh prices identically to no mesh.
    d = max(int(devices), 1)
    total = 0.0
    done = set(node.free)
    for (v, front), (_, width) in zip(steps, widths):
        if n_vertices ** width > 4 * budget:
            return math.inf                  # PlanTooWide at execution
        done |= front
        sub = q.induced(sorted(done))
        cnt = (apct.query(sub) if sub.is_connected()
               else CM._disc(apct, q, done))
        cnt *= _label_selectivity(sub.labels, label_fracs)
        total += (cnt + tile_floor(n_vertices, width + 1)) / d
        if d > 1:
            total += math.log2(d)
    # free output tensor materialisation (sharded on cut axis 0)
    total += tile_floor(n_vertices, len(node.free)) / d
    return total


def _materialised(node: Contract, counter) -> bool:
    """True when the engine already holds this contraction's value: the
    hom scalar (canonical pattern) or the free-hom tensor under the
    engine's ``(skeleton pattern, free)`` memo key — exactly the key
    lowering evaluates with, so zero cost here is zero work there."""
    if counter is None:
        return False
    if node.free:
        return counter.has_free_tensor(free_skeleton(node.pattern),
                                       node.free)
    return counter.has_hom(node.pattern)


def _kernel_join_cost(cut_size: int, factor_axes, n_vertices: int,
                      budget: int, devices: int = 1):
    """Shared kernel-tier join pricing for CutJoin and LocalCount — the
    two must stay in lockstep for scalar-count vs keep-axis plan
    selection to be meaningful.  Returns inf when a |cut| >= 3 join's
    Σ factor elements (axis-subset factors at their own size) exceed
    the pool headroom; otherwise one pass over the tile grid plus
    per-factor read traffic at each factor's own width, at streamed-f32
    rates.

    ``devices > 1`` prices the sharded tier (``distributed/cutjoin``):
    the grid and the axis-0 factor traffic divide across the mesh
    (per-device APCT), plus a log2(d) collective surcharge for the
    tree-reduce behind the closing ``psum``/all-gather — so the model
    prefers sharded execution exactly where per-device savings beat the
    collective, and a 1-device mesh prices identically to no mesh."""
    if cut_size >= 3:
        factor_elems = sum(n_vertices ** len(ax) for ax in factor_axes)
        if factor_elems > 4 * budget:
            return math.inf
    tiles = tile_floor(n_vertices, cut_size)
    traffic = sum(tile_floor(n_vertices, len(ax)) for ax in factor_axes)
    d = max(int(devices), 1)
    cost = (tiles + traffic) / d / KERNEL_STREAM_DISCOUNT
    if d > 1:
        cost += math.log2(d)
    return cost


def node_cost(node, apct, n_vertices: int, budget: int = 1 << 27,
              counter=None, label_fracs=None, devices: int = 1,
              held=None) -> float:
    if isinstance(node, Contract):
        if _materialised(node, counter):
            return 0.0
        # the morph count store already holds this scalar hom: lowering
        # serves it without contracting (route "morph-derive"), so the
        # model prices it like a materialised engine memo
        if held and not node.free and node.key in held:
            return 0.0
        return _contract_cost(node, apct, n_vertices, budget, label_fracs,
                              devices)
    if isinstance(node, Intersect):
        if held and node.key in held:
            return 0.0
        # ordered enumeration: linear scan + one unit per (approximate)
        # clique tuple
        return apct.query(clique(node.k)) + n_vertices
    if isinstance(node, CutJoin):
        # |cut| <= 3 runs the fused kernel tiers: tiles stream through
        # registers with the injectivity mask computed in-kernel, so only
        # wider cuts gate on materialising the dense mask.  The tri tier
        # instead gates on its *factor* tensors — the only thing it
        # materialises: Σ factor elements (each n^|axes|, axis-subset
        # factors at their own size) must fit the plan budget, so a
        # pair-tensor-only 3-cut join stays eligible on graphs where a
        # 3-D-factor formulation prices infinite and the selection falls
        # back to |cut| <= 2 candidates or the dense Möbius route.
        if node.cut_size > 3:
            # dense-mask join beyond the kernel tiers (single-device:
            # the sharded tier stops at |cut| = 3, see lowering)
            if n_vertices ** node.cut_size > 4 * budget:
                return math.inf
            tiles = tile_floor(n_vertices, node.cut_size)
            return tiles * max(len(node.factors), 1)
        return _kernel_join_cost(node.cut_size, node.factor_axes(),
                                 n_vertices, budget, devices)
    if isinstance(node, ShrinkageCorrect):
        return float(len(node.corrections) + 1)
    if isinstance(node, LocalCount):
        # the partial-embedding join: the factor-product streaming cost
        # matches CutJoin's kernel tier (|cut| <= 3 by construction), but
        # the output is a tensor over the kept axes, not a scalar — a
        # reduce-free join (keep == all axes) pays its materialisation,
        # which is what steers anchored queries to keep-axis plans when
        # both exist.  Corrections add one streamed tensor each.  3-cut
        # local plans gate on their factor tensors like the tri-join
        # (full-cut factors, so anchored 3-cut vectors only commit where
        # three n³ factors genuinely fit the budget).
        out_elems = n_vertices ** len(node.keep)
        if out_elems > 4 * budget:
            return math.inf                  # output itself too wide
        join = _kernel_join_cost(node.cut_size, node.factor_axes(),
                                 n_vertices, budget, devices)
        out = tile_floor(n_vertices, len(node.keep))
        return join + out + float(len(node.corrections))
    if isinstance(node, MobiusCombine):
        return float(len(node.terms))
    raise TypeError(type(node))


def candidate_cost(cand: Candidate, apct, n_vertices: int,
                   shared: Dict[str, float], budget: int = 1 << 27,
                   counter=None, label_fracs=None,
                   devices: int = 1, held=None) -> float:
    """Cost of one candidate given already-scheduled nodes (cost 0)."""
    total = 0.0
    for node in cand.nodes:
        if node.key in shared:
            continue
        total += node_cost(node, apct, n_vertices, budget, counter,
                           label_fracs, devices, held)
        if total == math.inf:
            return math.inf
    return total


def commit(cand: Candidate, apct, n_vertices: int,
           shared: Dict[str, float], budget: int = 1 << 27, counter=None,
           label_fracs=None, devices: int = 1, held=None):
    for node in cand.nodes:
        if node.key not in shared:
            shared[node.key] = node_cost(node, apct, n_vertices, budget,
                                         counter, label_fracs, devices,
                                         held)


def select_candidates(per_pattern: List[Tuple[Pattern, List[Candidate]]],
                      apct, n_vertices: int,
                      budget: int = 1 << 27, counter=None,
                      label_fracs=None, node_costs: Dict[str, float] = None,
                      devices: int = 1, held=None):
    """Greedy joint selection over the application: for each pattern pick
    the cheapest candidate under the current shared pool, then commit its
    nodes.  Returns ([(pattern, winner)], total_cost).

    ``counter`` extends the pool with contractions the engine has already
    materialised (see ``_materialised``); ``label_fracs`` prices label
    masks (see ``_label_selectivity``).  ``node_costs`` (optional dict)
    receives the per-node APCT cost of every committed node — the
    *predicted* side of the observability layer's drift report, stored
    on the plan so traced executions can pair each node's prediction
    with its measured time.  ``devices`` is the execution mesh's shard
    count (1 without a mesh): joins price per-device plus a collective
    term (``_kernel_join_cost``), so selection sees the mesh.  ``held``
    (set of ``hom:`` node keys the morph count store already holds for
    this graph) prices those contractions at 0 — the morph-candidate
    costing hook: a direct plan whose homs the store holds beats a
    decomposition exactly when the algebra makes it free."""
    shared: Dict[str, float] = {}
    out = []
    total = 0.0
    for p, cands in per_pattern:
        best, bc = None, math.inf
        for cand in cands:
            c = candidate_cost(cand, apct, n_vertices, shared, budget,
                               counter, label_fracs, devices, held)
            if c < bc:
                best, bc = cand, c
        if best is None:
            # every candidate materialises a too-wide intermediate: keep
            # the direct plan so the output exists, but do NOT commit its
            # nodes (they must not look free to later patterns) — the
            # executor will raise PlanTooWide and callers fall back
            out.append((p, cands[0]))
            total = math.inf
            continue
        commit(best, apct, n_vertices, shared, budget, counter,
               label_fracs, devices, held)
        out.append((p, best))
        total += bc
    if node_costs is not None:
        node_costs.update(shared)
    return out, total


def choose_cut(p: Pattern, apct, n_vertices: int):
    """Cost-model-optimal cutting set for one pattern (None = direct
    fallback) — the compiler-side home of ``MiningEngine.choose_cut``."""
    best, bc = None, math.inf
    for cand in cut_candidates(p):
        c = CM.pattern_cost(p, cand, apct, n_vertices)
        if c < bc:
            best, bc = cand, c
    return best
