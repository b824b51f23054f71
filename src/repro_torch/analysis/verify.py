"""Static verification of plan IR: structural checks, abstract shape
interpretation, and `exact_block` precertification.

Nothing in the serving path validates a plan between ``Plan.from_dict``'s
version check and execution — a corrupted cache entry, a frontend bug,
or a hand-edited plan is only caught (if at all) when the runtime oracle
disagrees.  ``verify`` closes that gap with two passes that never touch
the graph data:

**Structural pass.**  Every node is a known IR op whose dict key matches
its own ``key``, every ``refs()`` target resolves, the DAG is acyclic,
every output points at a real node, and everything unreachable from an
output (or a ``dom:`` domain vector) is flagged.

**Abstract interpretation.**  Each node's tensor rank (and, given the
graph size, its concrete shape/dtype) is inferred from the IR alone:
Contract free-axis arity, CutJoin/LocalCount axis-subset annotations,
Möbius/shrinkage scalar algebra.  On top of the shapes it checks the
tier matrix (``lowering._eval`` implements exactly: keep-axis reduces
for one surviving axis at |cut| <= 3, dense product otherwise), the
LABEL_STRIDE marker encoding of free-hom patterns (must decode under
``free_skeleton``), factor-element totals against the plan budget, and
— the serving-path win — a conservative degree-bound on factor
magnitudes that *precertifies* the kernel tier's ``exact_block`` guard:
a precertified join provably never refuses the f32-chunk kernel, so
execution skips the device→host factor scan entirely.  Joins whose
factors provably always blow the exactness limit are flagged at verify
time instead of silently falling back on every query.

``morph_check`` validates a committed morph identity
(``compiler.morph.MorphCandidate``) on the pattern-lattice endpoints,
graph-free.  ``shard_check`` flags plan / mesh pairings that waste the
mesh (``shard-small-graph``, ``shard-indivisible``,
``shard-budget-overflow``, Contract nodes included).

Diagnostics carry stable ``code`` strings (one per failure class) so
tests and callers can assert *which* invariant broke, not just that one
did.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.ir import (Contract, CutJoin, Intersect, LocalCount,
                               MobiusCombine, Plan, ShrinkageCorrect,
                               is_local_output)
from repro_torch.core import homomorphism as _H
from repro_torch.core.pattern import LABEL_STRIDE, free_skeleton
from repro_torch.kernels.matreduce import EXACT_LIMIT
from repro_torch.kernels import matreduce as _mr

_NODE_CLASSES = (Contract, Intersect, MobiusCombine, CutJoin,
                 ShrinkageCorrect, LocalCount)

# mirrors ``matreduce.exact_block``'s floor: a join whose factor-
# magnitude *lower* bound already blows EXACT_LIMIT at the smallest
# chunk can never take the kernel route
MIN_BLOCK = 8


# -- results ---------------------------------------------------------------------

@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.  ``code`` is the stable failure class,
    ``node`` the offending node key (or output name), ``severity`` is
    "error" (plan must not execute) or "warning" (advisory)."""
    code: str
    node: str
    message: str
    severity: str = "error"

    def __str__(self):
        return f"{self.severity}[{self.code}] {self.node}: {self.message}"


@dataclass
class VerifyResult:
    diagnostics: List[Diagnostic] = field(default_factory=list)
    # node key -> statically certified exact_block chunk size: joins in
    # here provably never refuse the f32 kernel on the verified graph
    precert: Dict[str, int] = field(default_factory=dict)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def raise_if_failed(self):
        if not self.ok:
            raise PlanVerifyError(self.errors)
        return self

    def __str__(self):
        if not self.diagnostics:
            return "plan verifies clean"
        return "\n".join(str(d) for d in self.diagnostics)


class PlanVerifyError(ValueError):
    """A plan failed static verification.  ValueError subclass so the
    cache's clean-miss handler treats it like any other bad entry."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super().__init__("; ".join(str(d) for d in self.diagnostics))


@dataclass(frozen=True)
class GraphInfo:
    """The few graph statistics static analysis needs — carried in plan
    meta so cached plans can re-verify and precertify without the graph
    they were compiled against."""
    n: int
    max_degree: int
    min_degree: int = 0

    @classmethod
    def from_graph(cls, graph) -> "GraphInfo":
        import numpy as np
        deg = np.asarray(graph.degrees)
        if deg.size == 0:
            return cls(int(graph.n), 0, 0)
        return cls(int(graph.n), int(deg.max()), int(deg.min()))

    def to_dict(self) -> dict:
        return {"n": self.n, "max_degree": self.max_degree,
                "min_degree": self.min_degree}

    @classmethod
    def from_dict(cls, d: dict) -> "GraphInfo":
        return cls(int(d["n"]), int(d["max_degree"]),
                   int(d.get("min_degree", 0)))


# -- entry point -----------------------------------------------------------------

def verify(plan: Plan, *, graph_info: Optional[GraphInfo] = None,
           budget: Optional[int] = None,
           precertify_joins: bool = True) -> VerifyResult:
    """Statically verify one plan.  ``graph_info``/``budget`` default to
    the values recorded in ``plan.meta`` (compiles since the analysis
    layer landed record both); without them the budget and
    precertification passes are skipped — structure and shapes are still
    fully checked."""
    if graph_info is None and isinstance(plan.meta.get("graph_info"), dict):
        try:
            graph_info = GraphInfo.from_dict(plan.meta["graph_info"])
        except (KeyError, TypeError, ValueError):
            graph_info = None
    if budget is None:
        b = plan.meta.get("budget")
        budget = int(b) if isinstance(b, (int, float)) else None

    res = VerifyResult()
    _structural(plan, res.diagnostics)
    if res.errors:
        # shape inference assumes resolvable, acyclic refs
        return res
    ndims: Dict[str, int] = {}
    for key in plan.nodes:
        _ndim_of(key, plan, ndims)
    for key, node in plan.nodes.items():
        _check_node(key, node, plan, ndims, res.diagnostics)
    _check_outputs(plan, ndims, res.diagnostics)
    if graph_info is not None and budget is not None:
        _check_budget(plan, graph_info, budget, res.diagnostics)
    if graph_info is not None and precertify_joins and not res.errors:
        res.precert = precertify(plan, graph_info)
        res.diagnostics.extend(refusal_flags(plan, graph_info))
    return res


def infer_shapes(plan: Plan, n: int) -> Dict[str, tuple]:
    """Abstract value of every node without executing: key ->
    (shape, dtype-name).  Scalars are shape (); every tensor axis ranges
    over graph vertices, and all node values combine on the host in f64
    (the kernel tier's f32 chunks are internal)."""
    ndims: Dict[str, int] = {}
    for key in plan.nodes:
        _ndim_of(key, plan, ndims)
    return {key: ((n,) * nd, "float64") for key, nd in ndims.items()}


# -- pass 1: structure -----------------------------------------------------------

def _err(code, node, msg):
    return Diagnostic(code, node, msg)


def _warn(code, node, msg):
    return Diagnostic(code, node, msg, severity="warning")


def _structural(plan: Plan, diags: List[Diagnostic]):
    nodes = plan.nodes
    valid = {}
    for key, node in nodes.items():
        if not isinstance(node, _NODE_CLASSES):
            diags.append(_err("unknown-node-class", key,
                              f"{type(node).__name__} is not a plan IR op"))
            continue
        valid[key] = node
        if node.key != key:
            diags.append(_err("key-mismatch", key,
                              f"node carries key {node.key!r}"))
        for r in node.refs():
            if r not in nodes:
                diags.append(_err("dangling-ref", key,
                                  f"references missing node {r!r}"))

    # cycle detection: iterative 3-colour DFS over resolvable refs
    WHITE, GREY, BLACK = 0, 1, 2
    colour = {k: WHITE for k in valid}
    for start in valid:
        if colour[start] != WHITE:
            continue
        stack = [(start, iter([r for r in valid[start].refs()
                               if r in valid]))]
        colour[start] = GREY
        while stack:
            key, it = stack[-1]
            advanced = False
            for r in it:
                if colour.get(r, BLACK) == GREY:
                    diags.append(_err(
                        "cycle", key, f"ref cycle through {r!r}"))
                elif colour.get(r) == WHITE:
                    colour[r] = GREY
                    stack.append((r, iter([x for x in valid[r].refs()
                                           if x in valid])))
                    advanced = True
                    break
            if not advanced:
                colour[key] = BLACK
                stack.pop()

    # outputs resolve; everything else must be reachable from an output
    # or a domain vector ("dom:" nodes are looked up by key, not via
    # Plan.outputs — see ir.domain_keys)
    roots = set()
    for name, target in plan.outputs.items():
        if target not in nodes:
            diags.append(_err("output-missing", name,
                              f"output points at missing node {target!r}"))
        else:
            roots.add(target)
    roots.update(k for k in valid if k.startswith("dom:"))
    reached = set()
    frontier = [r for r in roots if r in valid]
    while frontier:
        key = frontier.pop()
        if key in reached:
            continue
        reached.add(key)
        frontier.extend(r for r in valid[key].refs()
                        if r in valid and r not in reached)
    for key in valid:
        if key not in reached:
            diags.append(_warn("orphan-node", key,
                               "unreachable from any output"))


# -- pass 2: abstract interpretation ---------------------------------------------

def _ndim_of(key: str, plan: Plan, memo: Dict[str, int]) -> int:
    """Tensor rank of one node's value (0 = host scalar).  Pass 1
    guarantees refs resolve and the DAG is acyclic, so the recursion
    terminates."""
    if key in memo:
        return memo[key]
    node = plan.nodes[key]
    if isinstance(node, Contract):
        nd = len(node.free)
    elif isinstance(node, (Intersect, CutJoin, ShrinkageCorrect)):
        nd = 0
    elif isinstance(node, MobiusCombine):
        nd = _ndim_of(node.terms[0][1], plan, memo) if node.terms else 0
    else:                                   # LocalCount
        nd = len(node.keep)
    memo[key] = nd
    return nd


def _check_node(key, node, plan, ndims, diags):
    if isinstance(node, Contract):
        _check_contract(key, node, diags)
    elif isinstance(node, Intersect):
        if node.k < 3:
            diags.append(_err("bad-intersect", key,
                              f"clique enumeration needs k >= 3, got "
                              f"{node.k}"))
    elif isinstance(node, MobiusCombine):
        _check_divisor(key, node.divisor, diags)
        _check_terms(key, node.terms, None, plan, ndims, diags)
        arities = {ndims[r] for _, r in node.terms}
        if len(arities) > 1:
            diags.append(_err("shape-mismatch", key,
                              f"Möbius terms mix tensor ranks {sorted(arities)}"))
    elif isinstance(node, CutJoin):
        _check_join(key, node, plan, ndims, diags)
    elif isinstance(node, ShrinkageCorrect):
        _check_divisor(key, node.divisor, diags)
        base = plan.nodes[node.base]
        if not isinstance(base, (CutJoin, MobiusCombine)) or \
                ndims[node.base] != 0:
            diags.append(_err("bad-shrinkage-base", key,
                              f"base {node.base!r} is a "
                              f"{type(base).__name__} of rank "
                              f"{ndims[node.base]}, not a scalar join"))
        _check_terms(key, node.corrections, 0, plan, ndims, diags)
    elif isinstance(node, LocalCount):
        _check_join(key, node, plan, ndims, diags)
        _check_keep(key, node, diags)
        _check_terms(key, node.corrections, len(node.keep), plan, ndims,
                     diags)


def _check_contract(key, node, diags):
    p = node.pattern
    if any(not (0 <= v < p.n) for v in node.free) or \
            len(set(node.free)) != len(node.free):
        diags.append(_err("bad-free", key,
                          f"free vertices {node.free} invalid for an "
                          f"{p.n}-vertex pattern"))
        return
    bound = set(range(p.n)) - set(node.free)
    # order () is legal (lowering falls back to the greedy elimination
    # order).  A non-empty order eliminates the bound vertices; free
    # vertices may trail as output axes (``greedy_plan`` appends them),
    # so both the bound-only and the full-permutation spelling pass —
    # but every bound vertex must appear exactly once, before any free
    if node.order:
        nb = len(bound)
        head, tail = node.order[:nb], node.order[nb:]
        if sorted(head) != sorted(bound) or \
                (tail and sorted(tail) != sorted(node.free)):
            diags.append(_err("bad-order", key,
                              f"order {node.order} does not eliminate "
                              f"the bound vertices {sorted(bound)} "
                              f"(free {node.free} may only trail)"))
    if node.free:
        _check_marker_labels(key, node, diags)


def _check_marker_labels(key, node, diags):
    """Free-hom Contract patterns carry LABEL_STRIDE-packed labels: the
    cut-rank marker (free vertex of rank r gets marker r+1, bound
    vertices 0), optionally offset by the real vertex label.  The
    executor decodes with ``free_skeleton``, which keys off
    max(label) >= LABEL_STRIDE — so a mixed encoding, a missing marker,
    or a marker clash decodes to the wrong pattern silently."""
    p = node.pattern
    if p.labels is None:
        diags.append(_err("bad-label-encoding", key,
                          "free-hom pattern has no marker labels"))
        return
    labelled = [l >= LABEL_STRIDE for l in p.labels]
    if any(labelled) and not all(labelled):
        diags.append(_err("bad-label-encoding", key,
                          f"labels {p.labels} mix the labelled "
                          f"(>= {LABEL_STRIDE}) and unlabelled regimes — "
                          f"free_skeleton cannot decode them"))
        return
    markers = [l % LABEL_STRIDE if all(labelled) else l for l in p.labels]
    want = [0] * p.n
    for rank, v in enumerate(node.free):
        want[v] = rank + 1
    if markers != want:
        diags.append(_err("bad-label-encoding", key,
                          f"markers {markers} do not pin free vertices "
                          f"{node.free} (expected {want})"))


def _check_divisor(key, divisor, diags):
    if not isinstance(divisor, (int, float)) or divisor < 1 or \
            divisor != int(divisor):
        diags.append(_err("bad-divisor", key,
                          f"divisor {divisor!r} must be a positive "
                          f"integer (an automorphism-group order)"))


def _check_terms(key, terms, want_ndim, plan, ndims, diags):
    for coeff, ref in terms:
        if not isinstance(coeff, (int, float)) or not math.isfinite(coeff):
            diags.append(_err("bad-coefficient", key,
                              f"non-finite coefficient {coeff!r} on "
                              f"{ref!r}"))
        if want_ndim is not None and ndims[ref] != want_ndim:
            diags.append(_err("shape-mismatch", key,
                              f"term {ref!r} has rank {ndims[ref]}, "
                              f"expected {want_ndim}"))


def _check_join(key, node, plan, ndims, diags):
    """CutJoin / LocalCount factor structure: cut size sane, per-factor
    axis subsets well-formed and jointly covering the cut, factor
    tensors ranked to their subsets, subset factors only where the
    executor broadcasts them (the |cut| >= 3 tier)."""
    k = node.cut_size
    if not isinstance(k, int) or k < 1:
        diags.append(_err("bad-cut-size", key,
                          f"cut_size {k!r} must be a positive integer"))
        return
    if not node.factors:
        diags.append(_err("empty-join", key, "join has no factors"))
        return
    if node.axes is not None and len(node.axes) != len(node.factors):
        diags.append(_err("axes-arity", key,
                          f"{len(node.axes)} axis subsets for "
                          f"{len(node.factors)} factors"))
        return
    covered = set()
    for i, (terms, ax) in enumerate(zip(node.factors, node.factor_axes())):
        if not terms:
            diags.append(_err("empty-join", key, f"factor {i} has no terms"))
            continue
        if not ax or list(ax) != sorted(set(ax)) or \
                any(not (0 <= a < k) for a in ax):
            diags.append(_err("axis-out-of-range", key,
                              f"factor {i} axes {ax} not a sorted subset "
                              f"of cut ranks 0..{k - 1}"))
            continue
        if len(ax) < k and k < 3:
            # the legacy |cut| <= 2 kernels take equal-shape factors
            # only; axis-subset broadcasting is the |cut| >= 3 tier
            diags.append(_err("illegal-subset-axes", key,
                              f"factor {i} spans axes {ax} but the "
                              f"|cut| = {k} tier has no axis-subset "
                              f"broadcasting"))
        covered.update(ax)
        _check_terms(key, terms, len(ax), plan, ndims, diags)
    missing = set(range(k)) - covered
    if missing:
        diags.append(_err("cut-uncovered", key,
                          f"no factor spans cut rank(s) {sorted(missing)} "
                          f"— the join would sum a free axis unmasked"))


def _check_keep(key, node, diags):
    k = node.cut_size
    if not isinstance(k, int) or k < 1:
        return                               # bad-cut-size already flagged
    keep = node.keep
    if not keep or list(keep) != sorted(set(keep)) or \
            any(not (0 <= a < k) for a in keep):
        diags.append(_err("keep-outside-cut", key,
                          f"keep {keep} is not a non-empty sorted subset "
                          f"of cut ranks 0..{k - 1}"))
        return
    if 1 < len(keep) < k:
        diags.append(_err("illegal-keep", key,
                          f"keep {keep}: the executor reduces to a single "
                          f"surviving axis or none — partial multi-axis "
                          f"keeps have no route"))
    elif len(keep) < k and k > 3:
        diags.append(_err("illegal-route", key,
                          f"keep-axis reduce at |cut| = {k} has no "
                          f"implementation (kernel and dense tiers stop at "
                          f"|cut| = 3)"))


def _check_outputs(plan, ndims, diags):
    for name, target in plan.outputs.items():
        nd = ndims[target]
        node = plan.nodes[target]
        if is_local_output(name):
            want_vec = name.startswith("loca:")
            if nd == 0 or (want_vec and nd != 1):
                diags.append(_err("output-shape", name,
                                  f"local output needs a "
                                  f"{'vector' if want_vec else 'tensor'}, "
                                  f"node {target!r} has rank {nd}"))
            else:
                # anchored vectors may come off the keep-axis join OR
                # the flat Möbius fallback (anchored_direct_candidate's
                # ``locd:`` node); unanchored tensors only off the join
                legal = (LocalCount, MobiusCombine) if want_vec \
                    else (LocalCount,)
                if not isinstance(node, legal):
                    diags.append(_err("output-shape", name,
                                      f"local output served by a "
                                      f"{type(node).__name__}"))
        elif nd != 0:
            diags.append(_err("output-shape", name,
                              f"count output needs a scalar, node "
                              f"{target!r} has rank {nd}"))


# -- budget ----------------------------------------------------------------------

def _join_elements(node, n: int) -> int:
    return sum(n ** len(ax) for ax in node.factor_axes())


def _check_budget(plan, info, budget, diags):
    """Factor-element totals vs the plan budget, mirroring what costing
    admits: |cut| >= 3 joins are priced by their summed factor sizes and
    refused past 4x budget (``costing._kernel_join_cost``), and the
    dense fallback hard-fails there too (``lowering._dense_expand``).  A
    committed CutJoin over the line is a plan that could never have been
    selected — an error.  LocalCount outputs can be legitimately
    over-budget: the frontend keeps an *uncommitted* local fallback when
    no priced candidate fits, so those only warn."""
    cap = 4 * budget
    n = info.n
    for key, node in plan.nodes.items():
        if not isinstance(node, (CutJoin, LocalCount)):
            continue
        if not isinstance(node.cut_size, int) or node.cut_size < 3:
            continue
        elems = _join_elements(node, n)
        if elems <= cap:
            continue
        msg = (f"factor tensors total {elems:.3e} elements, over 4x the "
               f"plan budget ({cap:.3e})")
        if isinstance(node, CutJoin):
            diags.append(_err("budget-overflow", key, msg))
        else:
            diags.append(_warn("budget-overflow", key,
                               msg + " (uncommitted local fallback)"))


# -- exact_block precertification ------------------------------------------------

def _hom_free_bound(pattern, free, info: GraphInfo) -> float:
    """Worst-case upper bound on any entry of hom_free(pattern, free):
    grow the pattern from the pinned free set; a vertex adjacent to an
    already-placed one has at most max_degree images, an unreachable one
    at most n.  Sound for any graph with those statistics — entries
    count homomorphisms extending the pinned assignment, and every
    extension is built by such a placement sequence."""
    skel = free_skeleton(pattern)
    adj = skel.adj()
    placed = set(free)
    remaining = set(range(skel.n)) - placed
    bound = 1.0
    while remaining:
        attached = [v for v in sorted(remaining) if adj[v] & placed]
        if attached:
            v = attached[0]
            bound *= max(1, info.max_degree)
        else:
            v = min(remaining)
            bound *= max(1, info.n)
        placed.add(v)
        remaining.remove(v)
    return bound


def _factor_bound(plan, terms, info: GraphInfo) -> Optional[float]:
    """Upper bound on max|M| for one Möbius factor M = Σ coeff · hom —
    the triangle inequality over per-term hom bounds.  None when a term
    is not a free-hom Contract (no static bound available)."""
    total = 0.0
    for coeff, ref in terms:
        node = plan.nodes.get(ref)
        if not isinstance(node, Contract) or not node.free:
            return None
        total += abs(coeff) * _hom_free_bound(node.pattern, node.free, info)
    return total


def _guarded_nodes(plan):
    """(key, node) of every join the kernel tier guards with
    ``exact_block`` at execution time: scalar CutJoins at |cut| <= 3 and
    single-surviving-axis LocalCounts at |cut| in {2, 3} (everything
    else takes a dense route with no guard)."""
    for key, node in plan.nodes.items():
        if isinstance(node, CutJoin):
            if isinstance(node.cut_size, int) and 1 <= node.cut_size <= 3:
                yield key, node
        elif isinstance(node, LocalCount):
            if isinstance(node.cut_size, int) and \
                    node.cut_size in (2, 3) and len(node.keep) == 1:
                yield key, node


def precertify(plan: Plan, info: GraphInfo, *, max_block: int = 1024,
               num_shards: int = 1) -> Dict[str, int]:
    """Statically certify ``exact_block`` for every guarded join whose
    factor magnitudes are boundable: node key -> chunk size for which
    the f32-chunk kernel is provably exact on *any* graph matching
    ``info``.  Execution trusts the certificate instead of scanning
    factor tensors device→host per query (see
    ``lowering.CompiledPlan._guard_block``).  The bound is conservative
    (degree-product worst case), so a certificate is always sound; its
    absence just means the runtime scan decides.

    ``num_shards`` extends the certificate to the block-sharded tier
    (``distributed/cutjoin``): each shard's chunks accumulate products
    of *slices* of the same factors, and a slice's max magnitude never
    exceeds the global max the bound dominates — so the single-device
    certificate certifies every per-shard block as-is, for any shard
    count.  The parameter exists so callers state the mesh they verify
    against (and so a future tier with shard-dependent chunking has a
    seam); it cannot change the result, by the argument above."""
    assert num_shards >= 1, num_shards
    out: Dict[str, int] = {}
    for key, node in _guarded_nodes(plan):
        bounds = [_factor_bound(plan, terms, info) for terms in node.factors]
        if any(b is None for b in bounds):
            continue
        block = _mr.exact_block((), max_block=max_block, maxes=bounds)
        if block is not None:
            out[key] = int(block)
    return out


def shard_check(plan: Plan, info: GraphInfo, num_shards: int, *,
                budget: Optional[int] = None) -> VerifyResult:
    """Shard-legality of one plan on a ``num_shards``-way data mesh —
    advisory diagnostics layered over ``verify`` (run that first for
    structure/shapes):

    ``shard-small-graph``      n < shards: the executor falls back to
                               single-device wholesale
                               (``lowering._mesh_shards``) — a mesh that
                               size buys nothing on this graph.
    ``shard-indivisible``      cut axis 0 does not divide evenly: legal
                               (the last slot holds fewer rows and the
                               sharded contraction zero-pads to the
                               slot multiple, which is value-
                               preserving), but the last shard streams
                               padding — noted so sizing
                               is a conscious choice.
    ``shard-budget-overflow``  a join's *per-shard* resident factor
                               elements (axis-0 carriers at n/shards
                               rows, the rest replicated) still exceed
                               4x budget — sharding did not buy the
                               memory headroom the budget models.  The
                               same code covers Contract nodes on the
                               collective-einsum route
                               (``distributed/contract``): per-shard
                               residency there is the adjacency row
                               block plus the widest summed
                               *replicated* intermediate plus the
                               free-output row slice.

    All warnings: none makes a sharded execution incorrect — per-shard
    blocks stay certified (see ``precertify``) and padding preserves
    values — they flag mesh/graph pairings that waste the mesh."""
    assert num_shards >= 1, num_shards
    res = VerifyResult()
    if num_shards <= 1:
        return res
    n = info.n
    if n < num_shards:
        res.diagnostics.append(_warn(
            "shard-small-graph", "*",
            f"graph has {n} vertices but the mesh {num_shards} shards — "
            f"execution falls back to single-device"))
        return res
    if n % num_shards:
        res.diagnostics.append(_warn(
            "shard-indivisible", "*",
            f"n = {n} does not divide over {num_shards} shards — the "
            f"padding path runs (correct, but the last shard streams "
            f"{(-n) % num_shards} zero rows)"))
    if budget is None:
        b = plan.meta.get("budget")
        budget = int(b) if isinstance(b, (int, float)) else None
    if budget is not None:
        cap = 4 * budget
        rows = -(-n // num_shards)
        for key, node in _guarded_nodes(plan):
            elems = sum(
                rows * n ** (len(ax) - 1) if 0 in ax else n ** len(ax)
                for ax in node.factor_axes())
            if elems > cap:
                res.diagnostics.append(_warn(
                    "shard-budget-overflow", key,
                    f"per-shard factor residency {elems:.3e} elements "
                    f"still over 4x budget ({cap:.3e}) at "
                    f"{num_shards} shards"))
        # Contract nodes on the collective-einsum route: each shard
        # holds its adjacency row block, every elimination step's
        # intermediate comes back *replicated* from the psum (only the
        # free-output step stays sharded), so the widest replicated
        # intermediate dominates per-shard residency alongside the row
        # block and the output row slice.
        for key, node in plan.nodes.items():
            if not isinstance(node, Contract):
                continue
            free = tuple(node.free)
            q = free_skeleton(node.pattern) if free else node.pattern
            order = tuple(node.order) if node.order else \
                _H.greedy_plan(q, free)
            try:
                widths = _H.elimination_widths(q, order, free=free)
            except Exception:
                continue              # malformed order — verify() flags it
            inter = max((n ** w for _, w in widths), default=1)
            out_slice = rows * n ** (len(free) - 1) if free else 1
            elems = rows * n + inter + out_slice
            if elems > cap:
                res.diagnostics.append(_warn(
                    "shard-budget-overflow", key,
                    f"per-shard contraction residency {elems:.3e} "
                    f"elements (row block + widest replicated "
                    f"intermediate) still over 4x budget ({cap:.3e}) "
                    f"at {num_shards} shards"))
    return res


def refusal_flags(plan: Plan, info: GraphInfo) -> List[Diagnostic]:
    """Joins that can *never* take the kernel route: if a lower bound on
    the factor-magnitude product already exceeds EXACT_LIMIT at the
    smallest chunk, every serving query pays the guard scan and falls
    back to the dense f64 join.  The lower bound uses the factor's
    identity term (the largest free-hom pattern in its Möbius family,
    whose entries dominate the alternating sum for frontend-shaped
    families): for a tree skeleton on k vertices, greedy extension gives
    inj >= n · max(0, min_degree − k + 2)^(k−1) embeddings spread over
    at most n^rank entries.  Advisory only — compile-time signal to
    re-plan (a wider budget, a different cut) rather than refuse."""
    out: List[Diagnostic] = []
    for key, node in _guarded_nodes(plan):
        prod = 1.0
        for terms, ax in zip(node.factors, node.factor_axes()):
            lb = _factor_floor(plan, terms, len(ax), info)
            if lb is None or lb <= 0.0:
                prod = 0.0
                break
            prod *= lb
        if prod * MIN_BLOCK > EXACT_LIMIT:
            out.append(_warn(
                "always-refused", key,
                f"factor magnitude floor {prod:.3e} blows the exactness "
                f"limit ({EXACT_LIMIT:.3e}) at the minimum chunk — every "
                f"query will guard-scan and fall back to the dense f64 "
                f"join"))
    return out


def _factor_floor(plan, terms, rank, info: GraphInfo) -> Optional[float]:
    """Lower bound on max|M| for one factor, via its identity term only
    (sound for frontend Möbius families, where the combined entries are
    injective counts >= 0 and the identity hom dominates).  Tree
    skeletons only — their injective-embedding floor is closed-form."""
    best = None
    for _, ref in terms:
        node = plan.nodes.get(ref)
        if not isinstance(node, Contract) or not node.free:
            return None
        if best is None or node.pattern.n > best.pattern.n:
            best = node
    skel = free_skeleton(best.pattern)
    k = skel.n
    if not (skel.is_connected() and len(skel.edges) == k - 1):
        return None
    if k == 1:
        inj_floor = float(info.n)
    else:
        inj_floor = float(info.n) * \
            float(max(0, info.min_degree - k + 2)) ** (k - 1)
    return inj_floor / float(info.n) ** rank


# -- morph identity validation ----------------------------------------------------

def _km_labels(p, m: int) -> Optional[tuple]:
    """Vertex labels for the labelled complete graph K_m: cycle the
    pattern's own alphabet, so every pattern label is realised."""
    if p.labels is None:
        return None
    alphabet = sorted(set(p.labels))
    return tuple(alphabet[i % len(alphabet)] for i in range(m))


def _brute_hom_km(q, m: int, glabels: Optional[tuple]) -> int:
    """hom(q, K_m) by enumeration: maps sending every pattern edge to
    distinct endpoints (all distinct pairs are K_m edges), respecting
    labels when both sides carry them."""
    import itertools
    total = 0
    for f in itertools.product(range(m), repeat=q.n):
        if glabels is not None and q.labels is not None and any(
                glabels[f[v]] != q.labels[v] for v in range(q.n)):
            continue
        if all(f[u] != f[v] for u, v in q.edges):
            total += 1
    return total


def _brute_inj_km(p, m: int, glabels: Optional[tuple]) -> int:
    """inj(p, K_m) by enumeration: every injective (label-respecting)
    map embeds, since all distinct pairs are adjacent in K_m."""
    import itertools
    total = 0
    for f in itertools.permutations(range(m), p.n):
        if glabels is not None and p.labels is not None and any(
                glabels[f[v]] != p.labels[v] for v in range(p.n)):
            continue
        total += 1
    return total


def morph_check(candidate) -> VerifyResult:
    """Validate one committed morph identity (``morph.MorphCandidate``)
    on the pattern-lattice endpoints, graph-free:

    * empty graph: every edged hom/inj vanishes, so the identity
      degenerates to 0 = 0 — a nonzero coefficient on an edge*less*
      quotient would break it (quotients of an edged pattern always
      keep an edge);
    * complete graphs K_m, m in {n, n+1, n+2} (label-cycled when the
      pattern is labelled): both sides brute-forced by enumeration and
      compared as exact integers — wrong Möbius coefficients, a missing
      quotient, or a wrong automorphism divisor all surface here.

    Diagnostics: ``morph-endpoint-empty``, ``morph-endpoint-complete``,
    ``morph-divisor``; ``ok`` means the identity is safe to serve."""
    res = VerifyResult()
    p = candidate.pattern
    pk = f"morph:{p.n}v{p.m}e"
    if p.m:
        for coeff, q in candidate.terms:
            if coeff and not q.m:
                res.diagnostics.append(_err(
                    "morph-endpoint-empty", pk,
                    f"coefficient {coeff} on edgeless quotient breaks "
                    f"the empty-graph endpoint (lhs 0, rhs "
                    f"{coeff} * hom(edgeless) != 0)"))
    divisor = getattr(candidate, "divisor", None)
    if divisor is not None and divisor != p.aut_order():
        res.diagnostics.append(_err(
            "morph-divisor", pk,
            f"divisor {divisor} != |Aut| = {p.aut_order()}"))
    for m in range(p.n, p.n + 3):
        glabels = _km_labels(p, m)
        lhs = _brute_inj_km(p, m, glabels)
        rhs = sum(coeff * _brute_hom_km(q, m, glabels)
                  for coeff, q in candidate.terms)
        if lhs != rhs:
            res.diagnostics.append(_err(
                "morph-endpoint-complete", pk,
                f"identity fails on K_{m}: brute inj {lhs} != "
                f"expanded sum {rhs}"))
    return res
