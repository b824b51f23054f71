"""Lowering: plan IR -> executable closures over PyTorch/CUDA primitives.

``CompiledPlan`` binds a serializable ``Plan`` to one input graph on one
device and evaluates nodes on demand with per-node memoisation:

* ``Contract``   -> ``CountingEngine.hom`` / ``hom_free_tensor`` (bucket
                    elimination ``torch.einsum``s, f64, budget-chunked).
                    Free cut tensors stay on the device: the join tier
                    reads them where they lie;
* ``Intersect``  -> degeneracy-ordered clique enumeration (host), or the
                    fused CUDA triangle kernel (``kernels.ops.
                    triangle_count``, Σ A ⊙ (A @ A), f32 product, f64
                    sum) when ``use_pallas`` is set and k == 3;
* ``CutJoin``    -> the fused CUDA kernel tier for |cut| <= 3: the
                    k-factor masked product-reduce (``kernels.ops.
                    cutjoin_reduce``) for |cut| <= 2, the tri-join
                    (``cutjoin_reduce3``) for |cut| = 3 — axis-subset
                    factors read through stride-0 axes, pairwise-distinct
                    mask from an index compare, so no O(n^|cut|) mask is
                    ever materialised — with f32 partials over at most
                    ``block`` cells folded into f64 inside the kernel.
                    The chunk size comes from an exactness guard
                    (``cutjoin_exact_block``) fed by per-factor max
                    magnitudes cached on the plan: integer counts are
                    only routed to f32 chunks the bound proves exact.
                    On the card, a |cut| = 1 join the guard refuses
                    takes the vector kernel's f64 instance where
                    ``cutjoin_exact_f64`` admits it (route
                    ``kernel-f64``).  The dense f64 ``_join_reduce``
                    (dense factor stack x explicit mask, axis-subset
                    factors broadcast dense) remains the counted route
                    for wider cuts / over-bound magnitudes /
                    ``cutjoin_kernel=False``;
* ``LocalCount`` -> the same join without the final reduce (the
                    partial-embedding reads): a reduce-free tensor is the
                    dense factor product; one kept cut axis takes the
                    keep-axis kernels (``cutjoin_reduce_keep`` /
                    ``cutjoin_reduce3_keep``) under the same guard; on
                    the card a |cut| = 2 one the guard refuses takes the
                    keep kernel's f64 instance where
                    ``cutjoin_exact_f64`` admits it (route
                    ``kernel-keep-f64``); else the dense f64
                    ``_join_keep`` / ``_join_keep3``;
* the combine ops run on host scalars, or on device tensors for
  vector-valued nodes; a scalar may be a Python number or a 0-d tensor.

Node values memoise per plan *and* feed the engine's hom memo, so
repeated queries against a compiled application never re-contract.
With a morph count store (``count_store=``, a ``compiler.morph.
CountStore``) scalar ``Contract`` and ``Intersect`` reads consult the
store first (route ``morph-derive``: no contraction, no kernel; the node
keys land in ``CompiledPlan.morph_reads``), and every count read
harvests the plan's exact scalars back into it.

Attach an ``obs.Tracer`` (``compiled_plan.tracer = tracer``) to record
one span per node evaluation under one "execute" root per public read,
as the reference does; untraced (the default) a node costs one ``is
None`` check.  Each span's ``route`` is the route its node took, and for
a join it equals the node's ``join_log`` record's: ``kernel``,
``kernel-keep``, ``dense-product`` and the non-join routes
(``morph-derive``, ``einsum``, ``einsum-free``, ``pallas-triangle``,
``enumeration``, ``host``) carry the reference's names; the reference's
f64 dense routes are renamed — its ``xla-dense`` is the port's
``dense-f64`` and its ``xla-keep`` is ``dense-f64-keep`` — and the
card-only f64 instances ``kernel-f64`` / ``kernel-keep-f64`` have no
counterpart there.

With a mesh (``mesh=``, a ``distributed.meshes.DataMesh`` of more than
one slot) the plan runs on the sharded tier, as in the reference: the
default engine's ``Contract`` nodes run sliced over the mesh's slots
(route ``einsum-sharded``) and hand their free tensors on as the slots
made them (``distributed.contract.Sliced``: the join reads each slot's
block in place; a route that needs a tensor whole gathers it, counted in
``contract.slice_gathers``), guarded ``CutJoin`` / ``LocalCount`` joins
split their cut grid over cut axis 0 (``kernel-sharded``,
``kernel-sharded-keep``: the tile entry points on each slot's slice).  A
join the guard refuses takes, on the card and where ``exact_f64`` admits
it, the f64 instance of its kernel on each slice (``kernel-f64-sharded``
for |cut| = 1, ``kernel-f64-sharded-keep`` for a |cut| = 2 keep join);
otherwise, and always on the CPU, the sharded dense f64 route
(``dense-f64-sharded``, ``dense-f64-sharded-keep``).  So on the CPU
routes and plans are the reference's.  Each sharded route's span carries
``mesh_axes=["data"]`` and ``num_shards``.  A graph
with fewer vertices than slots, or a join wider than |cut| = 3, falls back
to one device (``cutjoin.shard_fallbacks_{compile,execute}``, reasons
``small-n`` and ``wide-cut``).  The reference's ``xla-sharded`` is the
port's ``dense-f64-sharded`` and its ``xla-sharded-keep`` is
``dense-f64-sharded-keep``; on the card ``kernel-f64-sharded`` and
``kernel-f64-sharded-keep`` stand where the reference takes those two
(it has no f64 kernel instance); the other sharded labels are its own.
Every ``obs.counter`` is kept.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import Pattern, clique
from repro_torch.distributed.contract import Sliced, gather
from repro_torch.graph.storage import Graph
from repro_torch.compiler.ir import (Contract, CutJoin, Intersect, LocalCount,
                                     MobiusCombine, Plan, ShrinkageCorrect,
                                     domain_keys, free_skeleton,
                                     is_local_output, local_key,
                                     pattern_key)

def _dims(M) -> tuple:
    """A factor's shape: a ``Sliced`` one's extent (n on every axis)."""
    return M.extent if isinstance(M, Sliced) else tuple(M.shape)


def _join_reduce(stack):
    """Π of the stacked factor tensors (leading axis), then full sum."""
    return torch.sum(torch.prod(stack, dim=0))


def _join_keep(stack, axis: int):
    """Keep-axis dense route: Π of stacked (n, n) f64 factors, off-
    diagonal masked, summed over the non-kept axis."""
    prod = torch.prod(stack, dim=0)
    prod.fill_diagonal_(0.0)
    return torch.sum(prod, dim=1 - axis)


def _join_keep3(stack, mask, keep: int):
    """Keep-axis |cut| = 3 dense route: Π of stacked (n, n, n) f64 factors
    under the dense pairwise-distinct mask, summed over the two non-kept
    axes."""
    prod = torch.prod(stack, dim=0) * mask
    return torch.sum(prod, dim=tuple(a for a in range(3) if a != keep))


class CompiledPlan:
    """An executable application: one plan, one graph, one device."""

    def __init__(self, plan: Plan, graph: Graph,
                 counter: Optional[CountingEngine] = None,
                 use_pallas: bool = False, from_cache: bool = False,
                 budget: int = 1 << 27, cutjoin_kernel: bool = True,
                 mesh=None, count_store=None, device=None):
        self.plan = plan
        self.graph = graph
        # a default engine inherits the mesh so Contract nodes run their
        # contractions sliced too (a caller-supplied counter keeps its own
        # device and mesh binding — pass mesh= to CountingEngine to shard
        # it)
        self.counter = counter or CountingEngine(graph, budget=budget,
                                                 device=device, mesh=mesh)
        self.device = self.counter.device
        self.use_pallas = use_pallas
        self.cutjoin_kernel = cutjoin_kernel
        self.from_cache = from_cache
        # execution mesh of the sharded join tier (distributed.cutjoin);
        # None keeps every join single-device
        self.mesh = mesh
        # morph count store (compiler.morph.CountStore): scalar hom reads
        # consult it before contracting (route "morph-derive")
        self.count_store = count_store
        self._gsig: Optional[str] = None
        self.morph_reads: list = []        # node keys served from the store
        self._values: Dict[str, object] = {}
        self._masks: Dict[int, torch.Tensor] = {}
        self._factors: Dict[tuple, torch.Tensor] = {}
        self._factor_maxes: Dict[tuple, float] = {}
        # id(Sliced vector) -> (it, its gathered tensor); see _tensor
        self._gathered: Dict[int, tuple] = {}
        self._precert: Optional[Dict[str, int]] = None
        # one record per evaluated CutJoin / LocalCount node: cut size,
        # kept axes, route, granted chunk, and whether the guard was
        # precertified or scanned
        self.join_log: list = []
        # attach an ``obs.Tracer`` here to record per-node span trees on
        # every public read; None (the default) costs one is-None check
        # per node eval — nothing else
        self.tracer = None
        self.stats = obs.StatsView(
            "plan", keys=("node_evals", "node_hits", "exists_early_exits"))

    # -- tracing hooks -----------------------------------------------------------
    def _root(self, op: str, key: str):
        """Root "execute" span for one public read (no-op untraced).
        Node spans opened by the ``value`` recursion nest beneath it, so
        a trace's root coverage measures how much of the end-to-end read
        the per-node accounting explains."""
        tr = self.tracer
        if tr is None:
            return nullcontext()
        tr.meta.setdefault("backend", self.device.type)
        return tr.span(f"{op}:{key}", kind="execute", op=op)

    def _annotate(self, **attrs):
        """Attach attributes to the innermost open span (no-op untraced
        or outside any span — eval helpers are also called directly)."""
        tr = self.tracer
        if tr is not None:
            tr.annotate(**attrs)

    # -- morph store hooks -------------------------------------------------------
    def _store_hom(self, node_key: str):
        """Held scalar hom for one ``hom:`` node key, or None (no store
        attached / miss).  The graph signature is resolved lazily once."""
        if self.count_store is None:
            return None
        if self._gsig is None:
            from repro_torch.compiler.cache import graph_signature
            self._gsig = graph_signature(self.graph)
        held = self.count_store.get_key(self._gsig, node_key)
        if held is not None:
            self.morph_reads.append(node_key)
        return held

    def _harvest(self):
        if self.count_store is not None:
            self.count_store.harvest(self)

    # -- public API --------------------------------------------------------------
    def count(self, p: Pattern) -> float:
        """Edge-induced embedding count of one compiled pattern."""
        key = self.plan.output_for(p)
        with self._root("count", key):
            val = float(self.value(key))
        self._harvest()
        return val

    def counts(self) -> dict:
        """All compiled count outputs: canonical pattern key -> count
        (partial-embedding outputs are tensors — read them through
        ``local_counts``)."""
        with self._root("counts", "*"):
            out = {pk: float(self.value(nk))
                   for pk, nk in self.plan.outputs.items()
                   if not is_local_output(pk)}
        self._harvest()
        return out

    def has_local(self, p: Pattern, anchor: Optional[int] = None) -> bool:
        """True when the plan carries the requested partial-embedding
        output (compiled with ``local=True``; unanchored tensors need an
        eligible cutting set — cliques have none)."""
        return local_key(p, anchor) in self.plan.outputs

    def local_counts(self, p: Pattern,
                     anchor: Optional[int] = None) -> torch.Tensor:
        """Partial-embedding counts of one pattern compiled with
        ``local=True``, as an f64 tensor on the plan's device.

        ``anchor=None``: the full local tensor over the cutting set
        chosen for ``p.canonical()`` — axis j indexes the assignment of
        the j-th smallest cut vertex *of the canonical form*
        (``plan.meta["local_cuts"]`` records the cut), entry e_c is the
        exact number of injective maps pinning the cut to e_c.
        ``anchor=v``: the (N,) vector of completion counts with pattern
        vertex v pinned per graph vertex — anchors in one automorphism
        orbit share their entry.  Raises ``KeyError`` when the plan has
        no such output."""
        key = local_key(p, anchor)
        nk = self.plan.outputs.get(key)
        if nk is None:
            raise KeyError(
                f"plan has no partial-embedding output {key!r} "
                f"(compiled without local=True, or the pattern has no "
                f"eligible cutting set)")
        # a copy, not the memo: plans are memoised across serving steps,
        # so handing out the node value itself would let one caller's
        # in-place edit corrupt every later answer
        with self._root("local_counts", nk):
            return self.value(nk).clone()

    def exists(self, p: Pattern) -> bool:
        """Existence with early exit: on a local plan, factor tensors
        evaluate one subpattern at a time and an all-zero factor decides
        False before the join or any shrinkage correction runs (one
        subpattern with no embeddings means the whole pattern has none);
        otherwise any positive local entry — or, without a local output,
        the scalar count — decides."""
        nk = self.plan.outputs.get(local_key(p))
        node = self.plan.nodes.get(nk) if nk is not None else None
        with self._root("exists", nk or pattern_key(p)):
            if isinstance(node, LocalCount):
                for terms, ax in zip(node.factors, node.factor_axes()):
                    M = self._combine(terms, len(ax))
                    if not any(bool((P.abs() > 0.5).any()) for P in (
                            M.parts if isinstance(M, Sliced) else (M,))):
                        self.stats["exists_early_exits"] += 1
                        self._annotate(early_exit=True)
                        return False
                return bool(self.value(nk).max() > 0.5)
            if nk is not None:
                return bool(self.value(nk).max() > 0.5)
            return self.count(p) > 0.5

    def executable(self, p: Pattern):
        """Zero-arg closure for one pattern (plan handle for callers that
        dispatch queries later)."""
        key = self.plan.output_for(p)
        return lambda: float(self.value(key))

    def domains(self, p: Pattern) -> dict:
        """FSM MINI domain vectors of one pattern compiled with
        ``domains=True``: canonical orbit-representative vertex -> (N,)
        f64 tensor (a copy) counting injective maps sending that vertex to
        each graph vertex.  Raises ``KeyError`` when the plan has no
        domain nodes for ``p``."""
        out = {}
        with self._root("domains", pattern_key(p)):
            for key in domain_keys(p):
                if key not in self.plan.nodes:
                    raise KeyError(f"plan has no domain node {key!r} "
                                   f"(compiled without domains=True?)")
                out[int(key.rsplit(":", 1)[1])] = self.value(key).clone()
        return out

    def mini_support(self, p: Pattern) -> int:
        """MINI support = min over pattern vertices of the domain size;
        orbit representatives suffice (orbit members share domains)."""
        return min(int(torch.count_nonzero(dom > 0.5))
                   for dom in self.domains(p).values())

    # -- evaluation --------------------------------------------------------------
    def value(self, key: str):
        if key in self._values:
            self.stats["node_hits"] += 1
            return self._values[key]
        node = self.plan.nodes[key]
        self.stats["node_evals"] += 1
        tr = self.tracer
        if tr is None:                   # the default: no span machinery
            val = self._eval(node)
        else:
            # one span per node eval, nested by the recursion itself
            # (refs evaluated inside ``_eval`` open child spans; memo
            # hits open none — the trace tree is exactly the work done).
            # ``predicted`` pairs the APCT cost the model charged at
            # selection time for the drift report; the fence closes the
            # span only after the card has really finished.
            attrs = {"predicted":
                     self.plan.meta.get("node_costs", {}).get(key)}
            cut = getattr(node, "cut_size", None)
            if cut is not None:
                attrs["cut_size"] = cut
            with tr.span(key, kind=type(node).__name__, **attrs):
                val = obs.fence(self._eval(node))
        self._values[key] = val
        return val

    def _eval(self, node):
        if isinstance(node, Contract):
            if not node.free:
                held = self._store_hom(node.key)
                if held is not None:
                    self._annotate(route="morph-derive")
                    return float(held)
            shards = self.counter.contract_shards()
            if node.free:
                # decode the marker-encoded pattern: strips cut-rank
                # markers, restores real vertex labels (label-masked
                # contraction on labelled patterns)
                if shards > 1:
                    self._annotate(route="einsum-sharded",
                                   adjacency="sharded", mesh_axes=["data"],
                                   num_shards=shards)
                else:
                    self._annotate(route="einsum-free")
                skel = free_skeleton(node.pattern)
                return self.counter.hom_free_value(skel, node.free,
                                                   order=node.order)
            if shards > 1:
                self._annotate(route="einsum-sharded", adjacency="sharded",
                               mesh_axes=["data"], num_shards=shards)
            else:
                self._annotate(route="einsum")
            return self.counter.hom(node.pattern, order=node.order or None)
        if isinstance(node, Intersect):
            held = self._store_hom(node.key)
            if held is not None:
                self._annotate(route="morph-derive")
                return float(held)
            if self.use_pallas and node.k == 3:
                from repro_torch.kernels import ops
                self._annotate(route="pallas-triangle")
                adj = torch.from_numpy(self.graph.dense_adjacency(
                    np.float32, pad=False)).to(self.device)
                return 6.0 * ops.triangle_count(adj)
            self._annotate(route="enumeration")
            return self.counter.hom(clique(node.k))
        if isinstance(node, MobiusCombine):
            self._annotate(route="host")
            acc = 0.0
            for coeff, ref in node.terms:
                acc += coeff * self._tensor(self.value(ref))
            return acc / node.divisor
        if isinstance(node, CutJoin):
            return self._eval_cutjoin(node)
        if isinstance(node, LocalCount):
            return self._eval_local(node)
        if isinstance(node, ShrinkageCorrect):
            self._annotate(route="host")
            acc = self.value(node.base)
            for mult, ref in node.corrections:
                acc -= mult * self.value(ref)
            return acc / node.divisor
        raise TypeError(type(node))

    def _combine(self, terms, ndim: int):
        """One Möbius factor tensor Σ coeff · tensor(ref), f64, on the
        device — treat the result as READ-ONLY.  Genuine combinations
        memoise by term tuple (CutJoin and LocalCount nodes over the same
        cut, and ``exists`` early-exit probes, share them); a single
        identity term returns the node value itself — duplicating every
        Contract tensor into a second (n,)*ndim tensor would roughly
        double a long-lived plan's steady-state memory.  Under a mesh the
        terms are the contraction's row blocks (``Sliced``) and so is
        their combination, made slot by slot where the blocks lie."""
        if len(terms) == 1 and terms[0][0] == 1.0:
            return self.value(terms[0][1])
        key = (terms, ndim)
        M = self._factors.get(key)
        if M is None:
            vals = [self.value(ref) for _, ref in terms]
            first = vals[0]
            if isinstance(first, Sliced) and all(
                    isinstance(v, Sliced) and len(v.parts) == len(first.parts)
                    and v.rows == first.rows for v in vals):
                parts = []
                for s, P0 in enumerate(first.parts):
                    P = torch.zeros_like(P0)
                    for (coeff, _), v in zip(terms, vals):
                        P = P + coeff * v.parts[s]
                    parts.append(P)
                M = Sliced(tuple(parts), first.rows, first.n)
            else:
                M = torch.zeros((self.graph.n,) * ndim, dtype=torch.float64,
                                device=self.device)
                for (coeff, _), v in zip(terms, vals):
                    M = M + coeff * self._tensor(v)
            self._factors[key] = M
        return M

    def _tensor(self, value):
        """A node value as one tensor: a ``Sliced`` one gathered onto the
        plan's device (``contract.slice_gathers`` counts it).  A gathered
        vector is kept for the plan's next reads (n f64 each; corrections
        and Möbius sums read the same vectors again), a gathered matrix or
        cube is not."""
        if not isinstance(value, Sliced):
            return value
        if value.ndim > 1:
            return gather(value, self.device)
        held = self._gathered.get(id(value))
        if held is None or held[0] is not value:
            held = self._gathered[id(value)] = (value,
                                                gather(value, self.device))
        return held[1]

    def _factor_max(self, terms, ndim: int, M) -> torch.Tensor:
        """max|M| for the factor combined from ``terms``, as a 0-d device
        tensor, memoised under the same key as ``_combine``: the
        ``exact_block`` guard needs every factor's max magnitude on every
        scanned kernel execution.  The reduction runs on the device;
        ``_guard_block`` moves all of a join's maxima in one transfer."""
        key = (terms, ndim)
        v = self._factor_maxes.get(key)
        if v is None:
            if isinstance(M, Sliced):
                v = M.abs_max(self.device)
            else:
                v = (M.abs().max() if M.numel()
                     else torch.zeros((), dtype=M.dtype, device=M.device))
            self._factor_maxes[key] = v
        return v

    def _join_factors(self, node):
        """(factors, axes) of a CutJoin/LocalCount node: each factor
        combined over its *own* axis subset (axis-subset factors stay at
        their own size).  Max magnitudes are *not* scanned here — the
        exactness guard (``_guard_block``) only pays for them when no
        static certificate covers the node, and the dense route never
        needs them at all."""
        axes = node.factor_axes()
        Ms = [self._combine(terms, len(ax))
              for terms, ax in zip(node.factors, axes)]
        return Ms, axes

    def _precertified(self) -> Dict[str, int]:
        """Statically certified ``exact_block`` chunks, computed once
        per compiled plan from the *bound graph* — never trusted from
        ``plan.meta`` (a corrupted cached certificate would silently
        break kernel exactness; recomputing from the graph the plan is
        actually bound to costs microseconds and is always sound)."""
        if self._precert is None:
            from repro_torch import analysis
            self._precert = analysis.precertify(
                self.plan, analysis.GraphInfo.from_graph(self.graph))
        return self._precert

    def _guard_block(self, node, Ms, axes):
        """The ``exact_block`` guard for one join: (block, how, maxes).
        Precertified nodes trust the static certificate — no factor
        scan and no device→host transfer (``maxes`` None); everything
        else reduces each factor's max magnitude on the device and moves
        them together, under a traced ``guard-scan`` span, so the cost
        the certificate removes stays visible in traces."""
        from repro_torch.kernels import ops
        static = self._precertified().get(node.key)
        if static is not None:
            block = ops.runtime_block(static)
            obs.counter("kernel.exact_block", outcome="precertified")
            self._annotate(exact_block=block, precertified=True)
            return block, "precertified", None
        tr = self.tracer
        ctx = (tr.span(f"guard:{node.key}", kind="guard-scan")
               if tr is not None else nullcontext())
        with ctx:
            maxes = torch.stack([self._factor_max(terms, len(ax), M)
                                 for terms, M, ax in zip(node.factors, Ms,
                                                         axes)]).tolist()
            block = ops.cutjoin_exact_block(Ms, maxes=maxes)
        self._annotate(exact_block=block)
        return block, "scanned", maxes

    @staticmethod
    def _f64_admits(Ms, maxes, cells: int) -> bool:
        """A join the f32 guard refused may take the f64 instance of its
        kernel: on the card only (on the CPU every route stays the
        reference's), and where ``cutjoin_exact_f64`` admits its
        factors over ``cells`` reduced cells."""
        from repro_torch.kernels import ops
        return Ms[0].is_cuda and maxes is not None and \
            ops.cutjoin_exact_f64(maxes, cells)

    def _dense_expand(self, Ms, axes, k: int):
        """Broadcast axis-subset factors to the full (n,)*k cut grid —
        the dense route only; the kernel tier never calls this.
        Costing admits |cut| >= 3 joins by their *factor* sizes
        (pair-only formulations stay eligible where n^k doesn't fit),
        so the dense route must refuse rather than materialise the
        n^k stack + mask the budget never approved — ``PlanTooWide``
        sends callers down their legacy fallback path."""
        from repro_torch.core.homomorphism import PlanTooWide
        n = self.graph.n
        if k >= 3 and n ** k > 4 * self.counter.budget:
            raise PlanTooWide(
                f"dense |cut| = {k} fallback would materialise "
                f"{n ** k:.2e}-element factors/mask beyond the cap "
                f"(kernel guard refused or cutjoin_kernel=False)")
        out = []
        for M, ax in zip(Ms, axes):
            if len(ax) == k:
                out.append(M)
                continue
            shape = tuple(n if a in ax else 1 for a in range(k))
            out.append(M.reshape(shape).expand((n,) * k))
        return out

    def _shard_fallback(self, reason: str):
        """Count one sharded-tier fallback, split by phase: a fresh
        compile's plan evals and a cache-hit serve's re-lower each
        re-evaluate the same nodes, so phase-keyed counters keep the two
        populations apart in ``obs`` snapshots."""
        phase = "execute" if self.from_cache else "compile"
        obs.counter(f"cutjoin.shard_fallbacks_{phase}", reason=reason)
        self._annotate(shard_fallback=reason)

    def _mesh_shards(self) -> int:
        """Usable shard count for this plan's joins: 1 without a mesh (or
        a trivial one); a graph smaller than the mesh falls back to one
        device — fewer rows than slots would leave slots idle."""
        if self.mesh is None:
            return 1
        from repro_torch.distributed import meshes
        d = meshes.num_shards(self.mesh)
        if d <= 1:
            return 1
        if self.graph.n < d:
            self._shard_fallback("small-n")
            return 1
        return d

    def _sharded(self, rec, route: str, shards: int):
        rec["route"] = route
        self._annotate(route=route, mesh_axes=["data"], num_shards=shards)

    def _eval_cutjoin(self, node: CutJoin) -> float:
        Ms, axes = self._join_factors(node)
        rec = {"node": node.key, "cut": node.cut_size, "keep": None,
               "factor_shapes": [list(_dims(M)) for M in Ms],
               "route": "dense-f64", "block": None, "guard": None}
        self.join_log.append(rec)
        self._annotate(factor_shapes=rec["factor_shapes"])
        shards = self._mesh_shards()
        if self.cutjoin_kernel and node.cut_size <= 3:
            from repro_torch.kernels import ops
            block, how, maxes = self._guard_block(node, Ms, axes)
            rec.update(block=block, guard=how)
            f64 = block is None and node.cut_size == 1 and \
                self._f64_admits(Ms, maxes, _dims(Ms[0])[0])
            if shards > 1 and (block is not None or f64):
                # the tile entry points on each slot's slice: f32 chunks
                # under the guard, else K1's f64 instance
                from repro_torch.distributed import cutjoin as dcj
                if f64:
                    self._sharded(rec, "kernel-f64-sharded", shards)
                    obs.counter("cutjoin.kernel_f64", cut=1)
                    return dcj.sharded_cutjoin(Ms, mesh=self.mesh,
                                               distinct=False, f64=True)
                self._sharded(rec, "kernel-sharded", shards)
                if node.cut_size <= 2:
                    return dcj.sharded_cutjoin(
                        Ms, mesh=self.mesh, distinct=node.cut_size >= 2,
                        block=block)
                return dcj.sharded_cutjoin3(Ms, axes, n=self.graph.n,
                                            mesh=self.mesh, block=block)
            Ms = [self._tensor(M) for M in Ms]
            if block is not None:            # f32 chunks provably exact
                rec["route"] = "kernel"
                self._annotate(route="kernel")
                if node.cut_size <= 2:
                    return ops.cutjoin_reduce(Ms,
                                              distinct=node.cut_size >= 2,
                                              block=block)
                return ops.cutjoin_reduce3(Ms, axes, n=self.graph.n,
                                           block=block)
            if f64:
                rec["route"] = "kernel-f64"
                self._annotate(route="kernel-f64")
                obs.counter("cutjoin.kernel_f64", cut=1)
                return ops.cutjoin_reduce_f64(Ms)
            # factor magnitudes exceed what chunked f32 can represent
            # exactly: fall through to the f64 dense join
            obs.counter("cutjoin.kernel_fallbacks", cut=node.cut_size)
        Ms = [self._tensor(M) for M in Ms]
        Ms = self._dense_expand(Ms, axes, node.cut_size)
        if node.cut_size >= 2:               # injectivity of the cut tuple
            Ms.append(self._mask(node.cut_size))
        if shards > 1 and node.cut_size <= 3:
            # no bound admits the factors, or cutjoin_kernel=False, under
            # a mesh: the f64 dense join still shards (no chunking, no
            # guard)
            from repro_torch.distributed import cutjoin as dcj
            self._sharded(rec, "dense-f64-sharded", shards)
            return dcj.sharded_dense_join(Ms, node.cut_size, mesh=self.mesh)
        if shards > 1:
            self._shard_fallback("wide-cut")
        self._annotate(route="dense-f64")
        return _join_reduce(torch.stack(Ms)).item()

    def _eval_local(self, node: LocalCount) -> torch.Tensor:
        """The decomposition join without the final reduce.  Reduce-free
        (keep == all axes): the factor product with the off-diagonal
        mask applied *after* subtracting corrections — anchored
        correction tensors only equal true pinned-injective counts at
        distinct pins, so diagonal entries are defined to zero by the
        mask, matching Σ L = inj exactly.  Keep-axis (|cut| in {2, 3},
        one surviving axis): the keep-axis kernels when the exactness
        guard admits the factors, else the dense f64 mask-and-sum;
        corrections are already vector-sized and subtract after the
        reduce."""
        Ms, axes = self._join_factors(node)
        rec = {"node": node.key, "cut": node.cut_size,
               "keep": list(node.keep),
               "factor_shapes": [list(_dims(M)) for M in Ms],
               "route": "dense-product", "block": None, "guard": None}
        self.join_log.append(rec)
        self._annotate(factor_shapes=rec["factor_shapes"])
        if node.cut_size == 1 or len(node.keep) == node.cut_size:
            self._annotate(route="dense-product")
            dense = self._dense_expand([self._tensor(M) for M in Ms], axes,
                                       node.cut_size)
            out = dense[0].clone(memory_format=torch.contiguous_format)
            for M in dense[1:]:
                out *= M
            if node.corrections:
                out -= self._tensor(self._combine(node.corrections,
                                                  len(node.keep)))
            self._zero_collisions(out)       # injectivity of the cut tuple
            return out
        # keep-axis reduce: |cut| in {2, 3}, one surviving axis
        axis = node.keep[0]
        out = None
        rec["route"] = "dense-f64-keep"
        shards = self._mesh_shards()
        if self.cutjoin_kernel:
            from repro_torch.kernels import ops
            block, how, maxes = self._guard_block(node, Ms, axes)
            rec.update(block=block, guard=how)
            f64 = block is None and node.cut_size == 2 and \
                self._f64_admits(Ms, maxes, _dims(Ms[0])[1 - axis])
            if shards > 1 and (block is not None or f64):
                # the keep tile entry points on each slot's slice: f32
                # chunks under the guard, else K3's f64 instance
                from repro_torch.distributed import cutjoin as dcj
                if f64:
                    self._sharded(rec, "kernel-f64-sharded-keep", shards)
                    obs.counter("cutjoin.kernel_f64", cut=2, keep=True)
                    out = dcj.sharded_cutjoin_keep(Ms, keep=axis,
                                                   mesh=self.mesh, f64=True)
                elif node.cut_size == 2:
                    self._sharded(rec, "kernel-sharded-keep", shards)
                    out = dcj.sharded_cutjoin_keep(Ms, keep=axis,
                                                   mesh=self.mesh,
                                                   block=block)
                else:
                    self._sharded(rec, "kernel-sharded-keep", shards)
                    out = dcj.sharded_cutjoin3_keep(Ms, axes, keep=axis,
                                                    n=self.graph.n,
                                                    mesh=self.mesh,
                                                    block=block)
            elif block is not None:          # f32 chunks provably exact
                Ms = [self._tensor(M) for M in Ms]
                rec["route"] = "kernel-keep"
                self._annotate(route="kernel-keep")
                if node.cut_size == 2:
                    out = ops.cutjoin_reduce_keep(Ms, keep=axis,
                                                  block=block)
                else:
                    out = ops.cutjoin_reduce3_keep(Ms, axes, keep=axis,
                                                   n=self.graph.n,
                                                   block=block)
            elif f64:
                Ms = [self._tensor(M) for M in Ms]
                rec["route"] = "kernel-keep-f64"
                self._annotate(route="kernel-keep-f64")
                obs.counter("cutjoin.kernel_f64", cut=2, keep=True)
                out = ops.cutjoin_reduce_keep_f64(Ms, keep=axis)
            else:
                obs.counter("cutjoin.kernel_fallbacks", cut=node.cut_size,
                            keep=True)
        if out is None:
            Ms = [self._tensor(M) for M in Ms]
        if out is None and shards > 1:
            # no bound admits the factors, or cutjoin_kernel=False, under
            # a mesh: the f64 dense keep join still shards (no chunking,
            # no guard)
            from repro_torch.distributed import cutjoin as dcj
            dense = self._dense_expand(Ms, axes, node.cut_size)
            dense.append(self._mask(node.cut_size))
            self._sharded(rec, "dense-f64-sharded-keep", shards)
            out = dcj.sharded_dense_join_keep(dense, node.cut_size,
                                              keep=axis, mesh=self.mesh)
        if out is None:
            self._annotate(route="dense-f64-keep")
            stack = torch.stack(self._dense_expand(Ms, axes,
                                                   node.cut_size))
            if node.cut_size == 2:
                out = _join_keep(stack, axis)
            else:
                out = _join_keep3(stack, self._mask(3), axis)
        out = out.to(self.device)      # a mesh's result lies on its slot 0
        if node.corrections:
            out = out - self._tensor(self._combine(node.corrections, 1))
        return out

    @staticmethod
    def _zero_collisions(out: torch.Tensor):
        """Zero every entry whose index tuple repeats a value — the cut
        injectivity mask applied in place to a reduce-free local tensor
        (ndim 2: the diagonal; ndim 3: the three pairwise-equal planes;
        ndim 1: nothing — a single cut vertex is always injective)."""
        if out.ndim == 1:
            return
        if out.ndim == 2:
            out.fill_diagonal_(0.0)
            return
        assert out.ndim == 3
        idx = torch.arange(out.shape[0], device=out.device)
        out[idx, idx, :] = 0.0
        out[idx, :, idx] = 0.0
        out[:, idx, idx] = 0.0

    def _mask(self, k: int) -> torch.Tensor:
        """Π_{a<b} [x_a != x_b] over a (n,)*k grid, f64 on the device."""
        if k not in self._masks:
            n = self.graph.n
            mask = torch.ones((n,) * k, dtype=torch.float64,
                              device=self.device)
            off = 1.0 - torch.eye(n, dtype=torch.float64,
                                  device=self.device)
            for a in range(k):
                for b in range(a + 1, k):
                    shape = [1] * k
                    shape[a] = shape[b] = n
                    mask = mask * off.reshape(shape)
            self._masks[k] = mask
        return self._masks[k]


def lower(plan: Plan, graph: Graph, *, counter=None, use_pallas=False,
          from_cache=False, budget: int = 1 << 27,
          cutjoin_kernel: bool = True, verify: bool = False,
          mesh=None, count_store=None, device=None) -> CompiledPlan:
    """Bind a plan to a graph on ``device`` (None: the CUDA device).
    ``verify=True`` runs the static verifier against this graph first and
    raises ``PlanVerifyError`` instead of binding a malformed plan — for
    plans that arrived from outside ``compiler.compile`` (hand-built,
    deserialized, mutated), which already verifies what it commits.
    ``count_store`` (a ``compiler.morph.CountStore``) serves held scalar
    homs without contracting and is fed by every count read."""
    if verify:
        from repro_torch import analysis
        analysis.verify(
            plan, graph_info=analysis.GraphInfo.from_graph(graph),
            budget=budget).raise_if_failed()
    return CompiledPlan(plan, graph, counter=counter, use_pallas=use_pallas,
                        from_cache=from_cache, budget=budget,
                        cutjoin_kernel=cutjoin_kernel, mesh=mesh,
                        count_store=count_store, device=device)
