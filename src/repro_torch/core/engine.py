"""MiningEngine: the partial-embedding-centric programming model (paper §3).

Guarantees (paper):
  * Completeness — if one partial embedding of a subpattern is processed,
    all partial embeddings of that subpattern are processed;
  * Coverage — the processed subpatterns jointly cover every pattern vertex.

Both hold by construction: the engine decomposes the pattern with a
cutting set, and processes *every* partial embedding of *every* subpattern
(whose union covers V_p since each subpattern contains V_C plus one
component).

Fast paths (pattern counting, existence) are tensor contractions on the
engine's device (``device=None`` means the CUDA device and raises without
one).  The generic UDF path follows Algorithm 1 literally — enumerate cut
tuples e_c, per-subpattern extension counts M_i, shrinkage hash tables —
on the host, and is exact on any graph the host enumeration can afford;
it exists to give UDFs the same semantics the paper defines.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.apct import APCT
from repro_torch.core.counting import CountingEngine, _connected_order
from repro_torch.core.decomposition import cutting_sets, subpatterns
from repro_torch.core.pattern import Pattern
from repro_torch.core.quotient import shrinkage_quotients_with_maps
from repro_torch.graph.storage import Graph
from repro_torch.kernels.build import KernelError

UNDETERMINED = -1


@dataclass(frozen=True)
class PartialEmbedding:
    subpattern_id: int
    vertices: tuple                   # per pattern vertex: graph id or -1

    def get_vertex(self, i: int) -> int:
        return self.vertices[i]

    @property
    def determined(self):
        return [(i, v) for i, v in enumerate(self.vertices)
                if v != UNDETERMINED]


class MiningEngine:
    def __init__(self, graph: Graph, apct: Optional[APCT] = None,
                 budget: int = 1 << 27, morph=False, device=None):
        self.graph = graph
        self.counter = CountingEngine(graph, budget=budget, device=device)
        self.apct = apct or APCT(graph)
        self._compiled: dict = {}           # canonical pattern -> CompiledPlan
        self.compiler_fallbacks = 0
        # morphing count algebra (compiler.morph): False off, True the
        # process store, or a CountStore — threaded into every compile,
        # so clustered queries serve algebraically from earlier reads
        self.morph = morph

    # -- decomposition choice -------------------------------------------------
    def choose_cut(self, p: Pattern):
        """Cost-model-optimal cutting set (None = direct fallback, the
        paper's degeneration guard).  Delegates to the compiler's costing
        stage — one search implementation for engine and compiler."""
        from repro_torch.compiler import costing
        return costing.choose_cut(p, self.apct, self.graph.n)

    # -- fast paths -------------------------------------------------------------
    def get_pattern_count(self, p: Pattern, induced: str = "edge",
                          cut="auto", use_compiler: bool = True) -> float:
        """Edge/vertex-induced count.  The edge-induced path goes through
        ``compiler.compile`` (plan IR + plan cache, so repeated queries
        skip decomposition search); the legacy direct contraction remains
        the fallback (``use_compiler=False``, explicit cuts, or any
        compile/execute failure other than ``KernelError`` — a kernel that
        does not build or launch propagates)."""
        if induced == "edge" and use_compiler and cut == "auto":
            try:
                from repro_torch import compiler
                key = p.canonical()
                cp = self._compiled.get(key)
                if cp is None:
                    cp = compiler.compile((p,), self.graph, apct=self.apct,
                                          counter=self.counter,
                                          morph=self.morph)
                val = cp.count(p)
                # cache only plans that executed: a plan whose execution
                # raised (e.g. PlanTooWide) must not be retried from the
                # memo on every later query
                self._compiled[key] = cp
                return val
            except KernelError:
                raise
            except Exception:
                self.compiler_fallbacks += 1    # legacy path takes over
        if cut == "auto":
            cut = self.choose_cut(p)
        if induced == "edge":
            return self.counter.edge_induced(p, cut=cut)
        return self.counter.vertex_induced(p)

    def pattern_exists(self, p: Pattern) -> bool:
        return self.counter.existence(p)

    # -- Algorithm 1 (generic UDF path) -------------------------------------------
    def run_partial_embeddings(self, p: Pattern,
                               udf: Callable[[PartialEmbedding, int], None],
                               cut="auto"):
        """Enumerate all partial embeddings of every subpattern with their
        extension counts and pass them to the UDF (Algorithm 1)."""
        if cut == "auto":
            cut = self.choose_cut(p)
        if not cut:
            cs = cutting_sets(p)
            cut = cs[0] if cs else None
        if cut is None:
            # clique-like: the whole pattern is the single "subpattern"
            for emb in self._enumerate(p):
                udf(PartialEmbedding(0, emb), 1)
            return
        subs = subpatterns(p, cut)                      # [(pattern, map)]
        cut_list = sorted(cut)

        # shrinkage hash tables: num_shrinkages_i[pe]
        shrinks = [dict() for _ in subs]
        for q, sigma_map in shrinkage_quotients_with_maps(p, cut):
            for emb in self._enumerate(q):
                # emb maps q's vertices to graph ids; pull back to p
                pv = [emb[sigma_map[v]] for v in range(p.n)]
                for i, (sub, vmap) in enumerate(subs):
                    key = tuple(pv[v] for v in sorted(vmap))
                    shrinks[i][key] = shrinks[i].get(key, 0) + 1

        # per-subpattern embedding lists grouped by cut tuple
        sub_embs = []
        for i, (sub, vmap) in enumerate(subs):
            groups: dict = {}
            new_cut = tuple(vmap[c] for c in cut_list)
            for emb in self._enumerate(sub):
                key = tuple(emb[c] for c in new_cut)
                groups.setdefault(key, []).append(emb)
            sub_embs.append(groups)

        all_keys = set().union(*[set(g) for g in sub_embs]) \
            if sub_embs else set()
        for e_c in sorted(all_keys):
            Ms = [len(g.get(e_c, ())) for g in sub_embs]
            M = math.prod(Ms)
            if M == 0:
                continue
            for i, (sub, vmap) in enumerate(subs):
                inv = {nv: ov for ov, nv in vmap.items()}
                for emb in sub_embs[i].get(e_c, ()):
                    full = [UNDETERMINED] * p.n
                    for nv, gid in enumerate(emb):
                        full[inv[nv]] = gid
                    key = tuple(full[v] for v in sorted(vmap))
                    cnt = M // Ms[i] - shrinks[i].get(key, 0)
                    if cnt > 0:
                        udf(PartialEmbedding(i, tuple(full)), cnt)

    def materialize(self, p: Pattern, pe: PartialEmbedding,
                    num: int) -> list:
        """Extend a partial embedding to at most ``num`` whole-pattern
        embeddings (vertex-set-based extension, Fig 5)."""
        out = []
        fixed = {i: v for i, v in pe.determined}
        todo = [i for i in range(p.n) if i not in fixed]
        g = self.graph

        def rec(assign):
            if len(out) >= num:
                return
            if len(assign) == p.n:
                out.append(tuple(assign[i] for i in range(p.n)))
                return
            v = todo[len(assign) - len(fixed)]
            back = [u for u in range(p.n) if p.has_edge(u, v) and u in assign]
            cands = (set(g.neighbors(assign[back[0]]))
                     if back else set(range(g.n)))
            for u in back[1:]:
                cands &= set(g.neighbors(assign[u]))
            for x in sorted(cands):
                if x in assign.values():
                    continue
                if g.labels is not None and p.labels is not None and \
                        g.labels[x] != p.labels[v]:
                    continue
                assign[v] = x
                rec(assign)
                del assign[v]
                if len(out) >= num:
                    return

        rec(dict(fixed))
        return out

    # -- helpers -----------------------------------------------------------------
    def _enumerate(self, p: Pattern) -> list:
        """All injective embedding tuples of p (host, small patterns)."""
        g = self.graph
        order = _connected_order(p)
        pos = {v: i for i, v in enumerate(order)}
        out = []
        assign = [UNDETERMINED] * p.n

        def rec(i):
            if i == p.n:
                out.append(tuple(assign))
                return
            v = order[i]
            back = [u for u in range(p.n)
                    if p.has_edge(u, v) and pos[u] < i]
            if back:
                cands = set(g.neighbors(assign[back[0]]))
                for u in back[1:]:
                    cands &= set(g.neighbors(assign[u]))
            else:
                cands = range(g.n)
            used = {assign[order[j]] for j in range(i)}
            for x in cands:
                if x in used:
                    continue
                if g.labels is not None and p.labels is not None and \
                        g.labels[x] != p.labels[v]:
                    continue
                # edge-induced: all pattern edges to earlier vertices hold
                assign[v] = x
                rec(i + 1)
                assign[v] = UNDETERMINED

        rec(0)
        return out
