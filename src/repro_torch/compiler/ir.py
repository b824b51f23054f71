"""Execution-plan IR: the compiler's explicit, serializable middle layer.

A plan is a DAG of typed ops keyed by canonical-pattern strings.  Node
keys double as the cross-pattern CSE namespace: two patterns whose
expansions need the same quotient contraction reference the *same*
``Contract`` node (the tensorised form of the paper's shared quotient
pool), so the joint plan for an application pays each contraction once.

Ops
---
``Contract``          bucket-elimination hom contraction of one quotient
                      pattern under an explicit vertex order; with ``free``
                      vertices it yields a tensor over graph vertices
                      (used by the decomposed path's per-subpattern counts).
``Intersect``         the ordered-enumeration / set-intersection route for
                      complete patterns (cliques have no cutting set,
                      paper §2.4); lowers to degeneracy-ordered
                      intersections or a fused triangle kernel.
``MobiusCombine``     Σ coeff · hom(quotient) over the partition lattice
                      (inj when divisor == 1, embedding count when
                      divisor == |Aut|).
``CutJoin``           the decomposition join: Σ_{e_c injective}
                      Π_i M_i(e_c), where each M_i is a Möbius combination
                      of free-vertex ``Contract`` tensors — one factor per
                      subpattern of the chosen cutting set.
``ShrinkageCorrect``  subtracts shrinkage-pattern counts (cross-component
                      vertex collisions, paper §2.4) from a ``CutJoin``
                      value and divides by |Aut|: the decomposed form of
                      an edge-induced embedding count.
``LocalCount``        the partial-embedding output (paper §5): the CutJoin
                      factor product *without* the final Σ_{e_c} reduce —
                      a tensor over cut-vertex assignments whose entry at
                      e_c is the number of injective maps of the whole
                      pattern sending the cutting set to e_c.  ``keep``
                      selects which cut axes survive: all of them is the
                      reduce-free local tensor, a single axis is an
                      anchored vector (every other cut axis summed away).
                      ``corrections`` are anchored shrinkage terms — flat
                      Möbius combinations of free-hom tensors over the
                      kept axes — subtracted entrywise, so every entry is
                      exact, not just the global sum.

Every op is a frozen dataclass with a ``to_dict``/``from_dict`` pair;
``Plan`` serialises to canonical JSON so cached plans survive processes.
Serialised plans carry ``PLAN_FORMAT_VERSION``; deserialising any other
version raises ``PlanFormatError`` (a ``ValueError``), which the on-disk
cache treats as a clean miss — stale-format entries recompile instead of
half-loading.  Structural/semantic validity beyond the schema is the
static verifier's job (``repro_torch.analysis.verify``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# LABEL_STRIDE / encode_free_label / free_skeleton / mark_free are part
# of the IR contract for free-hom Contract nodes: their patterns carry
# LABEL_STRIDE-packed labels combining the real vertex label with the
# cut-rank marker pinning each free axis; lowering and costing decode
# with ``free_skeleton`` (see core.pattern for the packing).
from repro_torch.core.pattern import (LABEL_STRIDE, Pattern, encode_free_label,
                                free_skeleton, mark_free)

Term = Tuple[float, str]                    # (coefficient, node key)


class PlanFormatError(ValueError):
    """A serialised plan was rejected before IR construction: wrong
    format version or an unknown op kind.  ValueError subclass so
    existing clean-miss handlers (``PlanCache._load_disk``) keep
    working; the cache counts these separately from semantic verify
    rejects."""

# serialised-plan schema version; bump on any incompatible IR change so
# on-disk caches written by older code miss cleanly (see Plan.from_dict)
# v3: free-hom Contract patterns may carry LABEL_STRIDE-encoded vertex
# labels (real label + cut-rank marker) — v2 readers would strip them
# v4: LocalCount nodes (partial-embedding outputs) + "loc:"-prefixed
# entries in Plan.outputs — v3 readers would strip-and-serve them as
# count plans, so they must miss instead
# v5: CutJoin/LocalCount factor axis-subset annotation (``axes``) — the
# |cut| >= 3 tier's axis-subset decomposition joins are meaningless to a
# v4 reader (it would expand every factor over the full cut), so they
# must miss instead
PLAN_FORMAT_VERSION = 5


# -- pattern (de)serialisation ---------------------------------------------------

def pattern_key(p: Pattern) -> str:
    """Stable string key of the canonical form (the CSE identity)."""
    c = p.canonical()
    bits, labels = c._code()
    lab = "" if not labels else ":" + ",".join(map(str, labels))
    return f"{c.n}.{bits}{lab}"


def domain_keys(p: Pattern) -> tuple:
    """Node keys of a pattern's FSM MINI-domain vectors, one per
    automorphism orbit of the canonical form (orbit members share their
    domain).  Key construction is the contract between the frontend
    (which emits the nodes) and lowering (which looks them up): both
    derive them from the pattern alone."""
    c = p.canonical()
    return tuple(f"dom:{pattern_key(c)}:{orbit[0]}"
                 for orbit in c.vertex_orbits())


def local_key(p: Pattern, anchor: Optional[int] = None) -> str:
    """Output-table key of a pattern's partial-embedding (local-count)
    result.  Anchored keys canonicalise through ``mark_free``, so every
    vertex of one automorphism orbit — and every isomorphic renumbering
    of the pattern — resolves to the same entry; this is the lookup
    contract between ``compile(local=True)`` (which registers outputs)
    and ``CompiledPlan.local_counts`` (which reads them).  Anchored keys
    get their own ``loca:`` prefix: marker-encoded labels of an anchored
    unlabelled pattern could otherwise collide with the real labels of
    an unanchored labelled one."""
    if anchor is None:
        return f"loc:{pattern_key(p)}"
    _, qc, _ = mark_free(p, (anchor,))
    return f"loca:{pattern_key(qc)}"


def is_local_output(name: str) -> bool:
    """True for ``Plan.outputs`` entries holding partial-embedding
    tensors rather than scalar counts (``pattern_key`` strings always
    start with a digit, so the prefix is unambiguous)."""
    return name.startswith(("loc:", "loca:"))


def pattern_to_dict(p: Pattern) -> dict:
    d = {"n": p.n, "edges": sorted(list(e) for e in p.edges)}
    if p.labels is not None:
        d["labels"] = list(p.labels)
    return d


def pattern_from_dict(d: dict) -> Pattern:
    return Pattern(d["n"], [tuple(e) for e in d["edges"]],
                   tuple(d["labels"]) if d.get("labels") is not None else None)


# -- ops -------------------------------------------------------------------------

@dataclass(frozen=True)
class Contract:
    """hom(pattern) by bucket elimination along ``order``.  Non-empty
    ``free`` keeps those vertices as output axes (axis order = tuple
    order); the pattern's labels are then ``LABEL_STRIDE`` encodings
    packing the real vertex label (if the source pattern is labelled)
    with the cut-rank marker that pins the canonical form — decode with
    ``free_skeleton`` before contracting."""
    key: str
    pattern: Pattern
    order: Tuple[int, ...]
    free: Tuple[int, ...] = ()

    def refs(self):
        return ()

    def to_dict(self) -> dict:
        return {"op": "contract", "key": self.key,
                "pattern": pattern_to_dict(self.pattern),
                "order": list(self.order), "free": list(self.free)}


@dataclass(frozen=True)
class Intersect:
    """hom(K_k) = k! · (# k-cliques) via ordered enumeration."""
    key: str
    k: int

    def refs(self):
        return ()

    def to_dict(self) -> dict:
        return {"op": "intersect", "key": self.key, "k": self.k}


@dataclass(frozen=True)
class MobiusCombine:
    """(Σ coeff · value(ref)) / divisor."""
    key: str
    terms: Tuple[Term, ...]
    divisor: int = 1

    def refs(self):
        return tuple(r for _, r in self.terms)

    def to_dict(self) -> dict:
        return {"op": "mobius", "key": self.key,
                "terms": [[c, r] for c, r in self.terms],
                "divisor": self.divisor}


@dataclass(frozen=True)
class CutJoin:
    """Σ over injective cut tuples of Π_i M_i, with M_i = Σ coeff ·
    tensor(ref) (each ref a free-vertex Contract).  ``axes`` annotates,
    per factor, the sorted subset of cut ranks the factor's tensor
    spans (None = every factor spans the full cut, the |cut| <= 2
    legacy form): axis-subset factors broadcast along the missing cut
    axes inside the join — the |cut| >= 3 tier's pair/vector factors
    stay at their own size instead of expanding to n^|cut|."""
    key: str
    cut_size: int
    factors: Tuple[Tuple[Term, ...], ...]
    axes: Optional[Tuple[Tuple[int, ...], ...]] = None

    def factor_axes(self) -> tuple:
        """Per-factor cut-rank subsets, the full cut when unannotated."""
        if self.axes is not None:
            return self.axes
        return tuple(tuple(range(self.cut_size)) for _ in self.factors)

    def refs(self):
        return tuple(r for f in self.factors for _, r in f)

    def to_dict(self) -> dict:
        d = {"op": "cutjoin", "key": self.key, "cut_size": self.cut_size,
             "factors": [[[c, r] for c, r in f] for f in self.factors]}
        if self.axes is not None:
            d["axes"] = [list(a) for a in self.axes]
        return d


@dataclass(frozen=True)
class ShrinkageCorrect:
    """(value(base) − Σ mult · value(ref)) / divisor — the decomposed
    count after removing cross-component collision (shrinkage) terms."""
    key: str
    base: str
    corrections: Tuple[Term, ...]
    divisor: int = 1

    def refs(self):
        return (self.base,) + tuple(r for _, r in self.corrections)

    def to_dict(self) -> dict:
        return {"op": "shrinkage", "key": self.key, "base": self.base,
                "corrections": [[m, r] for m, r in self.corrections],
                "divisor": self.divisor}


@dataclass(frozen=True)
class LocalCount:
    """Per-partial-embedding counts: entry e_c of the output tensor is
    the number of injective maps of the whole pattern with the cutting
    set pinned to e_c.  Evaluates as

        L = Π_i M_i  −  Σ coeff · corr          (then off-diagonal mask)

    where each M_i is a Möbius combination of ``cut_size``-axis free-hom
    ``Contract`` tensors (the CutJoin factors, axes aligned by cut rank)
    and each correction is a free-hom tensor over the ``keep`` axes only
    (anchored shrinkage terms).  ``keep`` lists the surviving cut axes in
    output order: the full tuple is the reduce-free tensor, a single
    axis sums the others away in-kernel (the keep-axis kernel tier).
    ``axes`` mirrors ``CutJoin.axes``: per-factor cut-rank subsets for
    axis-subset factors (None = full cut)."""
    key: str
    cut_size: int
    keep: Tuple[int, ...]
    factors: Tuple[Tuple[Term, ...], ...]
    corrections: Tuple[Term, ...] = ()
    axes: Optional[Tuple[Tuple[int, ...], ...]] = None

    def factor_axes(self) -> tuple:
        if self.axes is not None:
            return self.axes
        return tuple(tuple(range(self.cut_size)) for _ in self.factors)

    def refs(self):
        return tuple(r for f in self.factors for _, r in f) + \
            tuple(r for _, r in self.corrections)

    def to_dict(self) -> dict:
        d = {"op": "local", "key": self.key, "cut_size": self.cut_size,
             "keep": list(self.keep),
             "factors": [[[c, r] for c, r in f] for f in self.factors],
             "corrections": [[c, r] for c, r in self.corrections]}
        if self.axes is not None:
            d["axes"] = [list(a) for a in self.axes]
        return d


_OPS = {"contract": Contract, "intersect": Intersect, "mobius": MobiusCombine,
        "cutjoin": CutJoin, "shrinkage": ShrinkageCorrect,
        "local": LocalCount}


def op_from_dict(d: dict):
    kind = d["op"]
    if kind == "contract":
        return Contract(d["key"], pattern_from_dict(d["pattern"]),
                        tuple(d["order"]), tuple(d["free"]))
    if kind == "intersect":
        return Intersect(d["key"], d["k"])
    if kind == "mobius":
        return MobiusCombine(d["key"],
                             tuple((c, r) for c, r in d["terms"]),
                             d["divisor"])
    if kind == "cutjoin":
        return CutJoin(d["key"], d["cut_size"],
                       tuple(tuple((c, r) for c, r in f)
                             for f in d["factors"]),
                       tuple(tuple(a) for a in d["axes"])
                       if d.get("axes") is not None else None)
    if kind == "shrinkage":
        return ShrinkageCorrect(d["key"], d["base"],
                                tuple((m, r) for m, r in d["corrections"]),
                                d["divisor"])
    if kind == "local":
        return LocalCount(d["key"], d["cut_size"], tuple(d["keep"]),
                          tuple(tuple((c, r) for c, r in f)
                                for f in d["factors"]),
                          tuple((c, r) for c, r in d["corrections"]),
                          tuple(tuple(a) for a in d["axes"])
                          if d.get("axes") is not None else None)
    raise PlanFormatError(f"unknown op kind {kind!r}")


# -- the plan --------------------------------------------------------------------

@dataclass
class Plan:
    """A compiled application: op DAG + one output node per pattern."""
    nodes: Dict[str, object] = field(default_factory=dict)
    outputs: Dict[str, str] = field(default_factory=dict)   # pattern_key -> node
    meta: dict = field(default_factory=dict)

    def add(self, node) -> str:
        """Insert (or CSE-merge) a node; returns its key.

        Merging is first-wins by key: two candidates may carry the same
        quotient contraction with different elimination orders, and the
        first-committed order is the one that executes.  Values are
        order-invariant (plan invariance), and the cost model's shared
        pool charges exactly the committed node, so this matches the
        paper's reuse semantics."""
        have = self.nodes.get(node.key)
        if have is not None:
            return node.key
        for r in node.refs():
            if r not in self.nodes:
                raise KeyError(f"node {node.key!r} references missing {r!r}")
        self.nodes[node.key] = node
        return node.key

    def set_output(self, p: Pattern, node_key: str):
        if node_key not in self.nodes:
            raise KeyError(node_key)
        self.outputs[pattern_key(p)] = node_key

    def output_for(self, p: Pattern) -> str:
        return self.outputs[pattern_key(p)]

    def set_local_output(self, p: Pattern, node_key: str,
                         anchor: Optional[int] = None):
        """Register a partial-embedding output under ``local_key``; lives
        in the same serialised table as count outputs (prefix-separated,
        see ``is_local_output``)."""
        if node_key not in self.nodes:
            raise KeyError(node_key)
        self.outputs[local_key(p, anchor)] = node_key

    def local_output_for(self, p: Pattern,
                         anchor: Optional[int] = None) -> str:
        return self.outputs[local_key(p, anchor)]

    def op_counts(self) -> dict:
        out: dict = {}
        for node in self.nodes.values():
            name = type(node).__name__
            out[name] = out.get(name, 0) + 1
        return out

    # -- serialisation -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": PLAN_FORMAT_VERSION,
                "nodes": [n.to_dict() for n in self.nodes.values()],
                "outputs": dict(self.outputs), "meta": dict(self.meta)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        version = d.get("version", 1)
        if version != PLAN_FORMAT_VERSION:
            raise PlanFormatError(f"plan format version {version}, "
                                  f"expected {PLAN_FORMAT_VERSION}")
        plan = cls(meta=dict(d.get("meta", {})))
        for nd in d["nodes"]:
            plan.add(op_from_dict(nd))
        for pk, nk in d["outputs"].items():
            if nk not in plan.nodes:
                raise KeyError(nk)
            plan.outputs[pk] = nk
        return plan

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))

    def __eq__(self, other):
        return isinstance(other, Plan) and self.to_dict() == other.to_dict()
