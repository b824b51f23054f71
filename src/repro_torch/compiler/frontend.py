"""Frontend: pattern set -> candidate plan fragments.

For every pattern the frontend materialises the same search space
``MiningEngine.choose_cut`` walked implicitly — the direct plan plus one
candidate per cutting set — but as explicit IR fragments whose node keys
are canonical-pattern strings.  Assembling fragments into one ``Plan``
CSE-merges nodes by key, so quotient contractions shared across patterns
(the 112 6-motifs drawing from one quotient pool) appear exactly once in
the joint plan.

Two candidate styles exist per cutting set:

* ``cut-order``  — the Möbius-over-quotients plan with elimination orders
  that keep the cutting set as the separator (eliminated last);
* ``decomposed`` — the paper's decomposition join made explicit: per
  subpattern, a Möbius combination of free-cut-vertex hom tensors
  (``M_i(e_c)``), joined by ``CutJoin`` over injective cut tuples and
  corrected by ``ShrinkageCorrect`` over the shrinkage quotients.  Exact:
      inj(p) = Σ_{e_c} Π_i M_i(e_c) − Σ_σ mult(σ)·inj(p/σ)
  where σ ranges over cross-component merging partitions (§2.4).

|cut| >= 3 cutting sets emit a third style, ``decomposed-subset`` (the
tri-join kernel tier's form): each subpattern keeps only the cut
vertices adjacent to its component, so its factor tensor spans a
*subset* of the cut axes — recorded in ``CutJoin.axes`` — with cut-cut
edges as standalone pair factors and the weakened injectivity repaired
by the generalised shrinkage (``quotient.shrinkage_patterns_subset``).

Vertex labels are a constraint, not an eligibility gate: labelled
patterns generate the same candidate space.  Free-hom contractions pack
the real vertex label with the cut-rank marker into one
``LABEL_STRIDE``-encoded label (see ``core.pattern``), so the label mask
is enforced inside each ``M_i`` factor — the one-hot indicators are
idempotent under the CutJoin product — and quotients merging differently
labelled vertices vanish exactly (they are dropped with the self-loop
quotients).

``domain_candidate`` emits the FSM tier: per automorphism orbit of a
pattern, a vector-valued Möbius combination of single-free-vertex hom
tensors (the compiled form of ``CountingEngine.inj_free``), in the same
``homf:`` CSE namespace as the decomposition factors — sibling patterns
in an FSM lattice level share their quotient tensors through it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core import cost_model as CM
from repro_torch.core import homomorphism as H
from repro_torch.core.decomposition import cutting_sets, subpatterns
from repro_torch.core.pattern import Pattern
from repro_torch.core.quotient import (mobius, partitions, quotient_terms,
                                 shrinkage_patterns,
                                 shrinkage_quotients_with_maps)
from repro_torch.compiler.ir import (Contract, CutJoin, Intersect, LocalCount,
                               MobiusCombine, Plan, ShrinkageCorrect,
                               domain_keys, mark_free, pattern_key)


def _is_complete(q: Pattern) -> bool:
    return (q.labels is None and q.n >= 3
            and q.m == q.n * (q.n - 1) // 2)


def _hom_node(q: Pattern, order: tuple):
    """Contract or Intersect node for one canonical quotient."""
    key = f"hom:{pattern_key(q)}"
    if _is_complete(q):
        return Intersect(key, q.n)
    return Contract(key, q, tuple(order))


@dataclass
class Candidate:
    """One way to compute a pattern's edge-induced count: a topologically
    ordered node fragment plus the key of its output node."""
    pattern: Pattern
    cut: Optional[frozenset]
    style: str                               # direct | cut-order | decomposed
    nodes: List[object] = field(default_factory=list)
    out_key: str = ""

    def _add(self, node):
        for have in self.nodes:
            if have.key == node.key:
                return node.key
        self.nodes.append(node)
        return node.key


# -- Möbius-over-quotients candidates --------------------------------------------

def direct_candidate(p: Pattern, cut: Optional[frozenset] = None) -> Candidate:
    """inj(p) = Σ μ·hom(p/σ) with greedy (cut=None) or separator-last
    elimination orders, then / |Aut|."""
    style = "cut-order" if cut else "direct"
    cand = Candidate(p, cut, style)
    terms = []
    for coeff, q in quotient_terms(p):
        if _is_complete(q):
            order = ()
        elif cut:
            order = H.plan_from_cut(q, CM._cut_image(p, cut, q))
        else:
            order = H.greedy_plan(q)
        key = cand._add(_hom_node(q, order))
        terms.append((float(coeff), key))
    out = MobiusCombine(f"cnt:{pattern_key(p)}", tuple(terms),
                        divisor=p.aut_order())
    cand.out_key = cand._add(out)
    return cand


def _inj_terms(cand: Candidate, q: Pattern) -> str:
    """Add an inj(q) combine (divisor 1, greedy orders) to ``cand``;
    returns its node key."""
    terms = []
    for coeff, r in quotient_terms(q):
        order = () if _is_complete(r) else H.greedy_plan(r)
        terms.append((float(coeff), cand._add(_hom_node(r, order))))
    return cand._add(MobiusCombine(f"inj:{pattern_key(q)}", tuple(terms),
                                   divisor=1))


# -- decomposition-join candidates ------------------------------------------------

def _free_hom_terms(cand: Candidate, sub: Pattern,
                    cutpos: Tuple[int, ...]) -> tuple:
    """Möbius terms of M(e_c) for one subpattern: injective embedding
    count of ``sub`` as a tensor over its cut vertices, expanded over the
    partitions of V(sub) keeping cut vertices in distinct blocks.  Real
    vertex labels ride along: ``mark_free`` packs them with the cut-rank
    markers, quotients merging differently labelled vertices are dropped
    (identically zero), and the surviving contractions enforce the label
    mask inside each factor."""
    cutset = set(cutpos)
    acc: dict = {}
    for sigma in partitions(tuple(range(sub.n))):
        if any(len(set(b) & cutset) > 1 for b in sigma):
            continue                        # would pin two cut values equal
        q, blk = sub.quotient_with_map(sigma)
        if q is None:
            continue                        # self-loop / label clash: zero
        free_raw = tuple(blk[c] for c in cutpos)
        _, qc, free_c = mark_free(q, free_raw)
        key = f"homf:{pattern_key(qc)}"
        order = H.greedy_plan(qc, free_c)
        node = Contract(key, qc, tuple(order), free_c)
        if key not in acc:
            acc[key] = [0.0, node]
        acc[key][0] += mobius(sigma)
    terms = []
    for key in sorted(acc):
        coeff, node = acc[key]
        if coeff == 0:
            continue
        cand._add(node)
        terms.append((float(coeff), key))
    return tuple(terms)


def decomposed_candidate(p: Pattern, cut: frozenset, *, graph_n: int,
                         budget: int = 1 << 27,
                         max_cut: int = 2) -> Optional[Candidate]:
    """CutJoin/ShrinkageCorrect plan for one cutting set, or None when
    ineligible (wide cut, or cut tensor over budget).  Labelled patterns
    decompose like unlabelled ones: labels live inside the factors.

    |cut| <= 2 keeps the legacy full-cut form (every factor spans the
    whole cut); |cut| >= 3 emits the axis-subset form — see
    ``_subset_decomposed_candidate`` — whose per-factor tensor widths
    the cost model prices against the plan budget (the frontend no
    longer hard-gates on ``graph_n ** k``: a 3-cut join whose factors
    are all pair tensors never materialises n³ anything)."""
    k = len(cut)
    if k > max_cut:
        return None
    if k >= 3:
        return _subset_decomposed_candidate(p, cut)
    if graph_n ** k > budget:
        return None
    cand = Candidate(p, cut, "decomposed")
    factors = []
    for sub, vmap in subpatterns(p, cut):
        cutpos = tuple(vmap[c] for c in sorted(cut))
        terms = _free_hom_terms(cand, sub, cutpos)
        if not terms:
            return None
        factors.append(terms)
    cut_sig = "-".join(map(str, sorted(cut)))
    join = CutJoin(f"cutjoin:{pattern_key(p)}:{cut_sig}", k, tuple(factors))
    join_key = cand._add(join)
    corrections = []
    for q, mult in shrinkage_patterns(p, cut):
        corrections.append((float(mult), _inj_terms(cand, q)))
    out = ShrinkageCorrect(f"cnt:{pattern_key(p)}:{cut_sig}", join_key,
                           tuple(corrections), divisor=p.aut_order())
    cand.out_key = cand._add(out)
    return cand


def _subset_decomposed_candidate(p: Pattern, cut: frozenset) \
        -> Optional[Candidate]:
    """The axis-subset decomposition join (the |cut| >= 3 tier).

    Each component's subpattern is the component plus only the cut
    vertices *adjacent* to it, so its free-hom factor spans just those
    cut axes — a pair tensor for a component wedged between two cut
    vertices, never an unnecessary n^|cut| expansion.  Edges between
    cut vertices become their own pair factors (the induced 2-vertex
    pattern with both vertices free: the label-masked adjacency), which
    also keeps every cut axis covered for connected patterns.  The two
    injectivity constraints this join no longer enforces — collisions
    across components and collisions of a component vertex with a
    *distant* (non-adjacent) cut vertex — are exactly the generalised
    shrinkage terms ``shrinkage_patterns_subset`` subtracts, so

        inj(p) = Σ_{e_c pairwise distinct} Π_i M_i(e_c)
                 − Σ_σ mult(σ) · inj(p/σ)

    holds exactly (multiplicity 1 per allowed collision partition).
    With every component adjacent to the whole cut this degenerates to
    the full-cut form (all factors |cut|-dimensional, classic
    shrinkage), which is what e.g. a 5-clique minus an edge needs."""
    from repro_torch.core.quotient import shrinkage_patterns_subset
    k = len(cut)
    cut_list = sorted(cut)
    rank = {c: i for i, c in enumerate(cut_list)}
    adj = p.adj()
    cand = Candidate(p, cut, "decomposed-subset")
    factors, axes = [], []
    for comp in p.components_without(cut):
        adjc = sorted(c for c in cut if adj[c] & comp)
        vs = sorted(comp | set(adjc))
        vmap = {v: i for i, v in enumerate(vs)}
        sub = p.induced(vs)
        cutpos = tuple(vmap[c] for c in adjc)
        terms = _free_hom_terms(cand, sub, cutpos)
        if not terms:
            return None
        factors.append(terms)
        axes.append(tuple(rank[c] for c in adjc))
    for (u, v) in sorted(p.edges):
        if u in cut and v in cut:
            terms = _free_hom_terms(cand, p.induced((u, v)), (0, 1))
            if not terms:
                return None
            factors.append(terms)
            axes.append((rank[min(u, v)], rank[max(u, v)]))
    cut_sig = "-".join(map(str, cut_list))
    join = CutJoin(f"cutjoin:{pattern_key(p)}:{cut_sig}", k,
                   tuple(factors), tuple(axes))
    join_key = cand._add(join)
    corrections = []
    for q, mult in shrinkage_patterns_subset(p, cut):
        corrections.append((float(mult), _inj_terms(cand, q)))
    out = ShrinkageCorrect(f"cnt:{pattern_key(p)}:{cut_sig}", join_key,
                           tuple(corrections), divisor=p.aut_order())
    cand.out_key = cand._add(out)
    return cand


# -- partial-embedding (local-count) candidates ------------------------------------

def local_candidate(p: Pattern, cut: frozenset, *, graph_n: int,
                    anchor: Optional[int] = None, budget: int = 1 << 27,
                    max_cut: int = 2) -> Optional[Candidate]:
    """Partial-embedding plan for one cutting set: the decomposition join
    *without* the final reduce.  The output tensor's axis j indexes the
    assignment of the j-th smallest cut vertex; entry e_c is the exact
    number of injective maps of ``p`` pinning the cut to e_c.  With
    ``anchor`` (a cut vertex) only that axis survives — the other cut
    axes are summed away (the keep-axis kernel tier) and the shrinkage
    corrections are emitted anchored at the anchor alone, so they stay
    vector-sized.  None when ineligible (wide cut, over-budget tensor,
    or anchor outside the cut).  |cut| = 3 plans keep the full-cut
    factor form (axes unannotated): anchored reads run the keep-axis
    tri-join kernel, and costing prices the 3-D factor materialisation
    against the plan budget, so they only commit where they fit."""
    k = len(cut)
    if k > min(max_cut, 3) or graph_n ** k > budget:
        return None
    if anchor is not None and anchor not in cut:
        return None
    cand = Candidate(p, cut, "local")
    factors = []
    for sub, vmap in subpatterns(p, cut):
        cutpos = tuple(vmap[c] for c in sorted(cut))
        terms = _free_hom_terms(cand, sub, cutpos)
        if not terms:
            return None
        factors.append(terms)
    cut_list = sorted(cut)
    keep = (tuple(range(k)) if anchor is None
            else (cut_list.index(anchor),))
    keep_verts = tuple(cut_list[j] for j in keep)
    # anchored shrinkage corrections: Σ_σ inj(p/σ ; keep vertices pinned)
    # as one flat Möbius combination over the kept axes.  Individual
    # partitions (not deduped canonical quotients) because each one pins
    # the cut image through its own vertex map; _free_hom_terms then
    # canonicalises the underlying contractions, so repeats CSE-merge.
    corr_acc: dict = {}
    for q, blk in shrinkage_quotients_with_maps(p, cut):
        qpos = tuple(blk[c] for c in keep_verts)
        for coeff, key in _free_hom_terms(cand, q, qpos):
            corr_acc[key] = corr_acc.get(key, 0.0) + coeff
    corrections = tuple((c, key) for key, c in sorted(corr_acc.items())
                        if c != 0)
    cut_sig = "-".join(map(str, cut_list))
    keep_sig = "-".join(map(str, keep))
    out = LocalCount(f"loc:{pattern_key(p)}:{cut_sig}:k{keep_sig}",
                     k, keep, tuple(factors), corrections)
    cand.out_key = cand._add(out)
    return cand


def anchored_direct_candidate(p: Pattern, anchor: int) -> Candidate:
    """Anchored fallback without a decomposition: the flat Möbius
    expansion of inj(p ; anchor ↦ u) over single-free-vertex hom tensors
    (the compiled form of ``CountingEngine.inj_free``).  Always exists —
    the route for cliques and other patterns whose cutting sets miss the
    anchor — and shares the ``homf:`` namespace with domain fragments."""
    cand = Candidate(p, None, "local-direct")
    terms = _free_hom_terms(cand, p, (anchor,))
    _, qc, _ = mark_free(p, (anchor,))
    cand.out_key = cand._add(
        MobiusCombine(f"locd:{pattern_key(qc)}", terms, divisor=1))
    return cand


def local_candidates(p: Pattern, *, graph_n: int,
                     anchor: Optional[int] = None, budget: int = 1 << 27,
                     max_cut: int = 2) -> List[Candidate]:
    """Candidate space for one partial-embedding output.  Unanchored:
    one ``local`` candidate per eligible cutting set (possibly empty —
    cliques have no local tensor).  Anchored: cutting sets containing
    the anchor, plus the always-available flat Möbius fallback."""
    out = []
    for cut in cutting_sets(p):
        cand = local_candidate(p, cut, graph_n=graph_n, anchor=anchor,
                               budget=budget, max_cut=max_cut)
        if cand is not None:
            out.append(cand)
    if anchor is not None:
        out.append(anchored_direct_candidate(p, anchor))
    return out


# -- FSM domain fragments ----------------------------------------------------------

def domain_candidate(p: Pattern) -> Candidate:
    """FSM MINI-domain fragment: one vector-valued Möbius combination per
    automorphism orbit of the canonical form — the compiled equivalent of
    ``CountingEngine.inj_free`` for every pattern vertex at once.
    Vertices in one orbit share their domain, so only orbit
    representatives materialise; the free-hom contractions live in the
    same ``homf:`` namespace as decomposition-join factors and CSE-merge
    with them and with sibling patterns' fragments."""
    c = p.canonical()
    cand = Candidate(c, None, "domains")
    for key, rep in zip(domain_keys(c), (o[0] for o in c.vertex_orbits())):
        terms = _free_hom_terms(cand, c, (rep,))
        cand.out_key = cand._add(MobiusCombine(key, terms, divisor=1))
    return cand


# -- search space / assembly ------------------------------------------------------

def pattern_candidates(p: Pattern, *, graph_n: int, budget: int = 1 << 27,
                       max_cutjoin_cut: int = 3) -> List[Candidate]:
    """The full candidate space for one pattern, direct plan first."""
    out = [direct_candidate(p)]
    for cut in cutting_sets(p):
        out.append(direct_candidate(p, cut))
        dec = decomposed_candidate(p, cut, graph_n=graph_n, budget=budget,
                                   max_cut=max_cutjoin_cut)
        if dec is not None:
            out.append(dec)
    return out


def assemble(selections) -> Plan:
    """[(pattern, Candidate)] -> one joint Plan; nodes CSE-merge by key."""
    plan = Plan()
    for p, cand in selections:
        for node in cand.nodes:
            plan.add(node)
        plan.set_output(p, cand.out_key)
    return plan
