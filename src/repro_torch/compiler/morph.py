"""Pattern-morphing count algebra: serve motif families from held counts.

Counts of a pattern are integer linear combinations of counts of its
lattice neighbours (Pattern Morphing, Jamshidi & Vora).  The algebra is
the partition-lattice Möbius machinery already in ``core.quotient``:

    inj(p)  =  sum_sigma  mu(sigma) * hom(p / sigma)        (quotient_terms)
    hom(p)  =  sum_sigma            inj(p / sigma)          (hom_expansion)

so an exact-count store of scalar ``hom`` / ``inj`` values lets a query
pattern be answered *without compiling a plan*: expand ``inj(p)`` over
quotient homs, densify any missing ``hom`` through its own injective
expansion, and recurse — every value grounded in a store entry that some
earlier ``CompiledPlan`` evaluation materialised.  Under clustered
traffic (motif families, the FSM frontier) the handful of compiled plans
needed to warm the store then serves the whole family algebraically.

Three pieces live here:

* ``CountStore`` — the persistent exact-count store.  Keys are
  ``(graph_signature, "hom:<pattern_key>" | "inj:<pattern_key>")`` with
  canonical pattern keys, so labelled orbit members share entries.
  Process-local dict tier plus an optional atomic on-disk tier
  (one ``counts-<gsig>.json`` per graph, tmp-write + ``os.replace``,
  ``MORPH_FORMAT_VERSION``-stamped — the same write/versioning
  discipline as ``PlanCache``; see the format note in ``cache.py``).
  ``CountStore.harvest`` scrapes every exact scalar an executed
  ``CompiledPlan`` materialised (non-free Contract homs, Intersect
  clique homs, ``inj:`` Möbius nodes, ``cnt:`` outputs).
* the lattice explorer — ``morph_neighbours`` (bounded edge-add/remove
  BFS over canonical connected patterns: the coverage frontier / family
  workload) and ``derive``, which builds the inclusion–exclusion
  identity for a query pattern over store-held values and returns a
  ``MorphCandidate`` carrying the coefficients and the set of *missing*
  homs still requiring a contraction.
* the costing hook — ``MorphCandidate.missing`` maps one-to-one onto the
  ``hom:`` Contract nodes of a direct plan, so ``compiler.compile``
  prices a morph by handing ``costing.select_candidates`` the set of
  held node keys (held contractions cost ~0, missing ones keep their
  APCT price) and serves fully-closed queries straight from the store.

The port keeps the reference package's keys, coefficients and on-disk
format (``MORPH_FORMAT_VERSION``, ``counts-<gsig>.json`` with the same
``compiler.cache.graph_signature``), so a store file written by either
package is read by the other.  Its plan values are f64 tensors on the
plan's device: ``harvest`` moves all the scalars it takes in one transfer.
No store read launches a kernel.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import torch

from repro_torch import obs
from repro_torch.compiler.ir import (Contract, Intersect, MobiusCombine,
                               is_local_output, pattern_key)
from repro_torch.core.pattern import Pattern, clique
from repro_torch.core.quotient import hom_expansion, quotient_terms

MORPH_FORMAT_VERSION = 1


def pattern_from_key(key: str) -> Pattern:
    """Invert ``ir.pattern_key``: ``"<n>.<bits>[:l1,l2,...]"`` back to the
    canonical :class:`Pattern`.  The bit index runs row-major over vertex
    pairs ``i < j`` exactly as ``Pattern._code`` packs them."""
    head, _, lab = key.partition(":")
    n_s, _, bits_s = head.partition(".")
    n, bits = int(n_s), int(bits_s)
    edges = []
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            if bits >> k & 1:
                edges.append((i, j))
            k += 1
    labels = tuple(int(x) for x in lab.split(",")) if lab else None
    return Pattern(n, edges, labels)


def entry_key(kind: str, p: Pattern) -> str:
    """Store entry key for ``kind`` in {"hom", "inj"} — canonicalises, so
    ``hom`` entries carry exactly the node keys of plan Contract nodes."""
    return f"{kind}:{pattern_key(p)}"


class CountStore:
    """Exact scalar-count store keyed by graph signature and canonical
    pattern key.  Memory tier always; disk tier when ``path`` is given
    (atomic per-graph JSON files, format-versioned — drift is a clean
    miss, mirroring ``PlanCache``)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: Dict[str, Dict[str, int]] = {}
        self._loaded: Set[str] = set()
        self._dirty: Set[str] = set()
        self.stats = obs.StatsView(
            "countstore", keys=("hits", "misses", "puts", "format_misses",
                                "sync_failures"))
        if path:
            os.makedirs(path, exist_ok=True)

    # -- tiers ---------------------------------------------------------------
    def _file(self, gsig: str) -> str:
        return os.path.join(self.path, f"counts-{gsig}.json")

    def _counts(self, gsig: str) -> Dict[str, int]:
        c = self._mem.setdefault(gsig, {})
        if self.path and gsig not in self._loaded:
            self._loaded.add(gsig)
            f = self._file(gsig)
            if os.path.exists(f):
                try:
                    with open(f) as fh:
                        doc = json.load(fh)
                    if doc.get("version") != MORPH_FORMAT_VERSION:
                        raise ValueError("count-store format drift")
                    disk = {str(k): int(v)
                            for k, v in doc["counts"].items()}
                except (OSError, ValueError, KeyError, TypeError):
                    self.stats["format_misses"] += 1
                else:
                    for k, v in disk.items():
                        c.setdefault(k, v)
        return c

    def sync(self) -> None:
        """Flush dirty graphs to the disk tier — atomic tmp-write +
        ``os.replace`` per file, same discipline as ``PlanCache.put``."""
        if not self.path:
            self._dirty.clear()
            return
        for gsig in sorted(self._dirty):
            doc = {"version": MORPH_FORMAT_VERSION, "graph": gsig,
                   "counts": self._mem.get(gsig, {})}
            final = self._file(gsig)
            tmp = f"{final}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as fh:
                    fh.write(json.dumps(doc, sort_keys=True))
                os.replace(tmp, final)
            except OSError:
                # read-only store dir: serving continues off memory
                self.stats["sync_failures"] += 1
            finally:
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
        self._dirty.clear()

    # -- accessors -----------------------------------------------------------
    def get_key(self, gsig: str, key: str) -> Optional[int]:
        v = self._counts(gsig).get(key)
        self.stats["hits" if v is not None else "misses"] += 1
        return v

    def get(self, gsig: str, kind: str, p: Pattern) -> Optional[int]:
        return self.get_key(gsig, entry_key(kind, p))

    def has(self, gsig: str, kind: str, p: Pattern) -> bool:
        return entry_key(kind, p) in self._counts(gsig)

    def put(self, gsig: str, kind: str, p: Pattern, value) -> int:
        """Record one exact value (rounded to int — counts are exact in
        f64 up to 2**53).  Returns 1 when the entry is new, else 0."""
        c = self._counts(gsig)
        k = entry_key(kind, p)
        iv = int(round(float(value)))
        if c.get(k) == iv:
            return 0
        c[k] = iv
        self._dirty.add(gsig)
        self.stats["puts"] += 1
        return 1

    def held_hom_keys(self, gsig: str) -> Set[str]:
        """Plan node keys (``hom:<pattern_key>``) of scalar homs held for
        ``gsig`` — the pool the costing hook prices at ~0."""
        return {k for k in self._counts(gsig) if k.startswith("hom:")}

    def __len__(self) -> int:
        return sum(len(c) for c in self._mem.values())

    # -- feeding -------------------------------------------------------------
    def harvest(self, cp) -> int:
        """Scrape every exact scalar an executed plan materialised into
        the store: evaluated non-free ``Contract`` homs, ``Intersect``
        clique homs, ``inj:`` Möbius nodes, and ``cnt:`` outputs (count ×
        |Aut| = inj).  Scalars held as device tensors come to the host in
        one transfer; vector-valued nodes (keep-axis, domain outputs) are
        left out.  Idempotent and cheap; syncs when anything is new."""
        from repro_torch.compiler.cache import graph_signature
        gsig = graph_signature(cp.graph)
        plan = cp.plan
        take = []                              # (kind, pattern, value, ×)
        for key, val in list(cp._values.items()):
            node = plan.nodes.get(key)
            if isinstance(node, Contract) and not node.free:
                take.append(("hom", node.pattern, val, 1))
            elif isinstance(node, Intersect):
                take.append(("hom", clique(node.k), val, 1))
            elif (isinstance(node, MobiusCombine) and node.divisor == 1
                  and key.startswith("inj:")):
                take.append(("inj", pattern_from_key(key[4:]), val, 1))
        for pk, nk in plan.outputs.items():
            if is_local_output(pk) or nk not in cp._values:
                continue
            divisor = getattr(plan.nodes.get(nk), "divisor", None)
            if not divisor:
                continue
            take.append(("inj", pattern_from_key(pk), cp._values[nk],
                         divisor))
        take = [t for t in take if not (isinstance(t[2], torch.Tensor)
                                        and t[2].numel() != 1)]
        on_device = [t[2] for t in take if isinstance(t[2], torch.Tensor)]
        if on_device:
            host = iter(torch.stack([v.reshape(()).to(torch.float64)
                                     for v in on_device]).tolist())
            take = [(kind, p, next(host) if isinstance(v, torch.Tensor)
                     else v, mult) for kind, p, v, mult in take]
        new = 0
        for kind, p, val, mult in take:
            new += self.put(gsig, kind, p, float(val) * mult)
        if new:
            self.sync()
        return new


_DEFAULT_STORE = CountStore()


def default_store() -> CountStore:
    """The process-wide store ``compile(..., morph=True)`` uses, mirroring
    ``compiler.default_cache()``."""
    return _DEFAULT_STORE


# -- lattice explorer --------------------------------------------------------

def morph_neighbours(p: Pattern, distance: int = 1) -> tuple:
    """Connected canonical patterns within ``distance`` edge-add/remove
    steps of ``p`` (same vertex count, ``p`` itself excluded) — the
    morphing coverage frontier / motif-family workload."""
    pc = p.canonical()
    frontier = {pc}
    seen = {pc}
    for _ in range(max(0, int(distance))):
        nxt = set()
        for q in frontier:
            for u in range(q.n):
                for v in range(u + 1, q.n):
                    e = (u, v)
                    if e in q.edges:
                        r = Pattern(q.n, q.edges - {e}, q.labels)
                    else:
                        r = Pattern(q.n, q.edges | {e}, q.labels)
                    if not r.is_connected():
                        continue
                    rc = r.canonical()
                    if rc not in seen:
                        seen.add(rc)
                        nxt.add(rc)
        frontier = nxt
    seen.discard(pc)
    return tuple(sorted(seen, key=lambda q: (q.m, pattern_key(q))))


def motif_family(k: int) -> tuple:
    """All connected ``k``-vertex patterns up to isomorphism, sorted by
    edge count — the canonical motif-family workload (6 members at
    ``k = 4``, 21 at ``k = 5``)."""
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    out = {}
    for bits in range(1 << len(pairs)):
        p = Pattern(k, [e for t, e in enumerate(pairs) if bits >> t & 1])
        if p.is_connected():
            out.setdefault(p.canonical(), None)
    return tuple(sorted(out, key=lambda q: (q.m, pattern_key(q))))


# -- derivation --------------------------------------------------------------

@dataclass(frozen=True)
class MorphCandidate:
    """One algebraic way to serve ``count(pattern)`` off the store:

        count(p) = (sum of coeff * hom(q) over ``terms``) / ``divisor``

    with every ``hom(q)`` either held (possibly densified through held
    ``inj`` entries) or listed in ``missing`` — the contractions a
    direct plan would still have to run.  ``value`` is the derived count
    when the identity closes (``missing`` empty), else ``None``."""
    pattern: Pattern
    terms: Tuple[Tuple[int, Pattern], ...]
    missing: Tuple[Pattern, ...]
    divisor: int
    value: Optional[int] = None

    @property
    def complete(self) -> bool:
        return not self.missing

    def missing_node_keys(self) -> Set[str]:
        """The ``hom:`` Contract node keys a direct plan still needs."""
        return {entry_key("hom", q) for q in self.missing}


class _Resolver:
    """Mutual inj <-> hom densification over the store.  ``hom_expansion``
    contains the identity term ``(1, p)``, so the recursion is guarded by
    an in-progress set — a value resolves only when it grounds in a held
    entry, never through its own expansion."""

    def __init__(self, store: CountStore, gsig: str):
        self.store = store
        self.gsig = gsig
        self._busy: Set[tuple] = set()
        self.derivations = 0

    def _close(self, kind: str, qc: Pattern, total: int) -> int:
        self.store.put(self.gsig, kind, qc, total)
        self.derivations += 1
        obs.counter("morph.derivations")
        return total

    def hom(self, q: Pattern) -> Optional[int]:
        qc = q.canonical()
        v = self.store.get(self.gsig, "hom", qc)
        if v is not None:
            return v
        mark = ("hom", qc)
        if mark in self._busy:
            return None
        self._busy.add(mark)
        try:
            total = 0
            for coeff, r in hom_expansion(qc):
                iv = self.inj(r)
                if iv is None:
                    return None
                total += coeff * iv
        finally:
            self._busy.discard(mark)
        return self._close("hom", qc, total)

    def inj(self, q: Pattern) -> Optional[int]:
        qc = q.canonical()
        v = self.store.get(self.gsig, "inj", qc)
        if v is not None:
            return v
        mark = ("inj", qc)
        if mark in self._busy:
            return None
        self._busy.add(mark)
        try:
            total = 0
            for coeff, r in quotient_terms(qc):
                hv = self.hom(r)
                if hv is None:
                    return None
                total += coeff * hv
        finally:
            self._busy.discard(mark)
        return self._close("inj", qc, total)


def derive(p: Pattern, store: CountStore, gsig: str) -> MorphCandidate:
    """Build the inclusion–exclusion identity serving ``count(p)`` from
    the store.  Resolves each quotient hom (densifying through held inj
    entries where needed); homs that fail to resolve land in ``missing``
    and correspond exactly to the Contract nodes a direct plan would run."""
    pc = p.canonical()
    res = _Resolver(store, gsig)
    terms = []
    missing = []
    total = 0
    for coeff, q in quotient_terms(pc):
        terms.append((int(coeff), q))
        v = res.hom(q)
        if v is None:
            missing.append(q)
        else:
            total += int(coeff) * v
    divisor = pc.aut_order()
    value = None
    if not missing:
        store.put(gsig, "inj", pc, total)
        quo, rem = divmod(total, divisor)
        value = quo if rem == 0 else int(round(total / divisor))
    return MorphCandidate(pattern=pc, terms=tuple(terms),
                          missing=tuple(missing), divisor=divisor,
                          value=value)
