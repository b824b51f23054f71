"""The port's morph count store vs the reference's: ``compiler.morph``
(``pattern_from_key``, ``CountStore`` and its disk tier, ``harvest``,
``morph_neighbours``, ``motif_family``, ``derive``), ``analysis.
morph_check``, ``compile(morph=)`` (the fast path and the fall-back
search with held homs priced at 0), ``MiningEngine(morph=)`` and
``fsm(count_store=)``, on the cases of ``tests/test_morph.py``.

Graphs come from the reference's seeded generators and reach the port as
numpy arrays; the port runs with ``device="cpu"``.  Stores are warmed
with the same exact homs on both sides (the port's ``CountingEngine``,
f64 einsums on graphs of at most 48 vertices), so the two ``derive``s
see the same inputs.  Each reference compile runs once per module
(``compiles``), one APCT per graph and side.  Tolerance is **0**:
derived counts, compiled counts, diagnostic codes, store contents and
store files must be equal.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import analysis as tanalysis
from repro_torch import compiler as tcompiler
from repro_torch import obs as tobs
from repro_torch.compiler import costing as tcosting
from repro_torch.compiler import frontend as tfrontend
from repro_torch.compiler import morph as tmorph
from repro_torch.compiler.cache import PlanCache, graph_signature, plan_key
from repro_torch.compiler.ir import pattern_key
from repro_torch.core import engine as tengine
from repro_torch.core import fsm as tfsm
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import Pattern, chain, clique, cycle
from repro_torch.core.quotient import quotient_terms

from test_torch_reference import (counters_moved, port_graph,  # noqa: F401
                                  reference, shared_apct)

GRAPHS = {
    "er24": dict(n=24, avg_degree=4.0, seed=11),
    "el24": dict(n=24, avg_degree=4.0, seed=3, num_labels=2),
    "er48": dict(n=48, avg_degree=5.0, seed=2),
    "eng48": dict(n=48, avg_degree=5.0, seed=4),
    "fsm40": dict(n=40, avg_degree=4.0, seed=6, num_labels=2),
}


def _key(p):
    """Package-neutral key of a pattern."""
    return (p.n, tuple(sorted(p.edges)), p.labels)


def _pattern_from_bits(n, bits, labels=None):
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return Pattern(n, [e for t, e in enumerate(pairs) if bits >> t & 1],
                   labels=labels)


def _random_patterns(seed, labelled, count=6):
    """Seeded random connected patterns of 3-5 vertices (3-4 labelled,
    labels 0/1), as ``tests/test_morph.py`` sweeps them."""
    rng = np.random.default_rng(seed)
    out = {}
    while len(out) < count:
        n = int(rng.integers(3, 5 if labelled else 6))
        bits = int(rng.integers(1, 1 << (n * (n - 1) // 2)))
        labels = (tuple(int(x) for x in rng.integers(0, 2, n))
                  if labelled else None)
        p = _pattern_from_bits(n, bits, labels)
        if p.is_connected() and p.m > 0:
            out.setdefault(pattern_key(p), p)
    return list(out.values())


RANDOM = {False: _random_patterns(7, False), True: _random_patterns(8, True)}


@pytest.fixture(scope="module")
def ref(reference):
    """The reference's morph tier and the module's graphs, both sides."""
    from repro.compiler import costing, frontend, morph
    from repro.compiler.cache import graph_signature as rgsig
    from repro.core import engine, fsm
    from repro.core.quotient import quotient_terms as rquotient_terms
    G = reference.generators
    graphs = {}
    for name, kw in GRAPHS.items():
        rg = G.erdos_renyi(**kw)
        graphs[name] = (rg, port_graph(rg))
    return types.SimpleNamespace(
        morph=morph, costing=costing, frontend=frontend, gsig=rgsig,
        engine=engine, fsm=fsm, quotient_terms=rquotient_terms,
        compiler=reference.compiler, obs=reference.obs, APCT=reference.APCT,
        P=reference.pattern.Pattern, graphs=graphs, ns=reference)


def _rp(ref, p):
    return ref.P(p.n, sorted(p.edges), p.labels)


def _homs(tg, patterns):
    """Exact hom of every quotient of every pattern (the port's engine)."""
    eng = CountingEngine(tg, device="cpu")
    return {q: eng.hom(q) for p in patterns
            for _, q in quotient_terms(p.canonical())}


def _warm(ref, graph_name, patterns):
    """A port store and a reference store holding the same homs of every
    quotient of ``patterns``."""
    rg, tg = ref.graphs[graph_name]
    tstore, rstore = tmorph.CountStore(), ref.morph.CountStore()
    gsig = graph_signature(tg)
    assert ref.gsig(rg) == gsig
    for q, v in _homs(tg, patterns).items():
        tstore.put(gsig, "hom", q, v)
        rstore.put(gsig, "hom", _rp(ref, q), v)
    return tstore, rstore, gsig


def _same_candidate(ref, got, want):
    assert _key(got.pattern) == _key(want.pattern)
    assert [(c, _key(q)) for c, q in got.terms] == \
        [(c, _key(q)) for c, q in want.terms]
    assert [_key(q) for q in got.missing] == [_key(q) for q in want.missing]
    assert (got.divisor, got.value, got.complete) == \
        (want.divisor, want.value, want.complete)


@pytest.fixture(scope="module")
def compiles(ref):
    """(name) -> results of one compile on each side, computed once per
    module: the pattern set, graph and store each case names."""
    memo = {}

    def run(name):
        if name in memo:
            return memo[name]
        before = ref.obs.snapshot()
        tobs.reset()
        out = {}
        if name.startswith("random-"):
            labelled = name == "random-labelled"
            gname = "el24" if labelled else "er24"
            pats = RANDOM[labelled]
            rg, tg = ref.graphs[gname]
            rcp = ref.compiler.compile(
                [_rp(ref, p) for p in pats], rg, cache=False,
                apct=shared_apct("ref", rg, ref.APCT))
            tcp = tcompiler.compile(pats, tg, cache=False, device="cpu",
                                    apct=shared_apct("port", tg, TAPCT))
            out = {"pats": pats, "gname": gname,
                   "rcounts": [rcp.count(_rp(ref, p)) for p in pats],
                   "tcounts": [tcp.count(p) for p in pats]}
        elif name == "harvest-chain4":
            rg, tg = ref.graphs["er24"]
            tstore, rstore = tmorph.CountStore(), ref.morph.CountStore()
            rcp = ref.compiler.compile(
                (ref.ns.pattern.chain(4),), rg, cache=False, morph=rstore,
                apct=shared_apct("ref", rg, ref.APCT))
            tcp = tcompiler.compile((chain(4),), tg, cache=False,
                                    morph=tstore, device="cpu",
                                    apct=shared_apct("port", tg, TAPCT))
            out = {"rcount": rcp.count(ref.ns.pattern.chain(4)),
                   "tcount": tcp.count(chain(4)), "tstore": tstore,
                   "rstore": rstore, "tcp": tcp}
        elif name == "warm-chain5":
            # the 5-path compiles decomposed-subset, whose scalar quotient
            # homs (P3, K2 among them) close the wedge identity
            rg, tg = ref.graphs["er48"]
            tstore, rstore = tmorph.CountStore(), ref.morph.CountStore()
            ref.compiler.compile(
                (ref.ns.pattern.chain(5),), rg, cache=False, morph=rstore,
                apct=shared_apct("ref", rg, ref.APCT)).count(
                    ref.ns.pattern.chain(5))
            tcompiler.compile((chain(5),), tg, cache=False, morph=tstore,
                              device="cpu",
                              apct=shared_apct("port", tg, TAPCT)).count(
                                  chain(5))
            out = {"tstore": tstore, "rstore": rstore}
        elif name == "fallback-cycle4":
            rg, tg = ref.graphs["er48"]
            rcp = ref.compiler.compile(
                (ref.ns.pattern.cycle(4),), rg, cache=False,
                morph=ref.morph.CountStore(),
                apct=shared_apct("ref", rg, ref.APCT))
            tcp = tcompiler.compile((cycle(4),), tg, cache=False,
                                    morph=tmorph.CountStore(), device="cpu",
                                    apct=shared_apct("port", tg, TAPCT))
            out = {"rcp": rcp, "tcp": tcp,
                   "rcount": rcp.count(ref.ns.pattern.cycle(4)),
                   "tcount": tcp.count(cycle(4))}
        out["rmoved"] = counters_moved(ref.obs, before, (
            "morph.hits", "morph.missing_compiles"))
        out["tmoved"] = {k: tobs.snapshot().get(k, {}) for k in (
            "morph.hits", "morph.missing_compiles")}
        memo[name] = out
        return out

    return run


# -- pattern keys, identities, derive ----------------------------------------------

def test_pattern_from_key_round_trip(ref):
    pats = [chain(3), chain(5), cycle(4), cycle(5), clique(4),
            Pattern(4, [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2)]),
            Pattern(3, [(0, 1), (1, 2)], labels=(1, 0, 1)),
            Pattern(4, [(0, 1), (1, 2), (2, 3)], labels=(0, 2, 0, 1))]
    for p in pats:
        key = pattern_key(p)
        got = tmorph.pattern_from_key(key)
        assert got == p.canonical()
        assert _key(got) == _key(ref.morph.pattern_from_key(key))
        assert tmorph.entry_key("hom", p) == \
            ref.morph.entry_key("hom", _rp(ref, p))


@pytest.mark.parametrize("name", ["wedge", "triangle", "4-cycle", "4-path"])
def test_golden_identities_equal_and_exact(ref, name):
    """inj(wedge) = hom(wedge) - hom(K2); count(K3) = hom(K3) / 6;
    inj(C4) = hom(C4) - 2 hom(P3) + hom(K2); inj(P4) = hom(P4) -
    2 hom(P3) - hom(K3) + hom(K2): the coefficients, both packages'
    ``derive`` and the count of the port's engine."""
    p = {"wedge": chain(3), "triangle": clique(3), "4-cycle": cycle(4),
         "4-path": chain(4)}[name].canonical()
    p3, k2, k3 = chain(3).canonical(), clique(2).canonical(), \
        clique(3).canonical()
    want_terms = {"wedge": {p: 1, k2: -1}, "triangle": {p: 1},
                  "4-cycle": {p: 1, p3: -2, k2: 1},
                  "4-path": {p: 1, p3: -2, k3: -1, k2: 1}}[name]
    assert {q: c for c, q in quotient_terms(p)} == want_terms
    assert [(c, _key(q)) for c, q in quotient_terms(p)] == \
        [(c, _key(q)) for c, q in ref.quotient_terms(_rp(ref, p))]
    tstore, rstore, gsig = _warm(ref, "er24", [p])
    got = tmorph.derive(p, tstore, gsig)
    _same_candidate(ref, got, ref.morph.derive(_rp(ref, p), rstore, gsig))
    tg = ref.graphs["er24"][1]
    assert got.complete and got.value == \
        CountingEngine(tg, device="cpu").edge_induced(p)
    assert tanalysis.morph_check(got).ok


@pytest.mark.parametrize("labelled", [False, True],
                         ids=["unlabelled", "labelled"])
def test_derive_on_random_patterns_equals_both_compiles(ref, compiles,
                                                        labelled):
    r = compiles("random-labelled" if labelled else "random-unlabelled")
    tstore, rstore, gsig = _warm(ref, r["gname"], r["pats"])
    for p, tcount, rcount in zip(r["pats"], r["tcounts"], r["rcounts"]):
        got = tmorph.derive(p, tstore, gsig)
        _same_candidate(ref, got, ref.morph.derive(_rp(ref, p), rstore,
                                                   gsig))
        assert got.complete and got.value == tcount == rcount
        assert tanalysis.morph_check(got).ok
    # the stores densified the same inj / hom entries along the way
    assert tstore._mem == rstore._mem


def _checked_codes(ref, p, terms, divisor):
    got = tanalysis.morph_check(tmorph.MorphCandidate(
        pattern=p, terms=terms, missing=(), divisor=divisor))
    want = ref.ns.analysis.morph_check(ref.morph.MorphCandidate(
        pattern=_rp(ref, p), missing=(), divisor=divisor,
        terms=tuple((c, _rp(ref, q)) for c, q in terms)))
    assert got.ok == want.ok and sorted(got.codes()) == sorted(want.codes())
    return got


def test_morph_check_catches_corruption_with_the_same_codes(ref):
    c4 = cycle(4).canonical()
    good = quotient_terms(c4)
    assert _checked_codes(ref, c4, good, c4.aut_order()).ok
    # flip one coefficient -> the complete-graph endpoints diverge
    bad = tuple((c if q.m != c4.m else -c, q) for c, q in good)
    r = _checked_codes(ref, c4, bad, c4.aut_order())
    assert not r.ok and "morph-endpoint-complete" in r.codes()
    # wrong automorphism divisor
    assert "morph-divisor" in _checked_codes(ref, c4, good, 3).codes()
    # a coefficient on an edgeless quotient breaks the empty graph
    empty = good + ((1, Pattern(4, [])),)
    assert "morph-endpoint-empty" in _checked_codes(
        ref, c4, empty, c4.aut_order()).codes()
    # a labelled identity holds on the label-cycled complete graphs
    lp = Pattern(3, [(0, 1), (1, 2)], labels=(0, 1, 0)).canonical()
    assert _checked_codes(ref, lp, quotient_terms(lp), lp.aut_order()).ok


def test_morph_neighbours_and_family_equal(ref):
    tri, wedge = clique(3).canonical(), chain(3).canonical()
    assert tmorph.morph_neighbours(wedge) == (tri,)
    assert tmorph.morph_neighbours(tri) == (wedge,)
    fam4, fam5 = tmorph.motif_family(4), tmorph.motif_family(5)
    assert len(fam4) == 6 and len(fam5) == 21
    for k, fam in ((4, fam4), (5, fam5)):
        assert [_key(p) for p in fam] == \
            [_key(p) for p in ref.morph.motif_family(k)]
    for p, d in ((cycle(4), 3), (chain(4), 1), (cycle(5), 1),
                 (Pattern(3, [(0, 1), (1, 2)], labels=(0, 1, 0)), 1)):
        assert [_key(q) for q in tmorph.morph_neighbours(p, distance=d)] \
            == [_key(q) for q in ref.morph.morph_neighbours(_rp(ref, p),
                                                            distance=d)]
    assert len(tmorph.morph_neighbours(cycle(4), distance=3)) == 5


# -- the store ---------------------------------------------------------------------

def test_count_store_disk_roundtrip_and_version_drift(tmp_path):
    store = tmorph.CountStore(str(tmp_path))
    assert store.put("g1", "hom", chain(3), 42.0) == 1
    assert store.put("g1", "hom", chain(3), 42) == 0     # idempotent
    store.put("g1", "inj", cycle(4), 7)
    store.sync()
    fresh = tmorph.CountStore(str(tmp_path))
    assert fresh.get("g1", "hom", chain(3)) == 42
    assert fresh.get("g1", "inj", cycle(4)) == 7
    assert fresh.held_hom_keys("g1") == {f"hom:{pattern_key(chain(3))}"}
    # stamp a future format version: clean miss, counted
    f = fresh._file("g1")
    with open(f) as fh:
        doc = json.load(fh)
    doc["version"] = tmorph.MORPH_FORMAT_VERSION + 1
    with open(f, "w") as fh:
        fh.write(json.dumps(doc))
    drifted = tmorph.CountStore(str(tmp_path))
    assert drifted.get("g1", "hom", chain(3)) is None
    assert drifted.stats["format_misses"] == 1


def test_count_store_sync_failure_is_counted(tmp_path, monkeypatch):
    store = tmorph.CountStore(str(tmp_path))
    store.put("g1", "hom", chain(3), 5)

    def boom(*a, **k):
        raise OSError("read-only store dir")
    monkeypatch.setattr(os, "replace", boom)
    store.sync()                      # must not raise
    assert store.stats["sync_failures"] == 1
    assert store.get("g1", "hom", chain(3)) == 5   # memory tier intact


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_files_are_read_by_the_other_package(ref, tmp_path, writer):
    """The same entries give the same ``counts-<gsig>.json``, byte for
    byte, and each package reads the other's file."""
    rg, tg = ref.graphs["el24"]
    gsig = graph_signature(tg)
    assert ref.gsig(rg) == gsig
    entries = [("hom", chain(3), 42.0), ("inj", cycle(4), 7),
               ("hom", Pattern(3, [(0, 1), (1, 2)], labels=(1, 0, 1)), 11)]
    dirs = {side: tmp_path / side for side in ("port", "reference")}
    stores = {"port": tmorph.CountStore(str(dirs["port"])),
              "reference": ref.morph.CountStore(str(dirs["reference"]))}
    for side, store in stores.items():
        for kind, p, v in entries:
            store.put(gsig, kind, p if side == "port" else _rp(ref, p), v)
        store.sync()
    texts = {side: (dirs[side] / f"counts-{gsig}.json").read_text()
             for side in dirs}
    assert texts["port"] == texts["reference"]
    reader_side = "reference" if writer == "port" else "port"
    reader = (ref.morph.CountStore if reader_side == "reference"
              else tmorph.CountStore)(str(dirs[writer]))
    for kind, p, v in entries:
        q = _rp(ref, p) if reader_side == "reference" else p
        assert reader.get(gsig, kind, q) == int(v)
    assert reader.held_hom_keys(gsig) == stores[writer].held_hom_keys(gsig)


def test_compiled_count_harvests_what_the_reference_harvests(ref, compiles):
    r = compiles("harvest-chain4")
    rg, tg = ref.graphs["er24"]
    gsig = graph_signature(tg)
    assert r["tcount"] == r["rcount"]
    held = r["tstore"]._mem[gsig]
    assert held == r["rstore"]._mem[gsig]
    assert held[f"inj:{pattern_key(chain(4))}"] == \
        r["tcount"] * chain(4).aut_order()
    assert any(k.startswith("hom:") for k in held)
    # scalars held as 0-d tensors (as on the card) harvest the same, in
    # one transfer; vector values are left out
    cp = r["tcp"]
    values = {k: (torch.tensor(v, dtype=torch.float64)
                  if isinstance(v, float) else v)
              for k, v in cp._values.items()}
    some = next(iter(values))
    values["vec"] = torch.zeros(3, dtype=torch.float64)
    fake = types.SimpleNamespace(graph=tg, plan=cp.plan, _values=values)
    assert some in fake._values
    again = tmorph.CountStore()
    assert again.harvest(fake) == len(held)
    assert again._mem[gsig] == held


# -- compile(morph=) ---------------------------------------------------------------

def test_fast_path_serves_a_family_member_without_search(ref, compiles):
    warm = compiles("warm-chain5")
    rg, tg = ref.graphs["er48"]
    assert warm["tstore"]._mem == warm["rstore"]._mem
    rbefore = ref.obs.snapshot()
    tobs.reset()
    rcp = ref.compiler.compile((ref.ns.pattern.chain(3),), rg, cache=False,
                               morph=warm["rstore"])
    tcp = tcompiler.compile((chain(3),), tg, cache=False,
                            morph=warm["tstore"], device="cpu")
    assert tcp.plan.meta.get("morph") is True is rcp.plan.meta.get("morph")
    assert tcp.plan.meta["styles"] == {pattern_key(chain(3)): "morph"}
    assert tcp.plan.to_json() == rcp.plan.to_json()
    assert tobs.get("morph.hits") == 1
    assert counters_moved(ref.obs, rbefore, ("morph.hits",)) == \
        {"morph.hits": {"": 1.0}}
    got = tcp.count(chain(3))
    assert got == rcp.count(ref.ns.pattern.chain(3))
    # every hom came from the store: no contraction ran
    assert tcp.morph_reads and tcp.counter.stats["hom_evals"] == 0
    direct = tcompiler.compile((chain(3),), tg, cache=False, device="cpu",
                               apct=shared_apct("port", tg, TAPCT))
    assert got == direct.count(chain(3))


def test_missing_counts_fall_back_to_search(ref, compiles):
    r = compiles("fallback-cycle4")
    assert r["tcp"].plan.meta.get("morph") is None
    assert r["rcp"].plan.meta.get("morph") is None
    assert r["tmoved"]["morph.missing_compiles"] == {"": 1.0}
    assert r["rmoved"]["morph.missing_compiles"] == {"": 1.0}
    assert r["tcp"].plan.to_json() == r["rcp"].plan.to_json()
    assert r["tcount"] == r["rcount"]
    assert r["tcount"] == CountingEngine(
        ref.graphs["er48"][1], device="cpu").edge_induced(cycle(4))


def test_held_hom_prices_zero_in_costing(ref):
    rg, tg = ref.graphs["er48"]
    tapct = shared_apct("port", tg, TAPCT)
    rapct = shared_apct("ref", rg, ref.APCT)
    cand = tfrontend.direct_candidate(chain(3))
    rcand = ref.frontend.direct_candidate(ref.ns.pattern.chain(3))
    hom_nodes = [nd for nd in cand.nodes if nd.key.startswith("hom:")
                 and not getattr(nd, "free", ())]
    rnodes = {nd.key: nd for nd in rcand.nodes}
    assert hom_nodes
    for node in hom_nodes:
        cost = tcosting.node_cost(node, tapct, tg.n)
        assert cost > 0.0
        assert cost == ref.costing.node_cost(rnodes[node.key], rapct, rg.n)
        assert tcosting.node_cost(node, tapct, tg.n, held={node.key}) == \
            0.0 == ref.costing.node_cost(rnodes[node.key], rapct, rg.n,
                                         held={node.key})
    held = {nd.key for nd in hom_nodes}
    free_cost = tcosting.candidate_cost(cand, tapct, tg.n, {}, held=held)
    assert free_cost < tcosting.candidate_cost(cand, tapct, tg.n, {})
    assert free_cost == ref.costing.candidate_cost(rcand, rapct, rg.n, {},
                                                   held=held)


def test_morph_off_unchanged_and_cache_unpolluted(ref, compiles):
    warm = compiles("warm-chain5")
    tg = ref.graphs["er48"][1]
    apct = shared_apct("port", tg, TAPCT)
    cache = PlanCache()
    p = chain(3)
    baseline = tcompiler.compile((p,), tg, cache=False, device="cpu",
                                 apct=apct).plan.to_json()
    cp = tcompiler.compile((p,), tg, cache=cache, morph=warm["tstore"],
                           device="cpu")
    assert cp.plan.meta.get("morph") is True
    assert plan_key((p,), tg) not in cache
    after = tcompiler.compile((p,), tg, cache=cache, morph=False,
                              device="cpu", apct=apct)
    assert after.plan.meta.get("morph") is None
    assert after.plan.to_json() == baseline
    assert plan_key((p,), tg) in cache


# -- consumers ---------------------------------------------------------------------

def test_mining_engine_threads_morph(ref):
    rg, tg = ref.graphs["eng48"]
    tstore, rstore = tmorph.CountStore(), ref.morph.CountStore()
    teng = tengine.MiningEngine(tg, device="cpu", morph=tstore,
                                apct=shared_apct("port", tg, TAPCT))
    reng = ref.engine.MiningEngine(rg, morph=rstore,
                                   apct=shared_apct("ref", rg, ref.APCT))
    for p in (chain(4), chain(3), clique(3)):
        assert teng.get_pattern_count(p) == \
            reng.get_pattern_count(_rp(ref, p))
    assert teng.compiler_fallbacks == reng.compiler_fallbacks == 0
    assert len(tstore) > 0 and tstore._mem == rstore._mem


def test_fsm_feeds_and_reads_count_store(ref):
    rg, tg = ref.graphs["fsm40"]
    tstore, rstore = tmorph.CountStore(), ref.morph.CountStore()
    got = tfsm.fsm(tg, min_support=2, max_vertices=3, count_store=tstore,
                   device="cpu")
    want = ref.fsm.fsm(rg, min_support=2, max_vertices=3,
                       count_store=rstore)
    assert {_key(p): s for p, s in got.frequent.items()} == \
        {_key(p): s for p, s in want.frequent.items()}
    for field in ("evaluated", "pruned", "levels", "compiled_levels",
                  "fallbacks"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.fallbacks == 0
    assert len(tstore) > 0 and tstore._mem == rstore._mem
