"""The partial-embedding slice as a whole: ``compile(..., local=True,
domains=True, use_pallas=True)`` and the reads off it (``local_counts``,
``exists``, ``domains``, ``mini_support``, ``repro_torch.api``) of the
port vs the reference, on the same graphs and pattern sets.

Graphs come from the reference's seeded generators and reach the port as
numpy arrays; each side shares one APCT per graph.  The port runs with
``device="cpu"``, where the keep-axis kernels and the triangle kernel
take their plain versions.  ``small_world(40, 4, 0.2, seed=3)`` is in
the set because on it the cost model anchors chain(6), cycle(6) and the
house on |cut| = 3 joins, so the keep form of the tri join runs through
lowering.  That case compiles without ``domains=True``: with the domain
nodes in the plan, every anchored vector prices cheapest as the flat
Möbius combination those nodes already hold, and no anchored join is
chosen.  Compared per case: the plan JSON as text, ``local_cuts``,
every read, and the route counters.  Tolerance is **0**: exact equality,
since every count is an integer held in f64.
"""
import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch import compiler as tcompiler
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.compiler import lowering as tlowering
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import (Pattern, chain, cycle,
                                      tailed_triangle)
from repro_torch.graph.storage import Graph
from repro_torch.kernels import matreduce as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import KernelError

from test_torch_reference import (counters_moved, port_graph,
                                  reference, shared_apct)  # noqa: F401

HOUSE = Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)])
ROUTE_COUNTERS = ("kernel.calls", "kernel.exact_block",
                  "cutjoin.kernel_fallbacks")
SETS = {
    "sw40": [chain(6), cycle(6), HOUSE],
    "er60": [tailed_triangle(), cycle(4), chain(5)],
    "rich48": [
        Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)], (0, 1, 0, 1)),
        Pattern(4, [(0, 1), (1, 2), (2, 3), (3, 0)], (0, 1, 0, 1)),
        Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 4)], (0, 1, 0, 1, 0)),
    ],
}
CASES = sorted(SETS)
FLAGS = {"sw40": dict(local=True, use_pallas=True),
         "er60": dict(local=True, domains=True, use_pallas=True),
         "rich48": dict(local=True, domains=True, use_pallas=True)}


def _ref_graph(reference, gname):
    G = reference.generators
    return {"sw40": lambda: G.small_world(40, 4, 0.2, seed=3),
            "er60": lambda: G.erdos_renyi(60, 6.0, seed=1),
            "rich48": lambda: G.triangle_rich(48, 4, seed=3,
                                              num_labels=2)}[gname]()


def _reads(cp, pats, arr):
    """Every read of the slice, in one fixed order (so route counters
    compare too); ``arr`` turns a side's vector into a numpy array."""
    out = {"counts": [cp.count(p) for p in pats], "anchored": {},
           "unanchored": {}, "exists": [], "domains": {}, "mini": []}
    for i, p in enumerate(pats):
        for orbit in p.vertex_orbits():
            out["anchored"][i, orbit[0]] = arr(cp.local_counts(p, orbit[0]))
        if cp.has_local(p):
            out["unanchored"][i] = arr(cp.local_counts(p))
        out["exists"].append(cp.exists(p))
        if cp.plan.meta.get("domains"):
            for rep, dom in cp.domains(p).items():
                out["domains"][i, rep] = arr(dom)
            out["mini"].append(cp.mini_support(p))
    return out


@pytest.fixture(scope="module")
def both(reference):
    """case -> both sides' local plans and reads, computed once."""
    memo = {}

    def run(case):
        if case in memo:
            return memo[case]
        pats = SETS[case]
        rg = _ref_graph(reference, case)
        tg = port_graph(rg)
        RP = reference.pattern.Pattern
        rpats = [RP(p.n, sorted(p.edges), p.labels) for p in pats]
        flags = dict(cache=False, **FLAGS[case])

        rbefore = reference.obs.snapshot()
        rcp = reference.compiler.compile(
            rpats, rg, apct=shared_apct("ref", rg, reference.APCT), **flags)
        rreads = _reads(rcp, rpats, np.asarray)
        rsnap = counters_moved(reference.obs, rbefore, ROUTE_COUNTERS)

        tobs.reset()
        tcp = tcompiler.compile(pats, tg, device="cpu",
                                apct=shared_apct("port", tg, TAPCT), **flags)
        treads = _reads(tcp, pats, lambda t: t.numpy())
        tsnap = {k: tobs.snapshot().get(k, {}) for k in ROUTE_COUNTERS}
        memo[case] = dict(pats=pats, rpats=rpats, rg=rg, tg=tg, rcp=rcp,
                          tcp=tcp, rreads=rreads, treads=treads,
                          rsnap=rsnap, tsnap=tsnap)
        return memo[case]

    return run


@pytest.mark.parametrize("case", CASES)
def test_local_plan_json_equal_as_text(both, case):
    r = both(case)
    assert r["tcp"].plan.to_json() == r["rcp"].plan.to_json()
    meta = r["tcp"].plan.meta
    assert meta["local"] and meta["domains"] == ("domains" in FLAGS[case])
    assert meta["local_cuts"] == r["rcp"].plan.meta["local_cuts"]


@pytest.mark.parametrize("case", CASES)
def test_counts_equal(both, case):
    r = both(case)
    assert r["treads"]["counts"] == r["rreads"]["counts"]


@pytest.mark.parametrize("case", CASES)
def test_anchored_local_counts_equal_and_sum_to_inj(both, case):
    r = both(case)
    t, ref = r["treads"]["anchored"], r["rreads"]["anchored"]
    assert t.keys() == ref.keys()
    for (i, rep), vec in t.items():
        assert np.array_equal(vec, ref[i, rep]), (case, i, rep)
        p = r["pats"][i]
        assert vec.sum() == r["treads"]["counts"][i] * p.aut_order()


@pytest.mark.parametrize("case", CASES)
def test_unanchored_local_counts_equal(both, case):
    r = both(case)
    t, ref = r["treads"]["unanchored"], r["rreads"]["unanchored"]
    assert t.keys() == ref.keys() and t
    for i, tensor in t.items():
        assert np.array_equal(tensor, ref[i]), (case, i)
        p = r["pats"][i]
        assert tensor.sum() == r["treads"]["counts"][i] * p.aut_order()


@pytest.mark.parametrize("case", CASES)
def test_exists_domains_and_mini_support_equal(both, case):
    r = both(case)
    t, ref = r["treads"], r["rreads"]
    assert t["exists"] == ref["exists"]
    assert t["mini"] == ref["mini"]
    assert t["domains"].keys() == ref["domains"].keys()
    for key, dom in t["domains"].items():
        assert np.array_equal(dom, ref["domains"][key]), (case, key)


@pytest.mark.parametrize("case", CASES)
def test_route_counters_equal(both, case):
    r = both(case)
    assert r["tsnap"] == r["rsnap"]
    calls = r["tsnap"]["kernel.calls"]
    assert calls.get("cut=2,op=cutjoin_reduce_keep", 0) + \
        calls.get("cut=3,op=cutjoin_reduce3_keep", 0) >= 1


def test_keep_form_of_the_tri_join_runs_through_lowering(both):
    r = both("sw40")
    keep3 = [j for j in r["tcp"].join_log
             if j["cut"] == 3 and j["keep"] is not None
             and len(j["keep"]) == 1]
    assert keep3 and {j["route"] for j in keep3} == {"kernel-keep"}
    assert r["tsnap"]["kernel.calls"]["cut=3,op=cutjoin_reduce3_keep"] == \
        len(keep3)


@pytest.mark.parametrize("case", CASES)
def test_vertex_counts_equal_the_reference_weighting(both, case):
    from repro.api import local as rlocal
    r = both(case)
    apct = shared_apct("port", r["tg"], TAPCT)
    for p, rp, count in zip(r["pats"], r["rpats"], r["treads"]["counts"]):
        want = rlocal.plan_vertex_counts(r["rcp"], rp)
        got = tapi.vertex_counts(p, r["tg"], cache=False, apct=apct,
                                 device="cpu")
        assert np.array_equal(got.numpy(), want)
        assert got.sum().item() == p.n * count
        top = tapi.vertex_counts(p, r["tg"], cache=False, apct=apct,
                                 device="cpu", top_k=5)
        assert top == rlocal.top_vertices(want, 5)


@pytest.mark.parametrize("case", CASES)
def test_dense_route_equals_kernel_route_for_every_read(both, case):
    r = both(case)
    dense = tlowering.lower(r["tcp"].plan, r["tg"], device="cpu",
                            cutjoin_kernel=False)
    got = _reads(dense, r["pats"], lambda t: t.numpy())
    for part in ("anchored", "unanchored", "domains"):
        for key, vec in got[part].items():
            assert np.array_equal(vec, r["treads"][part][key]), (part, key)
    assert got["counts"] == r["treads"]["counts"]
    assert all(j["route"] in ("dense-f64", "dense-f64-keep", "dense-product")
               for j in dense.join_log)


@pytest.mark.parametrize("case", ["sw40", "rich48"])
def test_anchored_vectors_equal_inj_free(both, case):
    r = both(case)
    eng = CountingEngine(r["tg"], device="cpu")
    for (i, rep), vec in r["treads"]["anchored"].items():
        assert np.array_equal(vec, eng.inj_free(r["pats"][i], rep))


def test_local_plans_load_across_packages(both):
    r = both("sw40")
    plan = interop.plan_from_json(r["rcp"].plan.to_json())
    cp = tlowering.lower(plan, r["tg"], verify=True, device="cpu")
    got = _reads(cp, r["pats"], lambda t: t.numpy())
    for key, vec in got["anchored"].items():
        assert np.array_equal(vec, r["rreads"]["anchored"][key])
    from repro.compiler import lowering as rlowering
    from repro.compiler.ir import Plan as RPlan
    rcp = rlowering.lower(RPlan.from_json(r["tcp"].plan.to_json()),
                          r["rg"], verify=True)
    for i, (rp, p) in enumerate(zip(r["rpats"], r["pats"])):
        assert np.array_equal(rcp.local_counts(rp),
                              r["treads"]["unanchored"][i])


def test_cache_union_of_domains_and_local_does_not_ping_pong(both):
    r = both("rich48")
    pats, g = r["pats"][:1], r["tg"]
    apct = shared_apct("port", g, TAPCT)
    cache = tcompiler.PlanCache()
    kw = dict(cache=cache, device="cpu", apct=apct)
    cp1 = tcompiler.compile(pats, g, domains=True, **kw)
    cp2 = tcompiler.compile(pats, g, local=True, **kw)
    assert not cp2.from_cache                  # first local: recompile ...
    assert cp2.plan.meta["domains"] and cp2.plan.meta["local"]  # ... union
    cp3 = tcompiler.compile(pats, g, domains=True, **kw)
    cp4 = tcompiler.compile(pats, g, local=True, **kw)
    cp5 = tcompiler.compile(pats, g, **kw)     # a plain request hits too
    assert cp3.from_cache and cp4.from_cache and cp5.from_cache
    assert cp3.mini_support(pats[0]) == cp1.mini_support(pats[0]) == \
        r["treads"]["mini"][0]


def test_local_counts_returns_a_copy(both):
    r = both("er60")
    cp, p = r["tcp"], r["pats"][2]
    a = cp.local_counts(p, 0)
    a *= 0.0                                   # a hostile caller
    b = cp.local_counts(p, 0)
    assert np.array_equal(b.numpy(), r["treads"]["anchored"][2, 0])
    assert not torch.equal(a, b)
    d = cp.domains(p)[0]
    d *= 0.0
    assert np.array_equal(cp.domains(p)[0].numpy(),
                          r["treads"]["domains"][2, 0])


def test_api_local_counts_equals_the_plan_read(both):
    r = both("er60")
    p, g = r["pats"][1], r["tg"]
    apct = shared_apct("port", g, TAPCT)
    lc = tapi.local_counts(p, g, anchor=0, cache=False, apct=apct,
                           device="cpu")
    assert lc.axes == (0,) and lc.style == "local"
    assert np.array_equal(lc.counts.numpy(), r["treads"]["anchored"][1, 0])
    assert lc.total() == r["treads"]["counts"][1] * p.aut_order()
    full = tapi.local_counts(p, g, cache=False, apct=apct, device="cpu")
    assert full.axes == tuple(r["tcp"].plan.meta["local_cuts"][
        tcompiler.local_key(p)])
    assert np.array_equal(full.counts.numpy(), r["treads"]["unanchored"][1])
    # the direct assembly (no compiler) gives the same vector
    direct = tapi.local_counts(p, g, anchor=0, use_compiler=False,
                               device="cpu")
    assert torch.equal(direct.counts, lc.counts)
    assert tapi.exists(p, g, cache=False, apct=apct, device="cpu") is True


def test_pattern_domains_equal_inj_free(both):
    r = both("rich48")
    eng = CountingEngine(r["tg"], device="cpu")
    p = r["pats"][0]
    doms = tapi.pattern_domains(eng, p)
    assert set(doms) == {o[0] for o in p.vertex_orbits()}
    for rep, vec in doms.items():
        assert np.array_equal(vec.numpy(), eng.inj_free(p, rep))


def test_unanchored_read_of_a_clique_raises_value_error():
    from repro_torch.core.pattern import clique
    g = Graph(6, [(0, 1), (1, 2), (0, 2), (2, 3)])
    kw = dict(cache=False, device="cpu", apct=shared_apct("port", g, TAPCT))
    with pytest.raises(ValueError, match="no eligible cutting set"):
        tapi.local_counts(clique(3), g, **kw)
    lc = tapi.local_counts(clique(3), g, anchor=0, **kw)
    assert lc.counts.tolist() == [2.0, 2.0, 2.0, 0.0, 0.0, 0.0]


def test_exists_exits_early_on_a_zero_factor():
    """A graph with no triangles: a pattern containing one dies at its
    triangle factor, before the join or shrinkage corrections."""
    g = Graph(12, [(i, (i + 1) % 12) for i in range(12)])   # 12-cycle
    p = tailed_triangle()
    kw = dict(cache=False, device="cpu", apct=shared_apct("port", g, TAPCT))
    cp = tcompiler.compile((p,), g, local=True, **kw)
    assert cp.exists(p) is False
    assert cp.stats["exists_early_exits"] == 1
    assert tapi.exists(p, g, **kw) is False
    assert tapi.exists(chain(4), g, **kw) is True


# -- a kernel error is never hidden by a fallback ------------------------------------

def _raise_kernel_error(*args, **kwargs):
    raise KernelError("cutjoin_pair_keep launch failed: CUDA error 98")


@pytest.mark.parametrize("entry", ["local_counts", "vertex_counts",
                                   "pattern_domains", "exists_direct"])
def test_kernel_error_propagates_through_the_api(monkeypatch, entry):
    monkeypatch.setattr(tops, "cutjoin_reduce_keep", _raise_kernel_error)
    monkeypatch.setattr(tops, "cutjoin_reduce3_keep", _raise_kernel_error)
    from repro_torch.graph.generators import erdos_renyi
    g = erdos_renyi(30, 4.0, seed=1)
    p = cycle(5)                  # every cut holding an anchor has 2+ vertices
    kw = dict(cache=False, device="cpu", apct=shared_apct("port", g, TAPCT))
    tobs.reset()
    with pytest.raises(KernelError):
        if entry == "local_counts":
            tapi.local_counts(p, g, anchor=1, **kw)
        elif entry == "vertex_counts":
            tapi.vertex_counts(p, g, **kw)
        elif entry == "pattern_domains":
            tapi.pattern_domains(CountingEngine(g, device="cpu"), p)
        else:
            tapi.local_counts(p, g, anchor=1, use_compiler=False,
                              device="cpu")
    assert "api.compile_fallbacks" not in tobs.snapshot()


def test_other_compile_failures_still_fall_back(monkeypatch):
    from repro_torch.api import local as tlocal
    from repro_torch.graph.generators import erdos_renyi

    def broken(*args, **kwargs):
        raise RuntimeError("compiler unavailable")

    g = erdos_renyi(30, 4.0, seed=1)
    p = chain(4)
    eng = CountingEngine(g, device="cpu")
    monkeypatch.setattr(tlocal, "_compile_local", broken)
    tobs.reset()
    lc = tapi.local_counts(p, g, anchor=1, counter=eng, cache=False)
    assert np.array_equal(lc.counts.numpy(), eng.inj_free(p, 1))
    vc = tapi.vertex_counts(p, g, counter=eng, cache=False)
    assert vc.sum().item() == p.n * eng.edge_induced(p)
    assert tapi.exists(p, g, counter=eng, cache=False) is True
    assert tobs.snapshot()["api.compile_fallbacks"] == {
        "entry=exists": 1.0, "entry=local_counts": 1.0,
        "entry=vertex_counts": 1.0}


# -- every cutting set, reduce-free and anchored, through lowering ------------------

@pytest.mark.parametrize("pattern", [chain(5), cycle(5), HOUSE],
                         ids=["chain5", "cycle5", "house"])
def test_every_cutting_set_local_tensor_equals_reference(reference, pattern):
    """Each eligible cutting set of the pattern (|cut| up to 3) as a
    standalone local fragment, reduce-free and anchored at each cut
    vertex, lowered on both sides: entrywise equal, and each sums to
    inj(p).  This reaches the 3-D reduce-free tensor (with its three
    collision planes zeroed) and the keep form of the tri join."""
    from repro.compiler import frontend as rfrontend
    from repro.compiler import lowering as rlowering
    from repro.compiler.ir import Plan as RPlan
    from repro_torch.compiler import frontend as tfrontend
    from repro_torch.compiler.ir import Plan as TPlan
    from repro_torch.core.decomposition import cutting_sets
    rg = reference.generators.erdos_renyi(20, 4.0, seed=1)
    tg = port_graph(rg)
    rp = reference.pattern.Pattern(pattern.n, sorted(pattern.edges))
    reng = reference.counting.CountingEngine(rg)
    teng = CountingEngine(tg, device="cpu")
    inj = teng.inj(pattern)
    seen3 = 0
    for cut in sorted(cutting_sets(pattern), key=sorted):
        for anchor in (None, *sorted(cut)):
            tc = tfrontend.local_candidate(pattern, cut, graph_n=tg.n,
                                           anchor=anchor, max_cut=3)
            rc = rfrontend.local_candidate(rp, frozenset(cut), graph_n=rg.n,
                                           anchor=anchor, max_cut=3)
            if tc is None:
                assert rc is None
                continue
            tplan, rplan = TPlan(), RPlan()
            for node in tc.nodes:
                tplan.add(node)
            for node in rc.nodes:
                rplan.add(node)
            assert tplan.to_json() == rplan.to_json()
            got = tlowering.lower(tplan, tg, counter=teng).value(tc.out_key)
            want = rlowering.lower(rplan, rg, counter=reng).value(rc.out_key)
            assert np.array_equal(got.numpy(), np.asarray(want)), \
                (sorted(cut), anchor)
            assert got.sum().item() == inj
            seen3 += len(cut) == 3
    assert seen3


# -- the guard's refusals on a skewed graph; the f64 routes on the card ---------------

# the port's join_log route -> the reference's span annotation
REF_ROUTE = {"kernel": "kernel", "kernel-keep": "kernel-keep",
             "dense-f64": "xla-dense", "dense-f64-keep": "xla-keep",
             "dense-product": "dense-product"}
HUB_PATTERNS = [tailed_triangle(), cycle(4), chain(5)]


def _hub_edges(n=300, hubs=10, p=0.1, seed=0):
    """A skewed graph: ``hubs`` vertices joined to every other, the rest
    an Erdős–Rényi graph of density ``p``.  Hub-to-hub walk counts make
    the f32 guard refuse an anchored |cut| = 2 join and a |cut| = 1 join
    here (Π max|F_i| · 8 > 2^24)."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pick = (iu < hubs) | (rng.random(iu.shape) < p)
    return np.stack([iu[pick], ju[pick]], axis=1)


@pytest.fixture(scope="module")
def hub(reference):
    """Both sides' local plans on the hub graph, every anchored vector
    read, the reference traced (its spans carry each join's route)."""
    from repro.graph.storage import Graph as RGraph
    rg = RGraph(300, _hub_edges())
    tg = port_graph(rg)
    RP = reference.pattern.Pattern
    rpats = [RP(p.n, sorted(p.edges)) for p in HUB_PATTERNS]
    rbefore = reference.obs.snapshot()
    rcp = reference.compiler.compile(
        rpats, rg, cache=False, local=True,
        apct=shared_apct("ref", rg, reference.APCT))
    rcp.tracer = reference.obs.Tracer()
    rreads = _reads(rcp, rpats, np.asarray)
    rsnap = counters_moved(reference.obs, rbefore, ROUTE_COUNTERS)
    tobs.reset()
    tcp = tcompiler.compile(HUB_PATTERNS, tg, cache=False, local=True,
                            device="cpu", apct=shared_apct("port", tg, TAPCT))
    treads = _reads(tcp, HUB_PATTERNS, lambda t: t.numpy())
    tsnap = {k: tobs.snapshot().get(k, {}) for k in ROUTE_COUNTERS}
    ref_routes = {s.name: s.attrs["route"] for s in rcp.tracer.walk()
                  if s.kind in ("CutJoin", "LocalCount")
                  and "route" in s.attrs}
    return dict(rg=rg, tg=tg, rcp=rcp, tcp=tcp, rreads=rreads,
                treads=treads, rsnap=rsnap, tsnap=tsnap,
                ref_routes=ref_routes)


def test_guard_refusals_on_a_skewed_graph_keep_the_reference_routes(hub):
    """On the CPU a join the f32 guard refuses keeps the reference's
    dense route, label and counters: the f64 instances are for the card.
    Here the guard refuses an anchored |cut| = 2 join and a |cut| = 1
    join, and ``exact_f64`` admits both — on the card they take
    ``kernel-keep-f64`` and ``kernel-f64``."""
    tcp = hub["tcp"]
    assert tcp.plan.to_json() == hub["rcp"].plan.to_json()
    assert hub["treads"]["counts"] == hub["rreads"]["counts"]
    for key, vec in hub["treads"]["anchored"].items():
        assert np.array_equal(vec, hub["rreads"]["anchored"][key]), key
    assert hub["tsnap"] == hub["rsnap"]
    routes = {j["node"]: j["route"] for j in tcp.join_log}
    assert {k: REF_ROUTE[r] for k, r in routes.items()} == hub["ref_routes"]
    refused = [j for j in tcp.join_log if j["guard"] == "scanned"
               and j["block"] is None]
    assert {(j["cut"], j["route"]) for j in refused} >= \
        {(1, "dense-f64"), (2, "dense-f64-keep")}
    for j in refused:
        if j["cut"] != (1 if j["keep"] is None else 2):
            continue                 # K2's refusals: not routed to f64
        node = tcp.plan.nodes[j["node"]]
        Ms, _ = tcp._join_factors(node)
        maxes = [M.abs().max().item() for M in Ms]
        cells = Ms[0].shape[0] if j["cut"] == 1 else \
            Ms[0].shape[1 - j["keep"][0]]
        assert tops.cutjoin_exact_block(Ms, maxes=maxes) is None
        assert tops.cutjoin_exact_f64(maxes, cells), j["node"]


@pytest.mark.parametrize("kind", ("cut1", "keep2"))
@pytest.mark.parametrize("case", ("granted", "f64", "dense", "cpu"))
def test_route_of_a_join_by_guard_and_device(hub, monkeypatch, kind, case):
    """Lowering's routing with factors that claim to lie on the card:
    guard granted -> the f32 entry; guard refused and ``exact_f64``
    admitted -> the f64 entry (``kernel-f64`` / ``kernel-keep-f64``,
    counted in ``cutjoin.kernel_f64``); both refused -> the dense route,
    counted in ``cutjoin.kernel_fallbacks``.  On the CPU a refusal goes
    to the dense route whatever ``exact_f64`` says."""
    tcp = hub["tcp"]
    key = next(j["node"] for j in tcp.join_log
               if j["guard"] == "scanned" and j["block"] is None
               and j["cut"] == (1 if kind == "cut1" else 2)
               and (kind == "cut1") == (j["keep"] is None))
    node = tcp.plan.nodes[key]
    want = tcp.value(key)

    class OnCard(torch.Tensor):
        is_cuda = True

    cp = tlowering.lower(tcp.plan, hub["tg"], counter=tcp.counter,
                         device="cpu")
    real = cp._join_factors
    on_card = case != "cpu"
    monkeypatch.setattr(cp, "_join_factors", lambda nd: (
        [M.as_subclass(OnCard) if on_card else M for M in real(nd)[0]],
        real(nd)[1]))
    guard = {"granted": (8, [1.0, 1.0]), "f64": (None, [2.0 ** 20] * 2),
             "dense": (None, [2.0 ** 40] * 2),
             "cpu": (None, [2.0 ** 20] * 2)}[case]
    monkeypatch.setattr(cp, "_guard_block",
                        lambda nd, Ms, axes: (guard[0], "scanned", guard[1]))
    called = []

    def entry(name):
        def run(Ms, **kw):           # the exact join, wherever it was sent
            called.append(name)
            Ms = [M.as_subclass(torch.Tensor) for M in Ms]
            if kind == "cut1":
                return tmr.prod_reduce_f64_plain(Ms)
            return tmr.prod_reduce_keep_f64_plain(Ms, keep=kw["keep"])
        return run

    for name in ("cutjoin_reduce", "cutjoin_reduce_f64",
                 "cutjoin_reduce_keep", "cutjoin_reduce_keep_f64"):
        monkeypatch.setattr(tops, name, entry(name))
    tobs.reset()
    got = cp.value(key)
    route = cp.join_log[-1]["route"]
    snap = tobs.snapshot()
    f32 = "cutjoin_reduce" if kind == "cut1" else "cutjoin_reduce_keep"
    expect = {"granted": ([f32], "kernel" if kind == "cut1"
                          else "kernel-keep"),
              "f64": ([f32 + "_f64"], "kernel-f64" if kind == "cut1"
                      else "kernel-keep-f64"),
              "dense": ([], "dense-f64" if kind == "cut1"
                        else "dense-f64-keep"),
              "cpu": ([], "dense-f64" if kind == "cut1"
                      else "dense-f64-keep")}[case]
    assert (called, route) == expect
    assert ("cutjoin.kernel_f64" in snap) == (case == "f64")
    assert ("cutjoin.kernel_fallbacks" in snap) == (case in ("dense", "cpu"))
    if kind == "cut1":
        assert got == want
    else:
        assert torch.equal(got.as_subclass(torch.Tensor), want)
