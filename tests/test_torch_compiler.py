"""The slice as a whole: ``compile(patterns, graph).count(p)`` of the port
vs the reference, on the same graph and the same pattern sets.

Graphs come from the reference's seeded generators and reach the port as
numpy arrays; each side builds one APCT per graph (same seed, same
numbers) and shares it across its compiles.  The port runs with
``device="cpu"``.  Compared per pattern set: the plan JSON **as text**,
counts, ``meta["styles"]`` / ``meta["cuts"]``, and the route counters
``kernel.calls`` / ``kernel.exact_block`` / ``cutjoin.kernel_fallbacks``.
Tolerance is **0**: exact equality, since every count is an integer held
in f64.
"""
import numpy as np
import pytest
import torch

from repro_torch import compiler as tcompiler
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.analysis import PlanVerifyError
from repro_torch.compiler import lowering as tlowering
from repro_torch.compiler.ir import CutJoin, Plan
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import (CountingEngine,
                                       brute_force_edge_induced)
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import (Pattern, chain, cycle,
                                      tailed_triangle)

from test_torch_reference import (counters_moved, port_graph,
                                  reference, shared_apct)  # noqa: F401

HOUSE = Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)])
ROUTE_COUNTERS = ("kernel.calls", "kernel.exact_block",
                  "cutjoin.kernel_fallbacks")

# (graph name, pattern set name) -> patterns; labelled sets go to the
# labelled graph
UNLABELLED_SETS = {
    "canonical3": [tailed_triangle(), cycle(4), chain(5)],
    "house": [HOUSE],
    "motifs4": list(motif_patterns(4)),
}
LABELLED_SETS = {
    "canonical3": [
        Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)], (0, 1, 0, 1)),
        Pattern(4, [(0, 1), (1, 2), (2, 3), (3, 0)], (0, 1, 0, 1)),
        Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 4)], (0, 1, 0, 1, 0)),
    ],
    "house": [Pattern(5, HOUSE.edges, (0, 0, 1, 1, 0))],
}
CASES = [("er60", name) for name in UNLABELLED_SETS] + \
        [("rich48", name) for name in LABELLED_SETS]


def _patterns(case):
    gname, sname = case
    return (UNLABELLED_SETS if gname == "er60" else LABELLED_SETS)[sname]


def _ref_graph(reference, gname):
    G = reference.generators
    if gname == "er60":
        return G.erdos_renyi(60, 6.0, seed=1)
    return G.triangle_rich(48, 4, seed=3, num_labels=2)


def _route_counters(snapshot):
    return {k: snapshot.get(k, {}) for k in ROUTE_COUNTERS}


@pytest.fixture(scope="module")
def both(reference):
    """case -> results of compiling and counting on both sides, computed
    once per case for the whole module."""
    memo = {}

    def run(case):
        if case in memo:
            return memo[case]
        gname, _ = case
        pats = _patterns(case)
        rg = _ref_graph(reference, gname)
        tg = port_graph(rg)
        RP = reference.pattern.Pattern
        rpats = [RP(p.n, sorted(p.edges), p.labels) for p in pats]

        rbefore = reference.obs.snapshot()
        rcp = reference.compiler.compile(
            rpats, rg, cache=False,
            apct=shared_apct("ref", rg, reference.APCT))
        rcounts = [rcp.count(p) for p in rpats]
        rsnap = counters_moved(reference.obs, rbefore, ROUTE_COUNTERS)

        tobs.reset()
        tcp = tcompiler.compile(pats, tg, cache=False, device="cpu",
                                apct=shared_apct("port", tg, TAPCT))
        tcounts = [tcp.count(p) for p in pats]
        tsnap = _route_counters(tobs.snapshot())
        memo[case] = dict(pats=pats, rg=rg, tg=tg, rcp=rcp, tcp=tcp,
                          rcounts=rcounts, tcounts=tcounts, rsnap=rsnap,
                          tsnap=tsnap)
        return memo[case]

    return run


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_plan_json_equal_as_text(both, case):
    r = both(case)
    assert r["tcp"].plan.to_json() == r["rcp"].plan.to_json()


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_counts_styles_and_cuts_equal(both, case):
    r = both(case)
    assert r["tcounts"] == r["rcounts"]
    assert all(c == round(c) for c in r["tcounts"])
    assert r["tcp"].plan.meta["styles"] == r["rcp"].plan.meta["styles"]
    assert r["tcp"].plan.meta["cuts"] == r["rcp"].plan.meta["cuts"]
    assert r["tcp"].counts() == r["rcp"].counts()


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_route_counters_equal(both, case):
    r = both(case)
    assert r["tsnap"] == r["rsnap"]
    if case[1] == "canonical3" and case[0] == "er60":
        assert r["tsnap"]["kernel.calls"] == {
            "cut=1,op=cutjoin_reduce": 1.0, "cut=2,op=cutjoin_reduce": 1.0,
            "cut=3,op=cutjoin_reduce3": 1.0}
        assert r["tsnap"]["kernel.exact_block"] == \
            {"outcome=precertified": 3.0}


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_dense_route_equals_kernel_route(both, case):
    r = both(case)
    tobs.reset()
    dense = tcompiler.compile(r["pats"], r["tg"], cache=False, device="cpu",
                              cutjoin_kernel=False,
                              apct=shared_apct("port", r["tg"], TAPCT))
    assert [dense.count(p) for p in r["pats"]] == r["tcounts"]
    assert "kernel.calls" not in tobs.snapshot()
    assert all(j["route"] == "dense-f64" for j in dense.join_log)
    assert dense.plan.to_json() == r["tcp"].plan.to_json()


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_reference_serialised_plan_loads_and_counts_the_same(both, case):
    r = both(case)
    plan = interop.plan_from_json(r["rcp"].plan.to_json())
    assert isinstance(plan, Plan)
    cp = tlowering.lower(plan, r["tg"], verify=True, device="cpu")
    assert [cp.count(p) for p in r["pats"]] == r["rcounts"]
    # and the other way round: the reference loads the port's plan
    from repro.compiler import lowering as rlowering
    from repro.compiler.ir import Plan as RPlan
    rplan = RPlan.from_json(r["tcp"].plan.to_json())
    rcp = rlowering.lower(rplan, r["rg"], verify=True)
    assert rcp.counts() == r["tcp"].counts()


def test_counts_match_brute_force_on_a_small_graph():
    from repro_torch.graph.generators import erdos_renyi
    g = erdos_renyi(26, 4.0, seed=4)
    pats = [tailed_triangle(), cycle(4), chain(5), HOUSE]
    cp = tcompiler.compile(pats, g, cache=False, device="cpu")
    for p in pats:
        assert cp.count(p) == brute_force_edge_induced(g, p)
        assert cp.executable(p)() == cp.count(p)


def test_guard_refusal_takes_the_counted_dense_route(both):
    """Factors too large for any f32 chunk: the join is refused, counted
    by ``cutjoin.kernel_fallbacks`` and still exact."""
    r = both(("er60", "canonical3"))
    cp = tlowering.lower(r["tcp"].plan, r["tg"], device="cpu")
    key = next(k for k, n in cp.plan.nodes.items()
               if isinstance(n, CutJoin) and n.cut_size == 2)
    cp._precert = {}                       # no static certificate: scan
    dense = tlowering.lower(r["tcp"].plan, r["tg"], device="cpu",
                            cutjoin_kernel=False)
    refs = {ref for terms in cp.plan.nodes[key].factors for _, ref in terms}
    for ref in refs:
        cp._values[ref] = dense._values[ref] = \
            cp.value(ref) * float(1 << 13)
    tobs.reset()
    got = cp.value(key)
    snap = tobs.snapshot()
    assert snap["kernel.exact_block"] == {"outcome=refused": 1.0}
    assert snap["cutjoin.kernel_fallbacks"] == {"cut=2": 1.0}
    assert cp.join_log[-1]["route"] == "dense-f64"
    assert cp.join_log[-1]["guard"] == "scanned"
    assert got == dense.value(key) and got > r["tcp"].value(key)


def test_scanned_guard_grants_and_matches_precertified(both):
    r = both(("er60", "canonical3"))
    cp = tlowering.lower(r["tcp"].plan, r["tg"], device="cpu")
    cp._precert = {}
    tobs.reset()
    assert [cp.count(p) for p in r["pats"]] == r["tcounts"]
    assert tobs.snapshot()["kernel.exact_block"] == {"outcome=granted": 3.0}
    assert {j["guard"] for j in cp.join_log} == {"scanned"}


def test_cut_tensors_stay_torch_tensors_on_the_plan_device(both):
    r = both(("er60", "canonical3"))
    cp = r["tcp"]
    tensors = [v for v in cp._values.values() if isinstance(v, torch.Tensor)]
    assert tensors and all(t.dtype == torch.float64
                           and t.device == cp.device for t in tensors)
    assert not any(isinstance(v, np.ndarray) for v in cp._values.values())


def test_second_counts_is_served_from_the_memo(both):
    r = both(("er60", "house"))
    cp = r["tcp"]
    first = cp.counts()
    evals = cp.stats["node_evals"]
    assert cp.counts() == first
    assert cp.stats["node_evals"] == evals


def test_cache_hit_on_second_compile(both):
    r = both(("er60", "canonical3"))
    cache = tcompiler.PlanCache()
    apct = shared_apct("port", r["tg"], TAPCT)
    a = tcompiler.compile(r["pats"], r["tg"], cache=cache, device="cpu",
                          apct=apct)
    b = tcompiler.compile(r["pats"], r["tg"], cache=cache, device="cpu",
                          apct=apct)
    assert not a.from_cache and b.from_cache
    assert (cache.hits, cache.misses) == (1, 1)
    assert b.plan.to_json() == a.plan.to_json()
    assert b.counts() == a.counts()
    # a different budget is a different configuration: recompile
    c = tcompiler.compile(r["pats"], r["tg"], cache=cache, device="cpu",
                          apct=apct, budget=1 << 20)
    assert not c.from_cache


def test_default_cache_is_the_process_cache():
    assert tcompiler.default_cache() is tcompiler.default_cache()
    assert isinstance(tcompiler.default_cache(), tcompiler.PlanCache)


def test_lower_verify_rejects_a_corrupted_plan(both):
    r = both(("er60", "house"))
    plan = Plan.from_json(r["tcp"].plan.to_json())
    plan.outputs[next(iter(plan.outputs))] = "hom:no-such-node"
    with pytest.raises(PlanVerifyError):
        tlowering.lower(plan, r["tg"], verify=True, device="cpu")


@pytest.mark.parametrize("kwargs", [
    {"mesh": 2}, {"morph": True},
], ids=lambda kw: next(iter(kw)))
def test_unported_features_raise_and_name_their_roadmap_item(both, kwargs):
    """Both features are ported now and count as the reference does:
    ``mesh=`` (two CPU slots; ``plan.meta`` records them) and ``morph=``
    (through the process store)."""
    r = both(("er60", "house"))
    if "mesh" in kwargs:
        from repro_torch.distributed import meshes
        kwargs = {"mesh": meshes.data_mesh(kwargs["mesh"], device="cpu")}
    cp = tcompiler.compile(r["pats"], r["tg"], cache=False, device="cpu",
                           apct=shared_apct("port", r["tg"], TAPCT),
                           **kwargs)
    assert [cp.count(p) for p in r["pats"]] == r["rcounts"]
    if "morph" in kwargs:
        assert cp.count_store is tcompiler.default_store()
    else:
        assert cp.plan.meta["mesh_devices"] == 2


def test_plan_meta_keeps_the_shared_fields(both):
    meta = both(("er60", "canonical3"))["tcp"].plan.meta
    assert (meta["mesh_devices"], meta["domains"], meta["local"]) == \
        (1, False, False)


def test_counter_supplied_engine_binds_device_and_budget(both):
    r = both(("er60", "house"))
    eng = CountingEngine(r["tg"], budget=1 << 22, device="cpu")
    cp = tcompiler.compile(r["pats"], r["tg"], cache=False, counter=eng,
                           apct=shared_apct("port", r["tg"], TAPCT))
    assert cp.counter is eng and cp.device.type == "cpu"
    assert cp.plan.meta["budget"] == 1 << 22
    assert [cp.count(p) for p in r["pats"]] == r["tcounts"]
