"""Sharded contractions of the port (``repro_torch.distributed.contract``)
vs the reference's single-device engine, on the CPU.

With the adjacency held as row blocks over a ``data_mesh`` of CPU slots,
every hom count and free-hom cut tensor equals the reference's
``CountingEngine`` bit for bit — the sliced route changes where the
einsums run, never what they compute — and the engine never builds the
dense n x n adjacency (``_A_dense`` stays None).  Also here: the
contraction route of a compiled plan (``einsum-sharded``), the guard-free
keep joins on ``dense-f64-sharded-keep``, the phase-split fallback
counters, the plan cache's ``mesh_devices`` check, the costing's devices
term and ``shard_check`` on Contract nodes.  Tolerance is **0**.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import analysis as tanalysis
from repro_torch import api as tapi
from repro_torch import compiler as tcompiler
from repro_torch import obs as tobs
from repro_torch.compiler import PlanCache, config_compatible
from repro_torch.compiler.ir import Plan
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import Pattern, chain, clique, cycle
from repro_torch.distributed import contract as C
from repro_torch.distributed import meshes

from test_torch_reference import port_graph, reference, shared_apct  # noqa: F401,E501

SLOTS = (1, 2, 3, 4, 8)
FREES = ((), (0,), (0, 1))


def _mesh(slots):
    return meshes.data_mesh(slots, device="cpu")


def _patterns(num_labels):
    pats = [cycle(4), chain(4), clique(3), chain(3)]
    if num_labels:
        pats += [Pattern(4, cycle(4).edges, labels=(0, 1, 2, 0)),
                 Pattern(3, ((0, 1), (1, 2)), labels=(2, 0, 1))]
    return pats


@pytest.fixture(scope="module")
def single(reference):
    """(n, labels) -> (port graph, the reference engine's homs and free
    tensors for every pattern and free set), computed once."""
    memo = {}

    def get(n, num_labels):
        if (n, num_labels) not in memo:
            rg = reference.generators.erdos_renyi(n, 6.0, seed=3,
                                                  num_labels=num_labels)
            eng = reference.counting.CountingEngine(rg)
            RP = reference.pattern.Pattern
            out = {}
            for i, p in enumerate(_patterns(num_labels)):
                rp = RP(p.n, sorted(p.edges), p.labels)
                for free in FREES:
                    out[i, free] = (np.asarray(eng.hom_free_tensor(rp, free))
                                    if free else eng.hom(rp))
            memo[n, num_labels] = (port_graph(rg), out)
        return memo[n, num_labels]
    return get


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("n", (96, 97))          # 97: no slot count divides
@pytest.mark.parametrize("num_labels", (0, 3))
def test_sharded_contract_matches_reference(single, n, num_labels, slots):
    tg, want = single(n, num_labels)
    eng = CountingEngine(tg, mesh=_mesh(slots))
    before = tobs.get("contract.trim_gathers")
    for i, p in enumerate(_patterns(num_labels)):
        for free in FREES:
            if free:
                got = eng.hom_free_tensor(p, free)
                assert got.device.type == "cpu"
                assert np.array_equal(got.numpy(), want[i, free]), (i, free)
            else:
                assert eng.hom(p) == want[i, free], i
    if slots > 1:
        assert eng._A_dense is None and eng.contract_shards() == slots
        trims = tobs.get("contract.trim_gathers") - before
        assert (trims > 0) == (n % slots != 0)
    else:
        assert eng.mesh is None          # a one-slot mesh binds nothing


def test_adjacency_and_label_blocks_are_the_padded_rows(reference):
    rg = reference.generators.erdos_renyi(37, 5.0, seed=4, num_labels=3)
    tg = port_graph(rg)
    A = tg.dense_adjacency(np.float64, pad=False)
    L = tg.label_indicators(np.float64, pad=False)
    for slots in (1, 3, 8):
        mesh = _mesh(slots)
        Rp = C.padded_rows(tg.n, mesh)
        assert Rp % slots == 0 and Rp - tg.n < slots
        blocks = C.adjacency_blocks(tg, mesh)
        whole = blocks.whole(torch.device("cpu")).numpy()
        assert whole.shape == (Rp, Rp) == blocks.shape
        assert np.array_equal(whole[:37, :37], A) and not whole[37:].any()
        labels = C.label_blocks(tg, mesh)
        for lab in range(4):                 # 3: outside the alphabet
            u = C.unary_slices(labels, lab, tg.n).whole(
                torch.device("cpu")).numpy()
            want = L[lab] if lab < 3 else np.zeros(37)
            assert np.array_equal(u[:37], want) and not u[37:].any()


@pytest.fixture(scope="module")
def motif_plan(reference):
    rg = reference.generators.erdos_renyi(96, 7.0, seed=2)
    RP = reference.pattern.Pattern
    rpats = [RP(p.n, sorted(p.edges)) for p in motif_patterns(4)]
    rcp = reference.compiler.compile(
        rpats, rg, cache=False, apct=shared_apct("ref", rg, reference.APCT))
    return port_graph(rg), [rcp.count(p) for p in rpats]


@pytest.mark.parametrize("slots", (3, 8))
def test_compiled_plan_contract_route_sharded(motif_plan, slots):
    """compile(mesh=) with a mesh-bound engine: Contract nodes take the
    ``einsum-sharded`` route, counts equal the reference's, and the engine
    never builds the dense adjacency."""
    tg, want = motif_plan
    pats = motif_patterns(4)
    eng = CountingEngine(tg, mesh=_mesh(slots))
    cp = tcompiler.compile(pats, tg, counter=eng, cache=False,
                           mesh=_mesh(slots),
                           apct=shared_apct("port", tg, TAPCT))
    cp.tracer = tobs.Tracer()
    assert [cp.count(p) for p in pats] == want
    routes = {}
    for s in cp.tracer.walk():
        r = s.attrs.get("route")
        if r:
            routes[r] = routes.get(r, 0) + 1
        if r == "einsum-sharded":
            assert (s.attrs["adjacency"], s.attrs["mesh_axes"],
                    s.attrs["num_shards"]) == ("sharded", ["data"], slots)
    assert "einsum-sharded" in routes, routes
    assert "einsum" not in routes and "einsum-free" not in routes, routes
    assert eng._A_dense is None


def test_keep_axis_guard_refusal_routes_sharded(reference):
    """Keep-axis joins that cannot take the kernel route under a mesh
    (here the kernel tier is off) take ``dense-f64-sharded-keep``, not the
    single-device dense route, count no fallback, and the per-vertex
    counts equal the reference's."""
    from repro.api.local import plan_vertex_counts as rvertex
    rg = reference.generators.erdos_renyi(96, 8.0, seed=2)
    rp = reference.pattern.chain(4)
    rcp = reference.compiler.compile(
        rp, rg, cache=False, local=True, cutjoin_kernel=False,
        apct=shared_apct("ref", rg, reference.APCT))
    tg = port_graph(rg)
    mesh = _mesh(8)
    before = tobs.snapshot()
    cp = tcompiler.compile(chain(4), tg,
                           counter=CountingEngine(tg, mesh=mesh),
                           cache=False, mesh=mesh, local=True,
                           cutjoin_kernel=False,
                           apct=shared_apct("port", tg, TAPCT))
    cp.tracer = tobs.Tracer()
    got = tapi.plan_vertex_counts(cp, chain(4))
    assert np.array_equal(got.numpy(), np.asarray(rvertex(rcp, rp)))
    routes = {s.attrs.get("route") for s in cp.tracer.walk()}
    assert "dense-f64-sharded-keep" in routes, routes
    assert "dense-f64-keep" not in routes, routes
    after = tobs.snapshot()
    assert all(after.get(k) == before.get(k) for k in after
               if "shard_fallbacks" in k)


def test_shard_fallback_counters_split_by_phase(reference):
    """One fallback per phase: a fresh compile that serves a count counts
    ``..._compile`` only; re-serving the cached plan counts ``..._execute``
    only."""
    rg = reference.generators.erdos_renyi(6, 2.0, seed=1)
    tg = port_graph(rg)
    mesh, p, cache = _mesh(8), cycle(4), PlanCache()
    apct = shared_apct("port", tg, TAPCT)

    def moved(before):
        return {ph: tobs.get(f"cutjoin.shard_fallbacks_{ph}",
                             reason="small-n") - before[ph]
                for ph in ("compile", "execute")}

    def now():
        return {ph: tobs.get(f"cutjoin.shard_fallbacks_{ph}",
                             reason="small-n")
                for ph in ("compile", "execute")}

    before = now()
    c1 = tcompiler.compile(p, tg, cache=cache, mesh=mesh, apct=apct).count(p)
    assert moved(before) == {"compile": 1, "execute": 0}
    before = now()
    cp2 = tcompiler.compile(p, tg, cache=cache, mesh=mesh)
    assert cp2.from_cache and cp2.count(p) == c1
    assert moved(before) == {"compile": 0, "execute": 1}


def test_plan_cache_mesh_device_compat(reference):
    """A plan compiled for a mesh is not served to a meshless caller, nor
    a meshless plan to a meshed one; the same slot count still hits."""
    rg = reference.generators.erdos_renyi(64, 6.0, seed=1)
    tg = port_graph(rg)
    mesh, p, cache = _mesh(8), cycle(4), PlanCache()
    apct = shared_apct("port", tg, TAPCT)
    a = tcompiler.compile(p, tg, cache=cache, mesh=mesh, apct=apct)
    assert not a.from_cache and a.plan.meta["mesh_devices"] == 8
    b = tcompiler.compile(p, tg, cache=cache, device="cpu", apct=apct)
    assert not b.from_cache and b.plan.meta["mesh_devices"] == 1
    c = tcompiler.compile(p, tg, cache=cache, mesh=mesh, apct=apct)
    assert not c.from_cache
    d = tcompiler.compile(p, tg, cache=cache, mesh=mesh, apct=apct)
    assert d.from_cache
    assert a.count(p) == b.count(p) == d.count(p)


def test_config_compatible_unit():
    plan = Plan()
    plan.meta.update({"budget": 1 << 27, "max_cutjoin_cut": 3,
                      "mesh_devices": 8})
    ok = dict(budget=1 << 27, max_cutjoin_cut=3)
    assert config_compatible(plan, **ok, mesh_devices=8)
    assert not config_compatible(plan, **ok, mesh_devices=1)
    assert not config_compatible(plan, **ok, mesh_devices=4)
    assert not config_compatible(plan, budget=1, max_cutjoin_cut=3,
                                 mesh_devices=8)
    legacy = Plan()
    legacy.meta.update({"budget": 1 << 27, "max_cutjoin_cut": 3})
    assert config_compatible(legacy, **ok, mesh_devices=1)
    assert not config_compatible(legacy, **ok, mesh_devices=8)


def test_contract_cost_devices_term_equals_reference(reference):
    """The costing's per-device term, port vs reference: the same prices
    at 1 and 8 devices, sharding cheaper at n = 512, and the log2(d)
    collective surcharge never waived."""
    from repro.compiler import costing as rcosting
    from repro.compiler.ir import Contract as RContract
    from repro_torch.compiler.costing import _contract_cost
    from repro_torch.compiler.ir import Contract
    from repro_torch.core import homomorphism as TH
    budget = 1 << 27
    for n, deg in ((512, 6.0), (8, 2.0)):
        rg = reference.generators.erdos_renyi(n, deg, seed=1)
        tg = port_graph(rg)
        rapct = shared_apct("ref", rg, reference.APCT)
        tapct = shared_apct("port", tg, TAPCT)
        p = cycle(4)
        rp = reference.pattern.cycle(4)
        node = Contract(key="c", pattern=p, order=TH.greedy_plan(p, ()))
        rnode = RContract(key="c", pattern=rp,
                          order=reference.H.greedy_plan(rp, ()))
        costs = {d: _contract_cost(node, tapct, n, budget, devices=d)
                 for d in (1, 8)}
        assert costs == {d: rcosting._contract_cost(rnode, rapct, n, budget,
                                                    devices=d)
                         for d in (1, 8)}
        if n == 512:
            assert costs[8] < costs[1]
        else:
            assert costs[8] > math.log2(8)


def test_shard_check_covers_contract_nodes(reference):
    rg = reference.generators.erdos_renyi(24, 4.0, seed=13)
    tg = port_graph(rg)
    cp = tcompiler.compile(cycle(4), tg, cache=False, device="cpu",
                           apct=shared_apct("port", tg, TAPCT))
    info = tanalysis.GraphInfo.from_graph(tg)
    res = tanalysis.shard_check(cp.plan, info, 4, budget=1)
    contract_keys = {k for k, n in cp.plan.nodes.items()
                     if type(n).__name__ == "Contract"}
    assert contract_keys
    flagged = {d.node for d in res.warnings
               if d.code == "shard-budget-overflow"}
    assert contract_keys & flagged, (contract_keys, flagged)
    assert not [d for d in tanalysis.shard_check(
        cp.plan, info, 4, budget=1 << 27).warnings
        if d.code == "shard-budget-overflow"]
