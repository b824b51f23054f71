"""The mesh-execution tier of the port (``repro_torch.distributed.cutjoin``)
vs the reference's single-device joins and plans, on the CPU.

Every sharded join (vector, pair, tri on each ``tri_route``, both keep
forms, the dense f64 join and its keep form) runs on a ``data_mesh`` of
1, 2, 3, 4 and 8 CPU slots, with n divisible and not divisible by the
slot count and by the chunk, and is held against the reference's
single-device join on the same seeded factors (its interpret-mode kernels
through ``repro.kernels.ops``, its dense oracles from ``repro.compiler.
lowering``), each computed once per module.  Plans compiled with a mesh
are held to the reference's counts and anchored vectors; the small-graph
fallback, a guard refusal under a mesh, the batcher's fan-out,
``MeshExecutor.join_batch`` and ``shard_check`` complete the set.
Tolerance is **0**: exact equality, since every quantity is an integer
held in f64 and every kernel case stays within the ``exact_block`` guard.
"""
import numpy as np
import pytest
import torch

from repro_torch import analysis as tanalysis
from repro_torch import compiler as tcompiler
from repro_torch import obs as tobs
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.compiler import lowering as tlowering
from repro_torch.core.pattern import Pattern, chain, cycle
from repro_torch.distributed import contract as C
from repro_torch.distributed import cutjoin as dcj
from repro_torch.distributed import meshes
from repro_torch.graph.storage import Graph as TGraph
from repro_torch.kernels import matreduce as tmr
from repro_torch.kernels import ops as tops
from repro_torch.serve.batching import PatternQueryBatcher, PatternRequest

from test_torch_kernels import _factors, _hi, _t
from test_torch_local import HUB_PATTERNS, _hub_edges, _reads
from test_torch_reference import port_graph, reference, shared_apct  # noqa: F401,E501

SLOTS = (1, 2, 3, 4, 8)
TRI_MIXES = {                         # mix -> axes; the route each takes
    "path": [(0, 1), (1, 2)],
    "path-vector": [(0, 1), (2,)],
    "path-no-axis0": [(1, 2)],
    "triangle": [(0, 1), (1, 2), (0, 2)],
    "dense": [(0, 1, 2), (0, 2)],
}


def _mesh(slots):
    return meshes.data_mesh(slots, device="cpu")


# -- the join matrix: every case computed once by the reference ----------------------

def _cases():
    """name -> (factors, port call(mesh), reference call(reference))."""
    out = {}
    for n, block in ((40, 8), (65, 128)):
        v = _factors(n, [(n,)] * 2, _hi(2, block))
        out[f"vec-n{n}"] = (
            v, lambda m, v=v, b=block: dcj.sharded_cutjoin(
                _t(v), mesh=m, distinct=False, block=b),
            lambda r, v=v, b=block: r.ops.cutjoin_reduce(
                v, distinct=False, bm=b, bn=b, interpret=True))
    for n, block in ((40, 8), (65, 128), (130, 128)):
        Ms = _factors(n + 1, [(n, n)] * 3, _hi(3, block))
        out[f"pair-n{n}"] = (
            Ms, lambda m, Ms=Ms, b=block: dcj.sharded_cutjoin(
                _t(Ms), mesh=m, block=b),
            lambda r, Ms=Ms, b=block: r.ops.cutjoin_reduce(
                Ms, bm=b, bn=b, interpret=True))
        if n == 130:
            continue
        for keep in (0, 1):
            out[f"pair-keep{keep}-n{n}"] = (
                Ms, lambda m, Ms=Ms, b=block, k=keep: dcj.sharded_cutjoin_keep(
                    _t(Ms), keep=k, mesh=m, block=b),
                lambda r, Ms=Ms, b=block, k=keep: r.ops.cutjoin_reduce_keep(
                    Ms, keep=k, bm=b, bn=b, interpret=True))
    for n, block in ((24, 8), (33, 128)):
        for mix, axes in TRI_MIXES.items():
            fs = _factors(n + len(mix), [(n,) * len(ax) for ax in axes],
                          _hi(len(axes), block))
            out[f"tri-{mix}-n{n}"] = (
                fs, lambda m, fs=fs, ax=axes, n=n, b=block:
                dcj.sharded_cutjoin3(_t(fs), ax, n=n, mesh=m, block=b),
                lambda r, fs=fs, ax=axes, n=n, b=block:
                r.ops.cutjoin_reduce3(fs, ax, n=n, block=b, interpret=True))
            if mix not in ("triangle", "dense"):
                continue
            for keep in (0, 1, 2):
                out[f"tri-keep{keep}-{mix}-n{n}"] = (
                    fs, lambda m, fs=fs, ax=axes, n=n, b=block, k=keep:
                    dcj.sharded_cutjoin3_keep(_t(fs), ax, keep=k, n=n,
                                              mesh=m, block=b),
                    lambda r, fs=fs, ax=axes, n=n, b=block, k=keep:
                    r.ops.cutjoin_reduce3_keep(fs, ax, keep=k, n=n,
                                               block=b, interpret=True))
    big = float(1 << 30)                 # the dense route: no guard
    for n, k in ((33, 2), (17, 3)):
        rng = np.random.default_rng(n + k)
        Ms = [rng.integers(0, 3, size=(n,) * k).astype(np.float64) * big
              for _ in range(2)]
        out[f"dense-k{k}-n{n}"] = (
            Ms, lambda m, Ms=Ms, k=k: dcj.sharded_dense_join(_t(Ms), k,
                                                             mesh=m),
            lambda r, Ms=Ms: _ref_dense(r, Ms))
    for n in (40, 37):
        for k in (2, 3):
            rng = np.random.default_rng(10 * n + k)
            Ms = [rng.integers(0, 5, size=(n,) * k).astype(np.float64)
                  for _ in range(2)]
            masked = Ms + [_mask(n, k)]      # as lowering hands them over
            for keep in range(k):
                out[f"dense-keep{keep}-k{k}-n{n}"] = (
                    Ms, lambda m, Ms=masked, k=k, keep=keep:
                    dcj.sharded_dense_join_keep(_t(Ms), k, keep=keep,
                                                mesh=m),
                    lambda r, Ms=Ms, k=k, keep=keep:
                    _ref_dense_keep(r, Ms, k, keep))
    return out


def _mask(n, k):
    """Π_{a<b} [x_a != x_b] over an (n,)*k grid."""
    x = np.arange(n)
    grids = np.meshgrid(*([x] * k), indexing="ij")
    mask = np.ones((n,) * k)
    for a in range(k):
        for b in range(a + 1, k):
            mask *= grids[a] != grids[b]
    return mask


def _ref_dense(r, Ms):
    """The reference's single-device dense f64 join, ``_join_reduce``."""
    import jax.numpy as jnp
    from repro.compiler import lowering
    with r.x64():
        return float(lowering._join_reduce(
            jnp.stack([jnp.asarray(M) for M in Ms])))


def _ref_dense_keep(r, Ms, k, keep):
    """The reference's single-device dense keep joins, ``_join_keep`` /
    ``_join_keep3`` (the mask as its lowering builds it)."""
    import jax.numpy as jnp
    from repro.compiler import lowering
    with r.x64():
        stack = jnp.stack([jnp.asarray(M) for M in Ms])
        if k == 2:
            return np.asarray(lowering._join_keep(stack, keep))
        return np.asarray(lowering._join_keep3(
            stack, jnp.asarray(_mask(Ms[0].shape[0], 3)), keep))


CASES = _cases()


@pytest.fixture(scope="module")
def ref_joins(reference):
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = CASES[name][2](reference)
        return memo[name]
    return get


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_join_equals_reference_single_device(ref_joins, name,
                                                     slots):
    got = CASES[name][1](_mesh(slots))
    want = ref_joins(name)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    else:
        assert got == want, name


@pytest.mark.parametrize("slots", (3, 8))
def test_slices_keep_the_entry_their_factor_strides_pick(slots):
    """A slot's operands are views of the factors (no copy on a shared
    device) with the whole factor's strides, so K3's and K4-keep's entry,
    chosen by stride, is the whole join's."""
    n = 37
    base = torch.zeros((n, n), dtype=torch.float64)
    seen = []
    real = tmr.prod_reduce_keep_tiles

    def spy(factors, **kw):
        for F in factors:
            assert F.untyped_storage().data_ptr() == \
                base.untyped_storage().data_ptr()
            seen.append((F.stride(), tmr.keep_entry(F, kw["keep"])))
        return real(factors, **kw)

    for keep in (0, 1):
        for F in (base, base.T):
            tmr.prod_reduce_keep_tiles = spy
            try:
                dcj.sharded_cutjoin_keep([F, F], keep=keep,
                                         mesh=_mesh(slots), block=8)
            finally:
                tmr.prod_reduce_keep_tiles = real
            assert {e for s, e in seen} == {tmr.keep_entry(F, keep)}
            assert {s for s, e in seen} == {F.stride()}
            seen.clear()


def test_slot_ranges_cover_the_axis_once():
    for n in (1, 5, 33, 8192):
        for d in (1, 2, 3, 4, 8):
            rs = dcj.slot_ranges(n, d)
            assert len(rs) == d
            rows = [r for a, b in rs for r in range(a, b)]
            assert rows == list(range(n)), (n, d)


def test_mesh_basics():
    m = meshes.data_mesh(3, device="cpu")
    assert (meshes.num_shards(m), meshes.num_shards(None),
            meshes.num_chips(m)) == (3, 1, 1)
    assert m.shape == {"data": 3} and m.home == torch.device("cpu")
    assert meshes.active_mesh() is None
    with meshes.sharding_ctx(m):
        assert meshes.active_mesh() is m
    assert meshes.active_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            meshes.data_mesh(2)
    with pytest.raises(ValueError):
        meshes.data_mesh(0, device="cpu")


# -- plans under a mesh --------------------------------------------------------------

PLAN_PATS = [cycle(4), chain(4), chain(5)]
LABELLED = Pattern(3, [(0, 1), (1, 2)], (0, 1, 0))


@pytest.fixture(scope="module")
def plans(reference):
    """The reference's single-device counts and anchored vectors."""
    G, RP = reference.generators, reference.pattern.Pattern
    rg = G.erdos_renyi(72, 7.0, seed=3)
    rgl = G.erdos_renyi(60, 6.0, seed=5, num_labels=3)
    rpats = [RP(p.n, sorted(p.edges)) for p in PLAN_PATS]
    rcp = reference.compiler.compile(
        rpats, rg, cache=False, apct=shared_apct("ref", rg, reference.APCT))
    rlab = RP(3, sorted(LABELLED.edges), LABELLED.labels)
    rlcp = reference.compiler.compile(
        (rlab,), rgl, cache=False,
        apct=shared_apct("ref", rgl, reference.APCT))
    rloc = reference.compiler.compile(
        rpats[0], rg, cache=False, local=True,
        apct=shared_apct("ref", rg, reference.APCT))
    anchored = {a: np.asarray(rloc.local_counts(rpats[0], a))
                for a in range(4) if rloc.has_local(rpats[0], a)}
    return dict(tg=port_graph(rg), tgl=port_graph(rgl),
                counts=[rcp.count(p) for p in rpats],
                labelled=rlcp.count(rlab), anchored=anchored)


@pytest.mark.parametrize("slots", SLOTS)
def test_mesh_plan_counts_bitforbit(plans, slots):
    """Counts (unlabelled and labelled) and anchored keep-axis vectors of
    plans compiled with a mesh equal the reference's single-device ones,
    with the sharded routes taken."""
    mesh = _mesh(slots)
    tg, tgl = plans["tg"], plans["tgl"]
    apct = shared_apct("port", tg, TAPCT)
    cp = tcompiler.compile(PLAN_PATS, tg, cache=False, mesh=mesh, apct=apct)
    cp.tracer = tobs.Tracer()
    assert [cp.count(p) for p in PLAN_PATS] == plans["counts"]
    routes = {s.attrs.get("route") for s in cp.tracer.walk()}
    if slots > 1:
        assert routes & {"kernel-sharded", "dense-f64-sharded"}, routes
        assert "einsum-sharded" in routes and cp.counter._A_dense is None
        spans = [s for s in cp.tracer.walk()
                 if s.attrs.get("route", "").endswith("sharded")]
        assert all(s.attrs["mesh_axes"] == ["data"]
                   and s.attrs["num_shards"] == slots for s in spans)
    else:
        assert not any(r and "sharded" in r for r in routes), routes
    cl = tcompiler.compile((LABELLED,), tgl, cache=False, mesh=mesh,
                           apct=shared_apct("port", tgl, TAPCT))
    assert cl.count(LABELLED) == plans["labelled"]
    c2 = tcompiler.compile(PLAN_PATS[0], tg, cache=False, local=True,
                           mesh=mesh, apct=apct)
    assert {a: c2.local_counts(PLAN_PATS[0], a).numpy()
            for a in range(4) if c2.has_local(PLAN_PATS[0], a)}.keys() == \
        plans["anchored"].keys()
    for a, want in plans["anchored"].items():
        assert np.array_equal(c2.local_counts(PLAN_PATS[0], a).numpy(),
                              want), a
    if slots > 1:
        assert {j["route"] for j in c2.join_log} <= \
            {"kernel-sharded-keep", "dense-f64-sharded-keep",
             "dense-product"}, c2.join_log


def test_small_graph_falls_back_single_device(reference):
    """n < slots: joins run on one device, ``cutjoin.shard_fallbacks_
    compile`` counts reason ``small-n``, and the count is the
    reference's."""
    rg = reference.generators.erdos_renyi(6, 2.0, seed=2)
    rp = reference.pattern.cycle(4)
    want = reference.compiler.compile(
        rp, rg, cache=False,
        apct=shared_apct("ref", rg, reference.APCT)).count(rp)
    tg = port_graph(rg)
    before = tobs.get("cutjoin.shard_fallbacks_compile", reason="small-n")
    cp = tcompiler.compile(cycle(4), tg, cache=False, mesh=_mesh(8),
                           apct=shared_apct("port", tg, TAPCT))
    assert cp.count(cycle(4)) == want
    assert cp.counter.mesh is None          # the engine did not bind it
    assert tobs.get("cutjoin.shard_fallbacks_compile",
                    reason="small-n") > before


def test_guard_refusal_under_mesh_stays_exact(reference):
    """Where the guard refuses, a mesh on the CPU takes the sharded dense
    f64 routes (the f64 instances are for the card), and counts and
    anchored vectors equal the reference's single-device ones."""
    from repro.graph.storage import Graph as RGraph
    rg = RGraph(300, _hub_edges())
    RP = reference.pattern.Pattern
    pats = [cycle(4), chain(5)]
    rpats = [RP(p.n, sorted(p.edges)) for p in pats]
    rcp = reference.compiler.compile(
        rpats, rg, cache=False, local=True,
        apct=shared_apct("ref", rg, reference.APCT))
    tg = port_graph(rg)
    cp = tcompiler.compile(pats, tg, cache=False, local=True, mesh=_mesh(4),
                           apct=shared_apct("port", tg, TAPCT))
    assert [cp.count(p) for p in pats] == [rcp.count(p) for p in rpats]
    for p, rp in zip(pats, rpats):
        for orbit in p.vertex_orbits():
            assert np.array_equal(cp.local_counts(p, orbit[0]).numpy(),
                                  np.asarray(rcp.local_counts(rp, orbit[0])))
    refused = [j for j in cp.join_log if j["block"] is None
               and j["guard"] is not None]
    assert refused
    assert {j["route"] for j in refused} <= \
        {"dense-f64-sharded", "dense-f64-sharded-keep"}


def test_free_tensors_reach_the_join_as_the_slots_made_them(plans):
    """Under a mesh a Contract node's free tensor stays in its slots' row
    blocks (``Sliced``): every pair-join slot operand is a view of a block
    the contraction (or a combination of its blocks) made, and no block is
    gathered whole when every join takes the sharded kernel route; the
    public ``hom_free_tensor`` still returns one tensor."""
    tg = plans["tg"]
    for slots in (3, 5):                  # 5 does not divide n = 72
        mesh = _mesh(slots)
        cp = tcompiler.compile(PLAN_PATS, tg, cache=False, mesh=mesh,
                               apct=shared_apct("port", tg, TAPCT))
        seen, real = [], tmr.prod_reduce_tiles

        def spy(factors, **kw):
            seen.extend(F.untyped_storage().data_ptr() for F in factors
                        if F.ndim == 2)
            return real(factors, **kw)
        before = tobs.get("contract.slice_gathers")
        tmr.prod_reduce_tiles = spy
        try:
            assert [cp.count(p) for p in PLAN_PATS] == plans["counts"]
        finally:
            tmr.prod_reduce_tiles = real
        routes = {j["route"] for j in cp.join_log}
        assert routes == {"kernel-sharded"}, routes
        # a tri join's factor without cut axis 0 is replicated: gathered
        # once per join (every slot is the CPU); nothing else is
        replicated = sum(0 not in ax for j in cp.join_log if j["cut"] == 3
                         for ax in cp.plan.nodes[j["node"]].factor_axes())
        assert tobs.get("contract.slice_gathers") - before == replicated
        before += replicated
        blocks = [v for v in list(cp.counter.hom_free_memo.values()) +
                  list(cp._factors.values()) if isinstance(v, C.Sliced)]
        assert blocks and all(len(b.parts) == slots for b in blocks)
        made = {P.untyped_storage().data_ptr() for b in blocks
                for P in b.parts}
        assert seen and set(seen) <= made
        p, free = next((k[0], k[1]) for k in cp.counter.hom_free_memo
                       if len(k[1]) == 2)
        whole = cp.counter.hom_free_tensor(p, free)
        assert isinstance(whole, torch.Tensor) and \
            whole.shape == (tg.n, tg.n)
        assert tobs.get("contract.slice_gathers") == before + 1
        assert torch.equal(whole, CountingEngine(
            tg, device="cpu").hom_free_tensor(p, free))


@pytest.fixture(scope="module")
def hub_mesh():
    """The port's local plan on the hub graph under a 4-slot mesh, on a
    mesh-bound engine, every read of ``test_torch_local`` made (joins the
    f32 guard refuses, free tensors held as the slots' blocks), and the
    same reads of a one-device plan."""
    tg = TGraph(300, _hub_edges())
    mesh = _mesh(4)
    apct = shared_apct("port", tg, TAPCT)
    reads = {}
    for m in (mesh, None):
        cp = tcompiler.compile(HUB_PATTERNS, tg, cache=False, local=True,
                               mesh=m, device="cpu", apct=apct)
        reads[m is None] = _reads(cp, HUB_PATTERNS, lambda t: t.numpy())
        if m is not None:
            meshed = cp
    return meshed, tg, mesh, reads


def test_hub_reads_under_a_mesh_equal_one_device(hub_mesh):
    """Every read (counts, anchored and unanchored local tensors,
    ``exists`` with its early-exit probes over the slots' blocks) under a
    mesh equals one device's on a graph where the guard refuses joins."""
    cp, _, _, reads = hub_mesh
    got, want = reads[False], reads[True]
    assert got.keys() == want.keys()
    for part in ("counts", "exists", "mini"):
        assert got[part] == want[part], part
    for part in ("anchored", "unanchored", "domains"):
        assert got[part].keys() == want[part].keys(), part
        for k, v in want[part].items():
            assert np.array_equal(got[part][k], v), (part, k)
    assert any(isinstance(v, C.Sliced)
               for v in cp.counter.hom_free_memo.values())


@pytest.mark.parametrize("slots", (3, 5))
def test_domains_under_a_mesh_equal_one_device(plans, slots):
    """FSM domain vectors (Möbius sums of the contraction's sliced free
    vectors) and MINI support under a mesh equal one device's."""
    tg = plans["tg"]
    apct = shared_apct("port", tg, TAPCT)
    got, want = [tcompiler.compile(PLAN_PATS, tg, cache=False, domains=True,
                                   mesh=m, device="cpu", apct=apct)
                 for m in (_mesh(slots), None)]
    for p in PLAN_PATS:
        doms = got.domains(p)
        assert doms.keys() == want.domains(p).keys()
        for rep, vec in want.domains(p).items():
            assert torch.equal(doms[rep], vec), (p, rep)
        assert got.mini_support(p) == want.mini_support(p)


@pytest.mark.parametrize("kind", ("cut1", "keep2"))
@pytest.mark.parametrize("case", ("granted", "f64", "dense", "cpu"))
def test_route_of_a_join_under_a_mesh_by_guard_and_device(
        hub_mesh, monkeypatch, kind, case):
    """Lowering's routing under a mesh with factors that claim to lie on
    the card: guard granted -> the f32 tile entry on each slot's slice
    (``kernel-sharded[-keep]``); guard refused and ``exact_f64`` admitted
    -> the f64 tile entry on each slot's slice (``kernel-f64-sharded`` /
    ``kernel-f64-sharded-keep``, counted in ``cutjoin.kernel_f64``); both
    refused -> the sharded dense route, counted in
    ``cutjoin.kernel_fallbacks``.  On the CPU a refusal takes the sharded
    dense route whatever ``exact_f64`` says.  No single-device entry is
    called."""
    cp0, tg, mesh, _ = hub_mesh
    key = next(j["node"] for j in cp0.join_log
               if j["guard"] == "scanned" and j["block"] is None
               and j["cut"] == (1 if kind == "cut1" else 2)
               and (kind == "cut1") == (j["keep"] is None))
    want = cp0.value(key)

    class OnCard(torch.Tensor):
        is_cuda = True

    def card(M):
        if isinstance(M, C.Sliced):
            return C.Sliced(tuple(P.as_subclass(OnCard) for P in M.parts),
                            M.rows, M.n)
        return M.as_subclass(OnCard)

    cp = tlowering.lower(cp0.plan, tg, counter=cp0.counter, mesh=mesh,
                         device="cpu")
    real = cp._join_factors
    monkeypatch.setattr(cp, "_join_factors", lambda nd: (
        [card(M) if case != "cpu" else M for M in real(nd)[0]],
        real(nd)[1]))
    guard = {"granted": (8, [1.0, 1.0]), "f64": (None, [2.0 ** 20] * 2),
             "dense": (None, [2.0 ** 40] * 2),
             "cpu": (None, [2.0 ** 20] * 2)}[case]
    monkeypatch.setattr(cp, "_guard_block",
                        lambda nd, Ms, axes: (guard[0], "scanned", guard[1]))
    called = []

    def tiles(name):
        def run(factors, **kw):      # the exact join of the slice
            called.append((name, kw.get("f64", False), kw.get("offsets")))
            fs = [F.as_subclass(torch.Tensor) for F in factors]
            if name == "prod_reduce_tiles":
                return tmr._prod_partials_plain(fs, False, 1, None,
                                                f64=True)
            return tmr._pair_keep_partials_plain(
                fs, kw["keep"], True, 1, kw["offsets"], f64=True)
        return run

    def never(*a, **kw):
        raise AssertionError("a single-device entry under a mesh")

    for name in ("prod_reduce_tiles", "prod_reduce_keep_tiles"):
        monkeypatch.setattr(tmr, name, tiles(name))
    for name in ("cutjoin_reduce", "cutjoin_reduce_f64",
                 "cutjoin_reduce_keep", "cutjoin_reduce_keep_f64"):
        monkeypatch.setattr(tops, name, never)
    tobs.reset()
    got = cp.value(key)
    route = cp.join_log[-1]["route"]
    snap = tobs.snapshot()
    entry = "prod_reduce_tiles" if kind == "cut1" \
        else "prod_reduce_keep_tiles"
    suffix = "" if kind == "cut1" else "-keep"
    expect = {"granted": ({(entry, False)}, "kernel-sharded" + suffix),
              "f64": ({(entry, True)}, "kernel-f64-sharded" + suffix),
              "dense": (set(), "dense-f64-sharded" + suffix),
              "cpu": (set(), "dense-f64-sharded" + suffix)}[case]
    assert ({c[:2] for c in called}, route) == expect
    if called:                       # one call per slot, global offsets
        rows = dcj.slot_ranges(tg.n, 4)
        assert len(called) == 4
        if kind == "keep2":
            assert [c[2] for c in called] == [(a, 0) for a, _ in rows]
    assert ("cutjoin.kernel_f64" in snap) == (case == "f64")
    assert ("cutjoin.kernel_fallbacks" in snap) == (case in ("dense", "cpu"))
    assert cp.join_log[-1]["route"].endswith("sharded" + suffix)
    if kind == "cut1":
        assert got == want
    else:
        assert torch.equal(got.as_subclass(torch.Tensor), want)


# -- layer 1 --------------------------------------------------------------------------

def test_batcher_mesh_fanout_matches_single(reference):
    """A meshed batcher's counts equal the reference's meshless batcher's,
    and the group fans out over the slots."""
    rg = reference.generators.erdos_renyi(56, 6.0, seed=9)
    RP = reference.pattern.Pattern
    pats = (cycle(4), chain(4))
    from repro.serve.batching import (PatternQueryBatcher as RBatcher,
                                      PatternRequest as RRequest)
    rb = RBatcher(rg, max_batch=8, apct=shared_apct("ref", rg,
                                                    reference.APCT))
    for i in range(6):
        rb.submit(RRequest(uid=i, patterns=tuple(
            RP(p.n, sorted(p.edges)) for p in pats)))
    rb.run_to_completion()
    tg = port_graph(rg)
    tb = PatternQueryBatcher(tg, max_batch=8, mesh=_mesh(8),
                             apct=shared_apct("port", tg, TAPCT))
    for i in range(6):
        tb.submit(PatternRequest(uid=i, patterns=pats))
    before = tobs.get("mesh.map_requests", devices=8)
    tb.run_to_completion()
    assert tobs.get("mesh.map_requests", devices=8) - before == 6
    assert tb.device == torch.device("cpu")
    assert len(tb.finished) == len(rb.finished) == 6
    for a, b in zip(tb.finished, rb.finished):
        assert not a.error and not b.error
        assert list(a.counts.values()) == list(b.counts.values())


@pytest.fixture(scope="module")
def serial_joins(reference):
    rng = np.random.default_rng(11)
    stacks = rng.integers(0, 6, size=(11, 2, 48, 48)).astype(np.float64)
    block = min(b for b in (reference.ops.cutjoin_exact_block(
        list(s), interpret=True) for s in stacks) if b is not None)
    return stacks, [reference.ops.cutjoin_reduce(list(s), bm=block,
                                                 bn=block, interpret=True)
                    for s in stacks]


@pytest.mark.parametrize("slots", (1, 3, 8))
def test_join_batch_matches_serial(serial_joins, slots):
    stacks, serial = serial_joins
    got = dcj.MeshExecutor(_mesh(slots)).join_batch(stacks)
    assert got.dtype == torch.float64
    assert got.tolist() == serial
    assert dcj.MeshExecutor(_mesh(slots)).join_batch(
        torch.from_numpy(stacks)).tolist() == serial


def test_executor_map_round_robins_and_counts():
    ex = dcj.MeshExecutor(_mesh(3))
    before = tobs.get("mesh.map_requests", devices=3)
    assert ex.map(lambda x: x * x, range(7)) == [x * x for x in range(7)]
    assert tobs.get("mesh.map_requests", devices=3) - before == 7


# -- static shard-legality diagnostics ----------------------------------------------

@pytest.fixture(scope="module")
def plan_and_info(reference):
    """One port plan, and the reference's verdicts on the same plan (read
    back from its JSON)."""
    rg = reference.generators.erdos_renyi(24, 4.0, seed=13)
    tg = port_graph(rg)
    cp = tcompiler.compile(cycle(4), tg, cache=False, device="cpu",
                           apct=shared_apct("port", tg, TAPCT))
    rplan = reference.compiler.Plan.from_json(cp.plan.to_json())
    rinfo = reference.analysis.GraphInfo.from_graph(rg)
    return cp.plan, tanalysis.GraphInfo.from_graph(tg), rplan, rinfo


@pytest.mark.parametrize("shards,budget", [(1, None), (48, None), (5, None),
                                           (4, 1), (4, 1 << 27)])
def test_shard_check_diagnostics(reference, plan_and_info, shards, budget):
    plan, info, rplan, rinfo = plan_and_info
    got = tanalysis.shard_check(plan, info, shards, budget=budget)
    want = reference.analysis.shard_check(rplan, rinfo, shards,
                                          budget=budget)
    assert [(d.code, d.node, d.severity) for d in got.diagnostics] == \
        [(d.code, d.node, d.severity) for d in want.diagnostics]
    assert got.ok == want.ok
    codes = {d.code for d in got.diagnostics}
    assert codes == {1: set(), 48: {"shard-small-graph"},
                     5: {"shard-indivisible"}}.get(
        shards, {"shard-budget-overflow"} if budget == 1 else set())


def test_precertify_num_shards_is_noop(plan_and_info):
    plan, info, _, _ = plan_and_info
    assert tanalysis.precertify(plan, info) == \
        tanalysis.precertify(plan, info, num_shards=8)

