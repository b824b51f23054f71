"""The mining driver and engine tier of the port vs the reference:
``MiningEngine`` (compiled and legacy counts, Algorithm 1's UDF path,
materialisation), ``fsm`` and MINI support, the decomposition-space
searches, ``mine_pseudo_cliques``, partial symmetry breaking, the
block-sparse backend, and ``python -m repro_torch.launch.mine`` against
``python -m repro.launch.mine`` line for line.

Graphs come from the reference's seeded generators and reach the port as
numpy arrays (≤ 60 vertices, as ``tests/test_engine.py`` uses).  The port
runs with ``device="cpu"``, where every kernel takes its plain version.
Tolerance is **0** throughout: counts, supports, frequent sets, UDF
partial-embedding multisets, cuts and hotspots must be equal.

Building an APCT takes seconds on a CPU, and each CLI run builds its own.
The CLI comparisons therefore hand both packages one APCT per graph and
constructor arguments (the ``shared_apcts`` fixture): each side's
``APCT`` is replaced by a memo of the same class, so the two packages
still profile the same graph with the same seed and select the same
plans.
"""
import collections
import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from repro_torch import compiler as tcompiler
from repro_torch.core import apct as tapct
from repro_torch.core import blocksparse as tbsp
from repro_torch.core import engine as tengine
from repro_torch.core import fsm as tfsm
from repro_torch.core import search as tsearch
from repro_torch.core import symmetry as tsym
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import (Pattern, chain, clique, cycle, star,
                                      tailed_triangle)
from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import KernelError
from repro_torch.launch import mine as tmine

from test_torch_reference import port_graph, reference  # noqa: F401

PATTERNS = [chain(4), cycle(4), tailed_triangle(),
            Pattern(5, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 4)])]
LABELLED = [Pattern(2, [(0, 1)], (0, 1)),
            Pattern(3, [(0, 1), (1, 2)], (0, 1, 0)),
            Pattern(3, [(0, 1), (1, 2), (0, 2)], (1, 1, 2))]


def _rp(reference, p):
    """The reference's Pattern for a port Pattern."""
    return reference.pattern.Pattern(p.n, sorted(p.edges), p.labels)


def _key(p):
    """Package-neutral pattern key."""
    return (p.n, tuple(sorted(p.edges)), p.labels)


@pytest.fixture(scope="module")
def graphs(reference):
    G = reference.generators
    # g40 is the graph the CLI cases build (--n 40 --deg 5 --seed 0)
    out = {"g40": G.erdos_renyi(40, 5.0, seed=0),
           "gl36": G.erdos_renyi(36, 4.0, seed=2, num_labels=3),
           "tri48": G.triangle_rich(48, 4, seed=3),
           "g24": G.erdos_renyi(24, 4.0, seed=9)}
    return {k: (g, port_graph(g)) for k, g in out.items()}


@pytest.fixture(scope="module")
def engines(reference, graphs):
    from repro.core.engine import MiningEngine
    from test_torch_reference import shared_apct
    rg, tg = graphs["g40"]
    return (MiningEngine(rg, apct=shared_apct("ref", rg, reference.APCT)),
            tengine.MiningEngine(tg, device="cpu",
                                 apct=shared_apct("port", tg, tapct.APCT)))


# -- MiningEngine ----------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(PATTERNS)))
def test_engine_counts_equal(reference, engines, graphs, i):
    reng, teng = engines
    p = PATTERNS[i]
    rp = _rp(reference, p)
    want = reference.counting.brute_force_edge_induced(graphs["g40"][0], rp)
    assert teng.get_pattern_count(p) == reng.get_pattern_count(rp) == want
    assert teng.get_pattern_count(p, use_compiler=False) == \
        reng.get_pattern_count(rp, use_compiler=False) == want
    assert teng.get_pattern_count(p, induced="vertex") == \
        reng.get_pattern_count(rp, induced="vertex")
    assert teng.compiler_fallbacks == reng.compiler_fallbacks == 0
    c = teng.choose_cut(p)
    assert c == reng.choose_cut(rp)
    assert teng.pattern_exists(p) == reng.pattern_exists(rp)


def _udf_multiset(eng, p):
    seen = collections.Counter()
    eng.run_partial_embeddings(
        p, lambda pe, c: seen.update([(pe.subpattern_id, pe.vertices, c)]))
    return seen


@pytest.mark.parametrize("i", range(len(PATTERNS) + 1))
def test_algorithm1_partial_embeddings_equal(reference, engines, i):
    reng, teng = engines
    p = (PATTERNS + [clique(3)])[i]
    want = _udf_multiset(reng, _rp(reference, p))
    got = _udf_multiset(teng, p)
    assert got and got == want
    # materialised extensions of the first partial embeddings
    from repro.core.engine import PartialEmbedding as RPE
    for sid, verts, cnt in sorted(got)[:6]:
        pe = tengine.PartialEmbedding(sid, verts)
        embs = teng.materialize(p, pe, num=cnt + 1)
        assert embs == reng.materialize(_rp(reference, p), RPE(sid, verts),
                                        num=cnt + 1)
        if i < len(PATTERNS):
            assert len(embs) == cnt


def test_engine_existence_and_clique_fallback(reference, engines):
    reng, teng = engines
    for p in (chain(3), clique(6)):
        assert teng.pattern_exists(p) == reng.pattern_exists(_rp(reference,
                                                                 p))
    assert teng.choose_cut(clique(4)) is None


# -- FSM -------------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(LABELLED)))
def test_mini_support_equal(reference, graphs, i):
    from repro.core import fsm as rfsm
    rg, tg = graphs["gl36"]
    p = LABELLED[i]
    rc = reference.counting.CountingEngine(rg)
    tc = CountingEngine(tg, device="cpu")
    want = rfsm.mini_support(rc, _rp(reference, p))
    assert tfsm.mini_support(tc, p) == want
    assert tfsm.mini_support_dense(tc, p) == \
        rfsm.mini_support_dense(rc, _rp(reference, p)) == want


@pytest.mark.parametrize("use_compiler", [True, False])
def test_fsm_frequent_sets_equal(reference, graphs, use_compiler):
    from repro.core import fsm as rfsm
    rg, tg = graphs["gl36"]
    kw = dict(max_vertices=3, use_compiler=use_compiler)
    want = rfsm.fsm(rg, 2, **kw)
    got = tfsm.fsm(tg, 2, device="cpu", **kw)
    assert {_key(p): s for p, s in got.frequent.items()} == \
        {_key(p): s for p, s in want.frequent.items()}
    for field in ("evaluated", "pruned", "levels", "compiled_levels",
                  "fallbacks"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.compiled_levels == (got.levels if use_compiler else 0)


# -- search ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def apcts(reference, graphs):
    rg, tg = graphs["tri48"]
    r, t = reference.APCT(rg, num_samples=4096), \
        tapct.APCT(tg, num_samples=4096)
    assert {_key(p): v for p, v in t.table.items()} == \
        {_key(p): v for p, v in r.table.items()}
    return r, t


def _cuts(cuts):
    return [None if c is None else sorted(c) for c in cuts]


@pytest.mark.parametrize("method", sorted(tsearch.METHODS))
def test_search_returns_the_same_cuts(reference, apcts, method):
    from repro.core import search as rsearch
    from repro.core.motifs import motif_patterns as rmotifs
    from repro_torch.core.motifs import motif_patterns
    rapct, tapct_ = apcts
    n = rapct.profile_graph.n
    kw = dict(pop=8, gens=4) if method == "genetic" else {}
    want = rsearch.METHODS[method](rmotifs(4), rapct, n, **kw)
    got = tsearch.METHODS[method](motif_patterns(4), tapct_, n, **kw)
    assert _cuts(got.cuts) == _cuts(want.cuts)
    assert got.cost == want.cost and got.evals == want.evals
    assert [c for _, c in got.history] == [c for _, c in want.history]


def test_mine_pseudo_cliques_equal(reference, graphs, shared_apcts):
    from repro.core.search import mine_pseudo_cliques as rmine_pc
    rg, tg = graphs["g40"]
    want = rmine_pc(rg, 4, missing=1, cache=False)
    got = tsearch.mine_pseudo_cliques(tg, 4, missing=1, cache=False,
                                      device="cpu")
    assert got.per_vertex.dtype == torch.float64
    assert np.array_equal(got.per_vertex.numpy(), want.per_vertex)
    assert {_key(p): v for p, v in got.totals.items()} == \
        {_key(p): float(v) for p, v in want.totals.items()}
    assert got.hotspots == want.hotspots
    total = sum(p.n * v for p, v in got.totals.items())
    assert got.per_vertex.sum().item() == total


# -- symmetry --------------------------------------------------------------------------

SYM_PATTERNS = [clique(3), clique(4), tailed_triangle(), star(4), chain(4),
                chain(3), Pattern(5, [(0, 1), (0, 2), (1, 2), (2, 3),
                                      (3, 4)])]


@pytest.mark.parametrize("i", range(len(SYM_PATTERNS)))
def test_symmetry_equal(reference, graphs, i):
    from repro.core import symmetry as rsym
    import jax.numpy as jnp
    rg, tg = graphs["g24"]
    p = SYM_PATTERNS[i]
    rp = _rp(reference, p)
    orbits = tsym.interchangeable_orbits(p)
    assert orbits == rsym.interchangeable_orbits(rp)
    A = torch.from_numpy(tg.dense_adjacency(np.float64, pad=False))
    from repro_torch.core import homomorphism as TH
    for orbit in orbits:
        # a clique orbit: hom itself; an independent orbit: hom over
        # pairwise-distinct orbit assignments (what decomposed inj needs)
        pairs = [(u, w) for j, u in enumerate(orbit) for w in orbit[j + 1:]]
        off = 1.0 - torch.eye(tg.n, dtype=torch.float64)
        aug = Pattern(p.n, set(p.edges) | set(pairs))
        et = {} if p.has_edge(*pairs[0]) else {e: off for e in pairs}
        want_hom = TH.hom_count(aug, A, edge_tensors=et).item()
        got = tsym.hom_oriented(p, A, orbit)
        assert got.dtype == torch.float64 and got.device == A.device
        with reference.x64():
            RA = jnp.asarray(rg.dense_adjacency(np.float64, pad=False))
            want = float(rsym.hom_oriented(rp, RA, orbit))
        assert got.item() == want
        assert got.item() == want_hom
        assert tsym.psb_speedup_estimate(p, orbit) == \
            rsym.psb_speedup_estimate(rp, orbit)


# -- block-sparse ----------------------------------------------------------------------

@pytest.mark.parametrize("tile", [16, 32])
def test_blocksparse_equal(reference, graphs, tile):
    from repro.core import blocksparse as rbsp
    rg, tg = graphs["tri48"]
    r = rbsp.BlockSparseAdjacency(rg, tile=tile)
    t = tbsp.BlockSparseAdjacency(tg, tile=tile, device="cpu")
    assert sorted(t.blocks) == sorted(r.blocks)
    for key, tile_t in t.blocks.items():
        assert tile_t.dtype == torch.float32
        assert np.array_equal(tile_t.numpy(), r.blocks[key])
    assert t.stats() == r.stats()
    assert t.row_blocks == r.row_blocks
    want = CountingEngine(tg, device="cpu").edge_induced(clique(3))
    assert tbsp.triangle_count_blocksparse(t) == \
        rbsp.triangle_count_blocksparse(r) == want
    kernel_route = tbsp.triangle_count_blocksparse(t, use_kernel=True)
    assert kernel_route == want
    if tile == 32:                 # 4 tiles: the reference's kernel route
        assert rbsp.triangle_count_blocksparse(r, use_kernel=True) == want
    assert tbsp.wedge_count_blocksparse(t) == \
        rbsp.wedge_count_blocksparse(r) == \
        CountingEngine(tg, device="cpu").edge_induced(chain(3))
    assert tbsp.blocksparse_flops(t) == rbsp.blocksparse_flops(r)
    assert tbsp.dense_flops(tg.n) == rbsp.dense_flops(rg.n)


@pytest.mark.parametrize("name,tile", [("tri48", 16), ("tri48", 32),
                                       ("g40", 16), ("g24", 8)])
def test_blocksparse_tile_lists_follow_the_tile_triples(graphs, name, tile):
    """K6's tile lists, built with numpy from the tile keys, hold the
    output tiles of ``_tile_triples`` in its order, each with its k in
    ascending order: lhs the stored tile (i, k), rhs the stored tile
    (j, k), which equals (k, j)ᵀ since the adjacency is symmetric."""
    _, tg = graphs[name]
    t = tbsp.BlockSparseAdjacency(tg, tile=tile, device="cpu")
    out_idx, k_ptr, lhs_idx, rhs_idx = tbsp.tile_lists(t)
    keys = [(int(k) // t.nb, int(k) % t.nb) for k in t.keys]
    assert list(t.blocks) == keys
    triples = list(tbsp._tile_triples(t))
    assert len(triples) == len(out_idx) and k_ptr[0] == 0
    for (i, j, mask, ks), o, a, b in zip(triples, out_idx, k_ptr[:-1],
                                          k_ptr[1:]):
        assert keys[o] == (i, j) and mask is t.blocks[(i, j)]
        assert [keys[p] for p in lhs_idx[a:b]] == [(i, k) for k in ks]
        assert [keys[p] for p in rhs_idx[a:b]] == [(j, k) for k in ks]
        for p, q in zip(lhs_idx[a:b], rhs_idx[a:b]):
            k = keys[p][1]
            assert torch.equal(t.tiles[q].T, t.blocks[(k, j)])
    assert k_ptr[-1] * 2.0 * tile ** 3 == tbsp.blocksparse_flops(t)
    # in groups of rows: the same lists, output tiles ordered by (i // 2,
    # j, i)
    lists = {int(o): (list(lhs_idx[a:b]), list(rhs_idx[a:b]))
             for o, a, b in zip(out_idx, k_ptr[:-1], k_ptr[1:])}
    g_out, g_ptr, g_lhs, g_rhs = tbsp.tile_lists(t, group=2)
    assert {int(o): (list(g_lhs[a:b]), list(g_rhs[a:b]))
            for o, a, b in zip(g_out, g_ptr[:-1], g_ptr[1:])} == lists
    order = [(keys[o][0] // 2, keys[o][1], keys[o][0]) for o in g_out]
    assert order == sorted(order)


@pytest.mark.parametrize("name,tile", [("g40", 16), ("tri48", 32),
                                       ("gl36", 16)])
def test_blocksparse_kernel_route_equals_reference(reference, graphs, name,
                                                   tile):
    """``triangle_count_blocksparse(use_kernel=True)`` — one tile-list
    call, its plain version on the CPU — equals the reference's count
    and the engine's, on graphs whose n is no multiple of the tile."""
    from repro.core import blocksparse as rbsp
    rg, tg = graphs[name]
    assert tg.n % tile
    r = rbsp.BlockSparseAdjacency(rg, tile=tile)
    t = tbsp.BlockSparseAdjacency(tg, tile=tile, device="cpu")
    want = CountingEngine(tg, device="cpu").edge_induced(clique(3))
    assert tbsp.triangle_count_blocksparse(t, use_kernel=True) == \
        rbsp.triangle_count_blocksparse(r) == want


# -- the mining CLI --------------------------------------------------------------------

_APCT_MEMO = {}
_TIMING = re.compile(r"^done in |plan nodes \(cache (hit|miss), ")


def _memo_apct(side, cls):
    """``cls`` behind a memo keyed by graph and arguments: what each CLI
    run would build, built once per test run."""
    from test_torch_reference import shared_apct

    def make(graph, **kwargs):
        key = (side, graph.n, np.asarray(graph.edges).tobytes(),
               None if graph.labels is None
               else np.asarray(graph.labels).tobytes(),
               tuple(sorted(kwargs.items())))
        if key not in _APCT_MEMO:
            _APCT_MEMO[key] = (shared_apct(side, graph, cls) if not kwargs
                               else cls(graph, **kwargs))
        return _APCT_MEMO[key]
    return make


@pytest.fixture
def shared_apcts(reference, monkeypatch):
    import repro.core.apct
    import repro.core.engine
    for mod, side, cls in ((repro.core.apct, "ref", reference.APCT),
                           (repro.core.engine, "ref", reference.APCT),
                           (tapct, "port", tapct.APCT),
                           (tengine, "port", tapct.APCT)):
        monkeypatch.setattr(mod, "APCT", _memo_apct(side, cls))


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [line for line in buf.getvalue().splitlines()
            if not _TIMING.search(line)]


BASE = ["--n", "40", "--deg", "5"]
APPS = {
    "motif": ["--app", "motif", "--k", "4"],
    "motif-legacy": ["--app", "motif", "--k", "4", "--no-compiler"],
    "chain-local": ["--app", "chain", "--k", "5", "--local-counts"],
    "chain-local-legacy": ["--app", "chain", "--k", "5", "--local-counts",
                           "--no-compiler", "--top-k", "4"],
    "chain-verify": ["--app", "chain", "--k", "4", "--verify-plans"],
    "pc-local": ["--app", "pc", "--k", "4", "--local-counts"],
    "pc": ["--app", "pc", "--k", "4"],
    "existence-local": ["--app", "existence", "--k", "4", "--local-counts"],
    "existence": ["--app", "existence", "--k", "4"],
    "fsm": ["--app", "fsm", "--k", "3", "--labels", "3", "--support", "5"],
    "fsm-legacy": ["--app", "fsm", "--k", "3", "--labels", "3",
                   "--support", "5", "--no-compiler"],
    "pc-rmat": ["--app", "pc", "--k", "4", "--graph", "rmat"],
    "pc-ws": ["--app", "pc", "--k", "4", "--graph", "ws"],
    "pc-tri": ["--app", "pc", "--k", "3", "--graph", "tri"],
}


@pytest.mark.parametrize("app", sorted(APPS))
def test_mine_cli_prints_the_reference_lines(reference, shared_apcts, app):
    from repro.launch import mine as rmine
    argv = APPS[app] + BASE
    want = _lines(rmine.main, argv)
    got = _lines(tmine.main, argv + ["--device", "cpu"])
    assert len(got) >= 2 and got == want


def test_mine_cli_metrics_and_unported_flags(shared_apcts):
    out = "\n".join(_lines(tmine.main, APPS["pc"] + BASE +
                           ["--device", "cpu", "--metrics"]))
    json.loads(out.split("metrics:\n", 1)[1])
    # --mesh is ported: a two-slot CPU mesh prints its line, then the
    # lines of the run without it
    plain = _lines(tmine.main, APPS["motif"] + BASE + ["--device", "cpu"])
    meshed = _lines(tmine.main, APPS["motif"] + BASE +
                    ["--device", "cpu", "--mesh", "2"])
    assert meshed == ["mesh: 2 device(s) on axis 'data'"] + plain
    # --trace is ported; pc runs no compiled plan, so there is nothing to
    # record, and the reference's line says so
    traced = _lines(tmine.main, APPS["pc"] + BASE +
                    ["--device", "cpu", "--trace", "t.json"])
    assert traced[-1] == ("trace: no compiled-plan execution to record "
                          "(--app pc runs off the traced path)")


# -- errors are not swallowed ----------------------------------------------------------

def _raise_kernel_error(*args, **kwargs):
    raise KernelError("cutjoin_pair launch failed: CUDA error 98")


def test_kernel_error_propagates_through_get_pattern_count(monkeypatch,
                                                           graphs):
    from test_torch_reference import shared_apct
    _, tg = graphs["g40"]
    eng = tengine.MiningEngine(tg, device="cpu",
                               apct=shared_apct("port", tg, tapct.APCT))
    monkeypatch.setattr(tops, "cutjoin_reduce", _raise_kernel_error)
    monkeypatch.setattr(tops, "cutjoin_reduce3", _raise_kernel_error)
    # cycle(5) joins on |cut| = 3 there; no other test compiles it (a warm
    # engine's cached plan may count directly, with no join)
    with pytest.raises(KernelError):
        eng.get_pattern_count(cycle(5))
    monkeypatch.setattr(tcompiler, "compile", _raise_kernel_error)
    with pytest.raises(KernelError):
        eng.get_pattern_count(chain(5))
    assert eng.compiler_fallbacks == 0


def test_kernel_error_propagates_through_fsm(monkeypatch, graphs):
    _, tg = graphs["gl36"]
    monkeypatch.setattr(tcompiler, "compile", _raise_kernel_error)
    with pytest.raises(KernelError):
        tfsm.fsm(tg, 2, device="cpu", apct=object())
    # any other compile failure still falls back, level by level
    monkeypatch.setattr(tcompiler, "compile",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError()))
    res = tfsm.fsm(tg, 2, device="cpu", apct=object())
    assert res.fallbacks == res.levels >= 2 and res.compiled_levels == 0


def test_unported_options_raise(reference, graphs):
    """``MiningEngine(morph=)`` and ``fsm(count_store=)`` are ported (the
    morph count store): counts and frequent sets through one store equal
    the reference's."""
    from repro.compiler.morph import CountStore as RefStore
    from repro.core import fsm as rfsm
    from repro_torch.compiler.morph import CountStore
    from test_torch_reference import shared_apct
    rg, tg = graphs["gl36"]
    store = CountStore()
    eng = tengine.MiningEngine(tg, device="cpu", morph=store,
                               apct=shared_apct("port", tg, tapct.APCT))
    for p in LABELLED:
        assert eng.get_pattern_count(p) == \
            reference.counting.brute_force_edge_induced(rg, _rp(reference,
                                                                p))
    assert eng.compiler_fallbacks == 0 and len(store) > 0
    got = tfsm.fsm(tg, 2, device="cpu", count_store=store)
    want = rfsm.fsm(rg, 2, count_store=RefStore())
    assert {_key(p): s for p, s in got.frequent.items()} == \
        {_key(p): s for p, s in want.frequent.items()}
    assert got.fallbacks == want.fallbacks == 0


def test_device_none_raises_without_cuda(monkeypatch, graphs):
    _, tg = graphs["gl36"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    apct = tapct.APCT(tg, num_samples=64, max_size=3)
    for call in (lambda: tengine.MiningEngine(tg, apct=apct),
                 lambda: tfsm.fsm(tg, 2, apct=apct),
                 lambda: tsearch.mine_pseudo_cliques(tg, 4),
                 lambda: tbsp.BlockSparseAdjacency(tg),
                 lambda: tmine.main(APPS["existence"] + BASE)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
