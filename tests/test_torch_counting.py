"""Contraction engine and ``CountingEngine`` of the port vs the reference.

Graphs are made with numpy from a seed by the reference's generators and
handed to the port as arrays (``interop.graph_from_numpy``); both
packages then count the same patterns.  The port runs with
``device="cpu"``.  Tolerance is **0**: exact equality, since every count
is an integer held in f64 — also against the host brute-force oracle on
graphs of at most 30 vertices.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import homomorphism as TH
from repro_torch.core.counting import (CountingEngine,
                                       brute_force_edge_induced,
                                       brute_force_vertex_induced)
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import (Pattern, chain, clique, cycle, star,
                                      tailed_triangle)
from repro_torch.graph.generators import (erdos_renyi, small_world,
                                          triangle_rich)
from repro_torch.graph.storage import Graph

from test_torch_reference import port_graph, reference  # noqa: F401

HOUSE = Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)])
PATTERNS = [chain(3), clique(3), chain(4), cycle(4), clique(4),
            tailed_triangle(), chain(5), cycle(5), star(4), HOUSE,
            Pattern(5, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 4)])]
LABELLED = [
    Pattern(3, [(0, 1), (1, 2)], (0, 1, 0)),
    Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)], (0, 1, 0, 1)),
    Pattern(4, [(0, 1), (1, 2), (2, 3)], (1, 0, 0, 1)),
    Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4)], (0, 0, 1, 1, 0)),
    Pattern(3, [(0, 1), (1, 2)], (0, 5, 0)),      # label outside the alphabet
]
GRAPHS = [erdos_renyi(22, 4.0, seed=1), small_world(24, 4, 0.3, seed=2),
          triangle_rich(24, 4, seed=3)]
LGRAPH = triangle_rich(28, 4, seed=5, num_labels=2)


def _ref_graph(reference, g):
    from repro.graph.storage import Graph as RGraph
    return RGraph(g.n, g.edges, g.labels)


def _ref_pattern(reference, p):
    return reference.pattern.Pattern(p.n, sorted(p.edges), p.labels)


def _adj(g):
    return torch.from_numpy(g.dense_adjacency(np.float64, pad=False))


# -- the generators and graphs are the same on both sides ---------------------------

def test_generators_agree_with_reference(reference):
    G = reference.generators
    for ours, theirs in [
            (erdos_renyi(60, 6.0, seed=1), G.erdos_renyi(60, 6.0, seed=1)),
            (triangle_rich(28, 4, seed=5, num_labels=2),
             G.triangle_rich(28, 4, seed=5, num_labels=2)),
            (small_world(24, 4, 0.3, seed=2), G.small_world(24, 4, 0.3,
                                                            seed=2))]:
        assert ours.n == theirs.n
        assert np.array_equal(ours.edges, theirs.edges)
        assert (ours.labels is None) == (theirs.labels is None)
        if ours.labels is not None:
            assert np.array_equal(ours.labels, theirs.labels)
        back = port_graph(theirs)
        assert np.array_equal(back.edges, ours.edges)


# -- hom_count ------------------------------------------------------------------------

@pytest.mark.parametrize("pi", range(len(PATTERNS)))
def test_hom_count_closed_equals_reference(reference, pi):
    g, p = GRAPHS[0], PATTERNS[pi]
    with reference.x64():
        import jax.numpy as jnp
        want = float(reference.H.hom_count(
            _ref_pattern(reference, p),
            jnp.asarray(g.dense_adjacency(np.float64, pad=False))))
    assert TH.hom_count(p, _adj(g)).item() == want


@pytest.mark.parametrize("p,free", [
    (chain(3), (0, 2)), (chain(4), (0,)), (cycle(4), (0, 2)),
    (tailed_triangle(), (2,)), (chain(5), (0, 2, 4)), (HOUSE, (0, 1)),
    (star(4), (0,)),
])
def test_hom_count_free_equals_reference(reference, p, free):
    g = GRAPHS[2]
    with reference.x64():
        import jax.numpy as jnp
        want = np.asarray(reference.H.hom_count(
            _ref_pattern(reference, p),
            jnp.asarray(g.dense_adjacency(np.float64, pad=False)),
            free=free))
    got = TH.hom_count(p, _adj(g), free=free)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("budget", (1 << 27, 64, 7))
@pytest.mark.parametrize("p,free", [(chain(4), (0, 3)), (cycle(5), (0, 2)),
                                    (HOUSE, (0, 1)), (chain(5), ())])
def test_hom_count_budget_chunking_changes_nothing(p, free, budget):
    """Whatever the budget, the count is the same number — or the plan is
    refused as too wide (an (n, n) intermediate above 4x the budget)."""
    g = GRAPHS[1]
    want = TH.hom_count(p, _adj(g), free=free)
    n = g.n
    try:
        got = TH.hom_count(p, _adj(g), free=free, budget=budget)
    except TH.PlanTooWide:
        assert n ** 2 > 4 * budget
        return
    assert torch.equal(got, want)


def test_hom_count_chunked_path_is_taken_and_exact():
    g = GRAPHS[1]
    n = g.n
    budget = n * n // 2                  # (n, n) result: over budget, under cap
    calls = []
    orig = TH._pairwise_einsum

    def spy(idx_sets, arrays, out_idx):
        calls.append(tuple(a.shape for a in arrays))
        return orig(idx_sets, arrays, out_idx)

    TH._pairwise_einsum = spy
    try:
        got = TH.hom_count(chain(3), _adj(g), free=(0, 2), budget=budget)
    finally:
        TH._pairwise_einsum = orig
    assert any(shape[0][0] < n or shape[0][1] < n
               for shape in calls if len(shape[0]) == 2), calls
    assert torch.equal(got, _adj(g) @ _adj(g))


def test_pairwise_einsum_never_widens_beyond_the_step():
    """Three operands sharing the eliminated index: the pairwise order must
    not build an intermediate with more indices than inputs ∪ output."""
    n = 9
    rng = np.random.default_rng(0)
    A, B = (torch.from_numpy(rng.integers(0, 3, (n, n)).astype(np.float64))
            for _ in range(2))
    v = torch.from_numpy(rng.integers(0, 3, (n,)).astype(np.float64))
    got = TH._pairwise_einsum([(0, 1), (0, 2), (0,)], [A, B, v], (1, 2))
    assert torch.equal(got, torch.einsum("va,vb,v->ab", A, B, v))


@pytest.mark.parametrize("pi", range(len(LABELLED)))
def test_hom_count_labelled_equals_reference(reference, pi):
    p = LABELLED[pi]
    ref_eng = reference.counting.CountingEngine(_ref_graph(reference, LGRAPH))
    eng = CountingEngine(LGRAPH, device="cpu")
    assert eng.hom(p) == ref_eng.hom(_ref_pattern(reference, p))


# -- CountingEngine ---------------------------------------------------------------------

@pytest.mark.parametrize("gi", range(len(GRAPHS)))
def test_engine_hom_inj_edge_induced_equal_reference(reference, gi):
    g = GRAPHS[gi]
    ref_eng = reference.counting.CountingEngine(_ref_graph(reference, g))
    eng = CountingEngine(g, device="cpu")
    for p in PATTERNS:
        rp = _ref_pattern(reference, p)
        assert eng.hom(p) == ref_eng.hom(rp)
        assert eng.inj(p) == ref_eng.inj(rp)
        assert eng.edge_induced(p) == ref_eng.edge_induced(rp)
    assert eng.stats == ref_eng.stats


@pytest.mark.parametrize("p,free", [(chain(3), (0, 2)), (chain(4), (1,)),
                                    (cycle(4), (0, 2)), (chain(5), (0, 2, 4))])
def test_engine_hom_free_tensor_equals_reference(reference, p, free):
    g = GRAPHS[0]
    ref_eng = reference.counting.CountingEngine(_ref_graph(reference, g))
    eng = CountingEngine(g, device="cpu")
    want = np.asarray(ref_eng.hom_free_tensor(_ref_pattern(reference, p),
                                              free))
    got = eng.hom_free_tensor(p, free)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    assert eng.has_free_tensor(p, free) and not eng.has_hom(p)
    assert eng.hom_free_tensor(p, free) is got          # memo hit


def test_engine_inj_free_all_and_motif_table_equal_reference(reference):
    g = GRAPHS[2]
    ref_eng = reference.counting.CountingEngine(_ref_graph(reference, g))
    eng = CountingEngine(g, device="cpu")
    p = tailed_triangle()
    assert np.array_equal(eng.inj_free_all(p),
                          ref_eng.inj_free_all(_ref_pattern(reference, p)))
    ours = eng.motif_table(4)
    theirs = ref_eng.motif_table(4)
    assert {compile_key(p): v for p, v in ours.items()} == \
        {compile_key(p): v for p, v in theirs.items()}


def compile_key(p):
    return (p.n, tuple(sorted(p.edges)), p.labels)


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
@pytest.mark.parametrize("pi", range(len(PATTERNS)))
def test_edge_induced_matches_brute_force(gi, pi):
    g, p = GRAPHS[gi], PATTERNS[pi]
    eng = CountingEngine(g, device="cpu")
    assert eng.edge_induced(p) == brute_force_edge_induced(g, p)


@pytest.mark.parametrize("pi", range(len(LABELLED)))
def test_labelled_edge_induced_matches_brute_force(pi):
    p = LABELLED[pi]
    eng = CountingEngine(LGRAPH, device="cpu")
    assert eng.edge_induced(p) == brute_force_edge_induced(LGRAPH, p)


@pytest.mark.parametrize("p", [chain(3), clique(3), cycle(4), chain(4),
                               tailed_triangle()])
def test_vertex_induced_three_ways(p):
    g = GRAPHS[0]
    eng = CountingEngine(g, device="cpu")
    brute = brute_force_vertex_induced(g, p)
    assert eng.vertex_induced(p) == brute
    assert eng.vind_inj_oracle(p) / p.aut_order() == brute


def test_paper_running_example():
    g = Graph(4, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3)])
    eng = CountingEngine(g, device="cpu")
    assert eng.edge_induced(clique(3)) == 2
    assert eng.edge_induced(chain(3)) == 8
    assert eng.vertex_induced(chain(3)) == 2
    assert eng.vertex_induced(clique(3)) == 2


def test_engine_keeps_tensors_on_its_device_and_refuses_a_mesh():
    eng = CountingEngine(GRAPHS[0], device="cpu")
    assert eng.A.device.type == "cpu" and eng.A.dtype == torch.float64
    assert eng.labels is None
    leng = CountingEngine(LGRAPH, device="cpu")
    assert tuple(leng.labels.shape) == (2, LGRAPH.n)
    # a mesh is no longer refused: the engine binds it (on its first
    # slot's device) and counts without building the dense adjacency
    from repro_torch.distributed import meshes
    meng = CountingEngine(GRAPHS[0], mesh=meshes.data_mesh(2, device="cpu"))
    assert meng.device.type == "cpu" and meng.contract_shards() == 2
    assert meng.hom(chain(4)) == eng.hom(chain(4))
    assert meng._A_dense is None


def test_motif_patterns_agree_with_reference(reference):
    from repro.core.motifs import motif_patterns as ref_motifs
    for k in (3, 4, 5):
        assert [compile_key(p) for p in motif_patterns(k)] == \
            [compile_key(p) for p in ref_motifs(k)]
