"""The pattern-query batcher of the port (``repro_torch.serve.batching.
PatternQueryBatcher`` / ``PatternRequest``) vs the reference's, live, on
the CPU (``device="cpu"``).

Every case serves the same request stream through both packages' batchers
on the same graph (made by the reference's seeded generator, reaching the
port as numpy arrays) and compares every finished request — uid, counts,
supports, local vectors, hotspots (order included), ``from_cache``,
``done``, ``error`` — and the ``stats`` dicts.  The streams are the
inputs of the reference's ten batcher tests
(``tests/test_compiler.py``, ``test_labelled.py``,
``test_partial_embedding.py``, ``test_obs.py``, ``test_analysis.py``,
``test_morph.py``), each with its own assertions kept on the port's side,
plus ``top_k`` streams.  Where the port differs on purpose it is tested
alone: a ``KernelError`` propagates out of ``step()`` from the compile and
the serve phase, ``device=None`` means the card, and ``mesh=`` (a
``DataMesh`` of CPU slots) fans a group out over the slots.
Both sides share one APCT per graph.  Tolerance is **0**: exact
equality.
"""
import numpy as np
import pytest
import torch

from repro_torch import compiler as tcompiler
from repro_torch.compiler import lowering as tlowering
from repro_torch.compiler import morph as tmorph
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import (Pattern, chain, clique,
                                      tailed_triangle)
from repro_torch.kernels.build import KernelError
from repro_torch.serve.batching import PatternQueryBatcher, PatternRequest

from test_torch_reference import port_graph, reference, shared_apct  # noqa: F401,E501

LABELLED = [Pattern(3, [(0, 1), (1, 2)], (0, 1, 0)),
            Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)], (0, 1, 0, 1))]


@pytest.fixture(scope="module")
def graphs(reference):
    """name -> (reference graph, port graph): the reference tests'
    graphs."""
    G = reference.generators
    made = {"er24": G.erdos_renyi(24, 4.0, seed=1),
            "tri30-lab": G.triangle_rich(30, 4, seed=3, num_labels=2),
            "tri24": G.triangle_rich(24, 4, seed=4),
            "er48": G.erdos_renyi(48, 5.0, seed=4)}
    return {k: (g, port_graph(g)) for k, g in made.items()}


def _key(p):
    return (p.n, tuple(sorted(p.edges)), p.labels)


def _ref_pattern(reference, p):
    return reference.pattern.Pattern(p.n, sorted(p.edges), p.labels)


def _summary(req, arr):
    """One finished request, side-neutral; ``arr`` turns a local vector
    into a numpy array."""
    return {"uid": req.uid, "done": req.done, "error": req.error,
            "from_cache": req.from_cache,
            "counts": {_key(p): v for p, v in req.counts.items()},
            "supports": {_key(p): v for p, v in req.supports.items()},
            "local": {_key(p): (None if v is None else arr(v))
                      for p, v in req.local_counts.items()},
            "hotspots": {_key(p): list(v) for p, v in req.hotspots.items()}}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gl, wl = g.pop("local"), w.pop("local")
        assert g == w
        assert gl.keys() == wl.keys()
        for k in gl:
            if wl[k] is None:
                assert gl[k] is None
            else:
                assert gl[k].dtype == np.float64
                assert np.array_equal(gl[k], wl[k]), k


def _requests(specs, make_pattern, cls):
    return [cls(uid=s["uid"], patterns=tuple(make_pattern(p)
                                             for p in s["patterns"]),
                **{k: v for k, v in s.items()
                   if k not in ("uid", "patterns")})
            for s in specs]


def serve_both(reference, graphs, gname, specs, *, ref_kwargs=None,
               port_kwargs=None, **kwargs):
    """Serve ``specs`` through both batchers; returns (port batcher,
    reference batcher) after comparing every request and the stats."""
    from repro.serve.batching import PatternQueryBatcher as RBatcher
    from repro.serve.batching import PatternRequest as RRequest
    rg, tg = graphs[gname]
    rb = RBatcher(rg, apct=shared_apct("ref", rg, reference.APCT),
                  **kwargs, **(ref_kwargs or {}))
    for req in _requests(specs, lambda p: _ref_pattern(reference, p),
                         RRequest):
        rb.submit(req)
    rsteps = rb.run_to_completion()
    tb = PatternQueryBatcher(tg, apct=shared_apct("port", tg, TAPCT),
                             device="cpu", **kwargs, **(port_kwargs or {}))
    for req in _requests(specs, lambda p: p, PatternRequest):
        tb.submit(req)
    assert tb.run_to_completion() == rsteps
    _assert_same([_summary(r, lambda t: t.numpy()) for r in tb.finished],
                 [_summary(r, np.asarray) for r in rb.finished])
    assert dict(tb.stats) == dict(rb.stats)
    assert all(isinstance(v, int) for v in dict(tb.stats).values())
    return tb, rb


def _fail_compile(reference, monkeypatch, exc=RuntimeError):
    def boom(*a, **k):
        raise exc("compiler down")

    monkeypatch.setattr(reference.compiler, "compile", boom)
    monkeypatch.setattr(tcompiler, "compile", boom)


# -- the reference's batcher tests, held live ---------------------------------------

def test_pattern_query_batcher(reference, graphs):
    """test_compiler.py: compile once, execute many."""
    specs = [dict(uid=i, patterns=(chain(4), clique(3))) for i in range(5)]
    tb, _ = serve_both(reference, graphs, "er24", specs, max_batch=3)
    assert len(tb.finished) == 5
    assert tb.stats["compiles"] == 1 and tb.stats["cache_hits"] >= 1
    assert len(tb._plans) == 1
    eng = CountingEngine(graphs["er24"][1], device="cpu")
    want = {p: eng.edge_induced(p) for p in (chain(4), clique(3))}
    for req in tb.finished:
        assert req.done and req.counts == want


def test_pattern_query_batcher_survives_compile_failure(reference, graphs,
                                                         monkeypatch):
    """test_compiler.py: a compile failure other than ``KernelError``
    finishes every request through the direct path."""
    _fail_compile(reference, monkeypatch)
    specs = [dict(uid=i, patterns=(chain(4), clique(3))) for i in range(3)]
    tb, _ = serve_both(reference, graphs, "er24", specs, max_batch=2)
    assert len(tb.finished) == 3
    assert tb.stats["fallbacks"] == 3 and tb.stats["errors"] == 0
    assert all(r.done and not r.error for r in tb.finished)


def test_batcher_serves_support_requests(reference, graphs):
    """test_labelled.py: support and count requests on one labelled
    graph."""
    specs = [dict(uid=i, patterns=tuple(LABELLED), support=(i % 2 == 0))
             for i in range(4)]
    tb, _ = serve_both(reference, graphs, "tri30-lab", specs, max_batch=4)
    assert all(r.done and not r.error for r in tb.finished)
    assert all(r.supports for r in tb.finished if r.support)


def test_batcher_serves_local_requests(reference, graphs):
    """test_partial_embedding.py: anchored and unanchored local requests
    share one local plan."""
    specs = [dict(uid=i, patterns=(chain(4), tailed_triangle()), local=True,
                  anchor=(0 if i % 2 else None)) for i in range(4)]
    tb, _ = serve_both(reference, graphs, "tri24", specs, max_batch=4)
    assert tb.stats["compiles"] == 1
    eng = CountingEngine(graphs["tri24"][1], device="cpu")
    for req in tb.finished:
        for p in req.patterns:
            vec = req.local_counts[p]
            assert vec is not None
            assert vec.sum().item() == eng.edge_induced(p) * p.aut_order()


def test_batcher_local_fallback_on_compile_failure(reference, graphs,
                                                   monkeypatch):
    """test_partial_embedding.py: anchored vectors by the direct path."""
    _fail_compile(reference, monkeypatch)
    specs = [dict(uid=0, patterns=(chain(4), clique(4)), local=True,
                  anchor=0)]
    tb, _ = serve_both(reference, graphs, "tri24", specs, max_batch=2)
    assert tb.stats["fallbacks"] == 1 and not tb.finished[0].error


def test_batcher_fallback_compile_phase(reference, graphs, monkeypatch):
    """test_obs.py: the fallback counted under the compile phase."""
    _fail_compile(reference, monkeypatch)
    specs = [dict(uid=i, patterns=(chain(4),)) for i in range(2)]
    tb, _ = serve_both(reference, graphs, "er24", specs, max_batch=2)
    assert (tb.stats["fallbacks"], tb.stats["fallbacks_compile"],
            tb.stats["fallbacks_execute"], tb.stats["errors"]) == \
        (2, 2, 0, 0)


def test_batcher_fallback_execute_phase(reference, graphs, monkeypatch):
    """test_obs.py: a plan that refuses at run time lands in the execute
    bucket, and the direct path answers."""
    from repro.compiler.lowering import CompiledPlan as RPlan

    def boom(self, p):
        raise RuntimeError("PlanTooWide at execution")

    monkeypatch.setattr(RPlan, "count", boom)
    monkeypatch.setattr(tlowering.CompiledPlan, "count", boom)
    specs = [dict(uid=0, patterns=(chain(4),))]
    tb, _ = serve_both(reference, graphs, "er24", specs, max_batch=2)
    req = tb.finished[0]
    assert req.done and not req.error and not req.from_cache
    assert req.counts[chain(4)] == CountingEngine(
        graphs["er24"][1], device="cpu").edge_induced(chain(4))
    assert (tb.stats["fallbacks"], tb.stats["fallbacks_execute"],
            tb.stats["fallbacks_compile"]) == (1, 1, 0)


def test_batcher_stats_dict_compat(reference, graphs):
    """test_obs.py: the stats facade behaves like the old plain dict and
    mirrors into the registry's ``batcher.*`` counters."""
    from repro_torch import obs as tobs
    before = tobs.get("batcher.steps")
    specs = [dict(uid=0, patterns=(clique(3),))]
    tb, _ = serve_both(reference, graphs, "er24", specs, max_batch=2)
    assert tb.stats["steps"] == 1 and tb.stats["compiles"] == 1
    assert set(tb.stats) == {"steps", "compiles", "cache_hits", "fallbacks",
                             "fallbacks_compile", "fallbacks_execute",
                             "errors", "errors_compile", "errors_execute"}
    assert isinstance(dict(tb.stats)["steps"], int)
    assert tobs.get("batcher.steps") == before + 1


def test_batcher_verify_plans_param_threads_through(reference, graphs):
    """test_analysis.py: ``verify_plans=True`` with a fresh plan cache."""
    specs = [dict(uid=1, patterns=(chain(3),))]
    tb, _ = serve_both(reference, graphs, "er24", specs,
                       ref_kwargs=dict(cache=reference.compiler.PlanCache()),
                       port_kwargs=dict(cache=tcompiler.PlanCache()),
                       verify_plans=True)
    (done,) = tb.finished
    assert done.counts and not done.error


def test_batcher_threads_morph(reference, graphs):
    """test_morph.py: a batcher with a count store serves the counts a
    plain one serves, and fills the store as the reference's does."""
    from repro.compiler import morph as rmorph
    rstore, tstore = rmorph.CountStore(), tmorph.CountStore()
    specs = [dict(uid=i, patterns=(p,))
             for i, p in enumerate((chain(4), chain(3)))]
    tb, _ = serve_both(reference, graphs, "er48", specs,
                       ref_kwargs=dict(cache=reference.compiler.PlanCache(),
                                       morph=rstore),
                       port_kwargs=dict(cache=tcompiler.PlanCache(),
                                        morph=tstore))
    plain, _ = serve_both(reference, graphs, "er48", specs,
                          ref_kwargs=dict(
                              cache=reference.compiler.PlanCache()),
                          port_kwargs=dict(cache=tcompiler.PlanCache()))
    assert not any(r.error for r in tb.finished)
    assert {r.uid: r.counts for r in tb.finished} == \
        {r.uid: r.counts for r in plain.finished}
    assert len(tstore) == len(rstore) > 0


@pytest.mark.parametrize("fail", [False, True], ids=["compiled", "direct"])
def test_batcher_top_k_requests(reference, graphs, monkeypatch, fail):
    """``top_k`` requests group with the local ones and return (value,
    vertex) pairs in the reference's order, ties included — off the
    compiled plan, and by ``vertex_counts`` when the compile fails."""
    if fail:
        _fail_compile(reference, monkeypatch)
    specs = [dict(uid=0, patterns=(chain(4), tailed_triangle()), top_k=5),
             dict(uid=1, patterns=(chain(4), tailed_triangle()), local=True,
                  anchor=1),
             dict(uid=2, patterns=(chain(4), tailed_triangle()), top_k=24)]
    tb, _ = serve_both(reference, graphs, "tri24", specs, max_batch=4)
    top = tb.finished[2].hotspots[chain(4)]
    assert len(top) == 24 and top == sorted(top, key=lambda t: (-t[0], t[1]))
    assert tb.stats["compiles"] == (0 if fail else 1)


# -- where the port differs on purpose --------------------------------------------------

def _port_batcher(graphs, gname="er24", **kwargs):
    _, tg = graphs[gname]
    return PatternQueryBatcher(tg, apct=shared_apct("port", tg, TAPCT),
                               device="cpu", **kwargs)


def _kernel_error(*a, **k):
    raise KernelError("cutjoin_pair launch failed: CUDA error 98")


@pytest.mark.parametrize("where", ["compile", "count", "direct"])
def test_kernel_error_propagates_out_of_step(graphs, monkeypatch, where):
    """A kernel that would not build or launch is never hidden behind the
    direct path: from ``compile``, from ``CompiledPlan.count`` and from
    the direct path itself, ``KernelError`` leaves ``step()`` and no
    fallback or error is counted."""
    if where == "compile":
        monkeypatch.setattr(tcompiler, "compile", _kernel_error)
    elif where == "count":
        monkeypatch.setattr(tlowering.CompiledPlan, "count", _kernel_error)
    else:
        monkeypatch.setattr(tlowering.CompiledPlan, "count",
                            lambda self, p: 1 / 0)
        monkeypatch.setattr(CountingEngine, "edge_induced", _kernel_error)
    b = _port_batcher(graphs)
    b.submit(PatternRequest(uid=0, patterns=(chain(4),)))
    with pytest.raises(KernelError, match="CUDA error 98"):
        b.step()
    assert b.stats["fallbacks"] == 0 and b.stats["errors"] == 0
    assert b.finished == []


@pytest.mark.parametrize("where", ["compile", "count"])
def test_other_errors_keep_the_reference_fallback(graphs, monkeypatch,
                                                  where):
    """The same places raising ``RuntimeError``: the reference's direct
    path answers, counted under its phase."""
    def boom(*a, **k):
        raise RuntimeError("not a kernel")

    if where == "compile":
        monkeypatch.setattr(tcompiler, "compile", boom)
    else:
        monkeypatch.setattr(tlowering.CompiledPlan, "count", boom)
    b = _port_batcher(graphs)
    b.submit(PatternRequest(uid=0, patterns=(chain(4),)))
    assert b.step()
    (req,) = b.finished
    assert req.done and not req.error
    assert req.counts[chain(4)] == CountingEngine(
        graphs["er24"][1], device="cpu").edge_induced(chain(4))
    phase = "compile" if where == "compile" else "execute"
    assert (b.stats["fallbacks"], b.stats[f"fallbacks_{phase}"]) == (1, 1)


def test_errors_counted_when_the_direct_path_fails_too(graphs, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("down")

    monkeypatch.setattr(tcompiler, "compile", boom)
    monkeypatch.setattr(CountingEngine, "edge_induced", boom)
    b = _port_batcher(graphs)
    b.submit(PatternRequest(uid=0, patterns=(chain(4),)))
    b.run_to_completion()
    (req,) = b.finished
    assert req.done and req.error
    assert (b.stats["errors"], b.stats["errors_compile"],
            b.stats["fallbacks"]) == (1, 1, 0)


def test_device_none_means_the_card(graphs):
    _, tg = graphs["er24"]
    if torch.cuda.is_available():
        assert PatternQueryBatcher(tg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            PatternQueryBatcher(tg)


def test_mesh_raises_and_names_its_item(graphs):
    """Since the sharded tier is ported, ``mesh=`` no longer raises: a
    meshed batcher compiles against the mesh, fans a group of requests
    over its slots (``mesh.map_requests``) and serves the counts of a
    batcher without one."""
    from repro_torch import obs as tobs
    from repro_torch.distributed import meshes
    _, tg = graphs["er24"]
    pats = (Pattern(4, [(0, 1), (1, 2), (2, 3), (3, 0)]), chain(4))
    served = []
    for mesh in (None, meshes.data_mesh(3, device="cpu")):
        b = PatternQueryBatcher(tg, mesh=mesh, device="cpu",
                                apct=shared_apct("port", tg, TAPCT))
        for uid in range(4):
            b.submit(PatternRequest(uid=uid, patterns=pats))
        before = tobs.get("mesh.map_requests", devices=3)
        b.run_to_completion()
        moved = tobs.get("mesh.map_requests", devices=3) - before
        assert moved == (0 if mesh is None else 4)
        assert not any(r.error for r in b.finished)
        served.append([r.counts for r in b.finished])
    assert served[0] == served[1]
