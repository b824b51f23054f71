"""The port's span tracer, its lowering hooks, ``mine --trace`` and the
drift report vs the reference's (``repro.obs``), on the CPU.

Each tracing test traces the same plan in both packages — the pattern
made from the same edges, the graph from the reference's seeded
generator reaching the port as numpy arrays, one APCT per graph and
side — and compares the span trees: names, kinds, nesting and every
attribute (``op``, ``predicted``, ``cut_size``, ``factor_shapes``,
``exact_block``, ``precertified``, ``early_exit``, ``error``, ``route``).
Routes compare under the documented mapping (``compiler/lowering.py``):
the reference's ``xla-dense`` is the port's ``dense-f64`` and its
``xla-keep`` is ``dense-f64-keep``; every other route name is shared.
Times are not compared.  The drift functions are held to the
reference's on the same trace dict and on synthetic pairs.  Tolerance
is **0**: exact equality.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro_torch import compiler as tcompiler
from repro_torch import obs as tobs
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.counting import CountingEngine
from repro_torch.core.motifs import motif_patterns
from repro_torch.core.pattern import Pattern, chain, cycle
from repro_torch.launch import mine as tmine
from repro_torch.obs import drift as tdrift
from repro_torch.obs import trace as ttrace

from test_torch_reference import port_graph, reference, shared_apct  # noqa: F401,E501

ROUTES = {"xla-dense": "dense-f64", "xla-keep": "dense-f64-keep"}
K5_MINUS_EDGE = Pattern(5, [(u, v) for u in range(5)
                            for v in range(u + 1, 5) if (u, v) != (3, 4)])
# the reference's property test draws from these four patterns
NESTING = {"cycle4": cycle(4), "chain4": chain(4), "k5-minus-edge":
           K5_MINUS_EDGE, "cycle5": cycle(5)}


def tree(span, routes=None):
    """A span and its subtree without times: (name, kind, attrs,
    children), the route renamed by ``routes``."""
    attrs = dict(span.attrs)
    if routes and attrs.get("route") in routes:
        attrs["route"] = routes[attrs["route"]]
    return (span.name, span.kind, attrs,
            [tree(c, routes) for c in span.children])


def dict_tree(span: dict):
    """The same for a span of ``to_dict``."""
    return (span["name"], span["kind"], span["attrs"],
            [dict_tree(c) for c in span["children"]])


@pytest.fixture(scope="module")
def graphs(reference):
    rg = reference.generators.erdos_renyi(24, 4.0, seed=1)
    return rg, port_graph(rg)


@pytest.fixture(scope="module")
def traced(reference, graphs):
    """(pattern name, cutjoin_kernel, local) -> both sides' tracer and
    plan after one traced ``count``, computed once per module (each side
    on a fresh engine, as the reference's ``_traced`` does)."""
    rg, tg = graphs
    memo = {}

    def run(name, kernel=True, local=False):
        key = (name, kernel, local)
        if key not in memo:
            p = NESTING[name]
            rp = reference.pattern.Pattern(p.n, sorted(p.edges))
            rtr = reference.obs.Tracer()
            rcp = reference.compiler.compile(
                rp, rg, counter=reference.counting.CountingEngine(rg),
                cache=False, cutjoin_kernel=kernel, local=local,
                apct=shared_apct("ref", rg, reference.APCT))
            rcp.tracer = rtr
            rcount = rcp.count(rp)
            ttr = tobs.Tracer()
            tcp = tcompiler.compile(
                p, tg, counter=CountingEngine(tg, device="cpu"),
                cache=False, cutjoin_kernel=kernel, local=local,
                apct=shared_apct("port", tg, TAPCT))
            tcp.tracer = ttr
            tcount = tcp.count(p)
            memo[key] = dict(p=p, rp=rp, rtr=rtr, rcp=rcp, ttr=ttr, tcp=tcp,
                             rcount=rcount, tcount=tcount)
        return memo[key]

    return run


def assert_same_trees(r):
    assert [tree(s) for s in r["ttr"].roots] == \
        [tree(s, ROUTES) for s in r["rtr"].roots]


# -- the tracer over lowering ------------------------------------------------------

def test_golden_trace_shape_3cut(traced):
    """The reference's trace-shape lock on the K5-minus-edge tri join,
    held on the port and tree for tree against the reference's."""
    r = traced("k5-minus-edge")
    assert r["tcount"] == r["rcount"]
    assert_same_trees(r)
    tr, cp = r["ttr"], r["tcp"]
    (root,) = tr.roots
    assert root.kind == "execute" and root.attrs["op"] == "count"
    (shrink,) = root.children
    assert shrink.kind == "ShrinkageCorrect"
    assert shrink.attrs["route"] == "host"
    assert [c.kind for c in shrink.children] == ["CutJoin", "MobiusCombine"]
    join, mob = shrink.children
    assert join.attrs["cut_size"] == 3 and join.attrs["route"] == "kernel"
    assert join.attrs["exact_block"] is not None
    assert join.attrs["predicted"] is not None
    assert all(all(d == cp.graph.n for d in s)
               for s in join.attrs["factor_shapes"])
    assert all(c.kind == "Contract" and c.attrs["route"] == "einsum-free"
               for c in join.children)
    assert [c.kind for c in mob.children] == ["Intersect"]
    assert mob.children[0].attrs["route"] == "enumeration"
    # each join span's route is its join_log record's
    (rec,) = cp.join_log
    assert (rec["node"], rec["route"], rec["block"]) == \
        (join.name, join.attrs["route"], join.attrs["exact_block"])
    # second read: everything memoised, only a new root on either side
    n_before = sum(1 for _ in tr.walk())
    cp.count(r["p"])
    r["rcp"].count(r["rp"])
    assert sum(1 for _ in tr.walk()) == n_before + 1
    assert_same_trees(r)


def test_trace_route_dense_when_kernel_off(traced):
    """``cutjoin_kernel=False``: every join on the dense f64 route, the
    reference's ``xla-dense``; the count equals the kernel route's."""
    r = traced("k5-minus-edge", kernel=False)
    assert_same_trees(r)
    joins = [s for s in r["ttr"].walk() if s.kind == "CutJoin"]
    assert joins and all(s.attrs["route"] == "dense-f64" for s in joins)
    assert [j["route"] for j in r["tcp"].join_log] == ["dense-f64"] * \
        len(joins)
    assert r["tcount"] == traced("k5-minus-edge")["tcount"]


def test_trace_coverage_and_self_time(traced):
    tr = traced("k5-minus-edge")["ttr"]
    cov = tr.coverage()
    assert cov is not None and 0.95 <= cov <= 1.0 + 1e-9
    for s in tr.walk():
        child_total = sum(c.duration_s for c in s.children)
        assert s.duration_s >= 0.0
        assert abs(s.self_s - max(0.0, s.duration_s - child_total)) < 1e-12


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "dense"])
@pytest.mark.parametrize("name", sorted(NESTING))
def test_span_nesting_matches_ir_structure(traced, name, kernel):
    """The trace tree is a subtree of the plan DAG (every node span's
    children are refs of that node, guard scans aside) and equals the
    reference's — the reference's property test, over each of its
    patterns and both join settings."""
    r = traced(name, kernel=kernel)
    assert r["tcount"] == r["rcount"]
    assert_same_trees(r)
    cp = r["tcp"]
    for s in r["ttr"].walk():
        if s.kind == "execute":
            assert len(s.children) <= 1
            continue
        if s.kind == "guard-scan":
            assert not s.children
            continue
        node = cp.plan.nodes[s.name]
        assert type(node).__name__ == s.kind
        refs = set(node.refs())
        for c in s.children:
            assert c.kind == "guard-scan" or c.name in refs


@pytest.mark.parametrize("name", ["k5-minus-edge", "cycle4"])
def test_guard_scan_span_when_no_certificate(reference, graphs, monkeypatch,
                                             name):
    """With the static certificate withheld on both sides, each join
    scans its factors under a ``guard:<key>`` span of kind
    ``guard-scan`` nested in the join's span, and the join carries the
    granted ``exact_block`` without ``precertified``."""
    from repro.compiler.lowering import CompiledPlan as RPlan
    from repro_torch.compiler.lowering import CompiledPlan as TPlan
    for cls in (RPlan, TPlan):
        monkeypatch.setattr(cls, "_precertified", lambda self: {})
    rg, tg = graphs
    p = NESTING[name]
    rp = reference.pattern.Pattern(p.n, sorted(p.edges))
    trees = []
    for side, comp, g, q, eng, apct, obs in (
            ("ref", reference.compiler, rg, rp,
             reference.counting.CountingEngine(rg), reference.APCT,
             reference.obs),
            ("port", tcompiler, tg, p, CountingEngine(tg, device="cpu"),
             TAPCT, tobs)):
        cp = comp.compile(q, g, counter=eng, cache=False,
                          apct=shared_apct(side, g, apct))
        cp.tracer = obs.Tracer()
        cp.count(q)
        trees.append(cp.tracer)
    rtr, ttr = trees
    assert [tree(s) for s in ttr.roots] == \
        [tree(s, ROUTES) for s in rtr.roots]
    joins = [s for s in ttr.walk() if s.kind == "CutJoin"]
    assert joins
    for j in joins:
        scans = [c for c in j.children if c.kind == "guard-scan"]
        assert [c.name for c in scans] == [f"guard:{j.name}"]
        assert j.attrs["exact_block"] is not None
        assert "precertified" not in j.attrs


def test_trace_of_every_public_read(reference, graphs):
    """Roots of ``counts``, ``local_counts``, ``exists`` and ``domains`` /
    ``mini_support`` on a ``local=True, domains=True`` plan, with the
    keep-axis joins and their guard scans, tree for tree; then
    ``exists`` on a plan whose factor is all zero (the early exit)."""
    rg, tg = graphs
    pats = [chain(4), Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)])]
    rpats = [reference.pattern.Pattern(p.n, sorted(p.edges)) for p in pats]
    sides = []
    for side, comp, g, ps, eng, apct in (
            ("ref", reference.compiler, rg, rpats,
             reference.counting.CountingEngine(rg), reference.APCT),
            ("port", tcompiler, tg, pats, CountingEngine(tg, device="cpu"),
             TAPCT)):
        cp = comp.compile(ps, g, counter=eng, cache=False, local=True,
                          domains=True, apct=shared_apct(side, g, apct))
        tr = (reference.obs if side == "ref" else tobs).Tracer()
        cp.tracer = tr
        cp.counts()
        for p in ps:
            for orbit in p.vertex_orbits():
                cp.local_counts(p, orbit[0])
            if cp.has_local(p):
                cp.local_counts(p)
            cp.exists(p)
            cp.mini_support(p)
        sides.append(tr)
    rtr, ttr = sides
    assert [tree(s) for s in ttr.roots] == \
        [tree(s, ROUTES) for s in rtr.roots]
    ops = {s.attrs["op"] for s in ttr.roots}
    assert ops == {"counts", "local_counts", "exists", "domains"}

    # a 5-clique on a graph with no 5-clique but with the other factor
    # nonzero: the early exit annotates the exists root
    sides = []
    for side, comp, g, p, eng, apct in (
            ("ref", reference.compiler, rg,
             reference.pattern.Pattern(6, sorted(
                 {(u, v) for u in range(5) for v in range(u + 1, 5)}
                 | {(4, 5)})),
             reference.counting.CountingEngine(rg), reference.APCT),
            ("port", tcompiler, tg,
             Pattern(6, sorted({(u, v) for u in range(5)
                                for v in range(u + 1, 5)} | {(4, 5)})),
             CountingEngine(tg, device="cpu"), TAPCT)):
        cp = comp.compile(p, g, counter=eng, cache=False, local=True,
                          apct=shared_apct(side, g, apct))
        tr = (reference.obs if side == "ref" else tobs).Tracer()
        cp.tracer = tr
        assert cp.exists(p) is False
        sides.append(tr)
    rtr, ttr = sides
    assert [tree(s) for s in ttr.roots] == \
        [tree(s, ROUTES) for s in rtr.roots]
    assert ttr.roots[0].attrs.get("early_exit") is True


def test_tracer_annotate_and_error_attr(reference):
    trees = []
    for obs in (reference.obs, tobs):
        tr = obs.Tracer()
        with pytest.raises(ValueError):
            with tr.span("boom"):
                tr.annotate(x=1)
                raise ValueError("nope")
        assert tr.roots[0].attrs == {"x": 1, "error": "ValueError"}
        tr.annotate(y=2)                    # outside any span: no-op
        assert "y" not in tr.roots[0].attrs
        assert tr.current() is None
        trees.append([tree(s) for s in tr.roots])
    assert trees[0] == trees[1]


def test_trace_exports(traced, tmp_path):
    r = traced("k5-minus-edge")
    tr = r["ttr"]
    d = tr.to_dict()
    assert d["meta"]["backend"] == "cpu"        # the plan's device
    assert d["coverage"] is not None
    assert d["spans"][0]["kind"] == "execute"
    assert d["spans"][0]["children"][0]["dur_us"] >= 0
    json.loads(tr.to_json())
    rd = r["rtr"].to_dict()
    assert [dict_tree(s) for s in json.loads(tr.to_json())["spans"]] == \
        [dict_tree(s) for s in json.loads(r["rtr"].to_json())["spans"]]
    assert set(d) == set(rd) and \
        set(d["spans"][0]) == set(rd["spans"][0])

    chrome = tr.to_chrome()
    assert len(chrome["traceEvents"]) == sum(1 for _ in tr.walk())
    assert all(e["ph"] == "X" and e["dur"] >= 0
               for e in chrome["traceEvents"])
    json.dumps(chrome)
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
             for e in chrome["traceEvents"]]
    rstrip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
              for e in r["rtr"].to_chrome()["traceEvents"]]
    assert strip == rstrip

    p1 = tr.save(str(tmp_path / "t.json"))
    p2 = tr.save(str(tmp_path / "t.chrome.json"))
    assert "spans" in json.load(open(p1))
    assert "traceEvents" in json.load(open(p2))


def test_untraced_plan_opens_no_spans(traced, monkeypatch):
    """Untraced, a node eval is one ``is None`` check: no span, no
    fence."""
    cp = traced("cycle4")["tcp"]
    fresh = tcompiler.lower(cp.plan, cp.graph, device="cpu")
    assert fresh.tracer is None

    def no_fence(value):
        raise AssertionError("an untraced plan fenced a value")

    monkeypatch.setattr(tobs, "fence", no_fence)
    assert fresh.count(cycle(4)) == traced("cycle4")["tcount"]


def test_plan_meta_node_costs(traced):
    """The predicted side of the drift pairs: finite per-node costs keyed
    into ``plan.nodes``, equal to the reference's, and a prediction on
    every span of a traced count."""
    r = traced("k5-minus-edge", local=True)
    costs = r["tcp"].plan.meta["node_costs"]
    assert costs and costs == r["rcp"].plan.meta["node_costs"]
    for k, v in costs.items():
        assert k in r["tcp"].plan.nodes and np.isfinite(v) and v >= 0.0
    tcp, rcp = r["tcp"], r["rcp"]
    tcp.tracer, rcp.tracer = tobs.Tracer(), type(r["rtr"])()
    for cp, p in ((tcp, r["p"]), (rcp, r["rp"])):
        cp._values.clear()
        cp.count(p)
    for s in tcp.tracer.walk():
        if s.kind != "execute":
            assert s.attrs["predicted"] is not None, s.name
    assert [tree(s) for s in tcp.tracer.roots] == \
        [tree(s, ROUTES) for s in rcp.tracer.roots]


# -- fence -------------------------------------------------------------------------

class _FakeCuda:
    """Stands for a CUDA tensor: what ``fence`` reads of one."""
    is_cuda = True

    def __init__(self, index):
        self.device = torch.device("cuda", index)


@pytest.mark.parametrize("value", [
    _FakeCuda(0), (1.0, _FakeCuda(0)), [_FakeCuda(0)],
    {"a": [2, _FakeCuda(0)]},
], ids=["tensor", "tuple", "list", "dict"])
def test_fence_raises_what_synchronize_raises(monkeypatch, value):
    """A launch error surfaces at the synchronize; the fence must not
    swallow it (the reference's fence catches everything)."""
    calls = []

    def failing(device=None):
        calls.append(device)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ttrace.fence(value)
    assert calls == [torch.device("cuda", 0)]


def test_fence_syncs_each_device_once_and_skips_host_values(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    host = (1.0, np.zeros(3), torch.zeros(2), {"x": [3]}, None)
    assert ttrace.fence(host) is host and calls == []
    both = [_FakeCuda(0), (_FakeCuda(1), _FakeCuda(0))]
    assert ttrace.fence(both) is both
    assert sorted(d.index for d in calls) == [0, 1]


def test_exports_of_obs(reference):
    for name in ("Tracer", "Span", "fence", "drift"):
        assert hasattr(reference.obs, name) and hasattr(tobs, name)
        assert name in tobs.__all__
    assert set(reference.obs.__all__) == set(tobs.__all__)


# -- mine --trace ------------------------------------------------------------------

def test_mine_trace_writes_the_spans_of_a_directly_traced_plan(tmp_path):
    """``mine --app motif --trace FILE`` on a small graph: the file holds
    the span tree of the same plan compiled and traced directly (one
    ``count`` root per motif), and the reference's summary line."""
    path = str(tmp_path / "motif.json")
    argv = ["--app", "motif", "--k", "4", "--graph", "er", "--n", "40",
            "--deg", "5", "--device", "cpu", "--trace", path]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmine.main(argv)
    lines = buf.getvalue().splitlines()
    pats = motif_patterns(4)
    saved = json.load(open(path))
    assert lines[-1].startswith(f"trace: {path} ({len(pats)} root spans, "
                                f"node coverage ")
    g = tmine.build_graph(tmine.argparse.Namespace(
        graph="er", n=40, deg=5.0, seed=0, labels=0))
    cp = tcompiler.compile(pats, g, cache=False, device="cpu")
    tr = tobs.Tracer()
    cp.tracer = tr
    for p in pats:
        cp.count(p)
    assert [dict_tree(s) for s in saved["spans"]] == \
        [dict_tree(s) for s in tr.to_dict()["spans"]]
    assert saved["meta"] == tr.meta


# -- drift -------------------------------------------------------------------------

SYNTHETIC = [
    {"cls": "Contract", "cut": None, "route": "einsum",
     "backend": "cpu", "predicted": 1.0, "measured_us": 10.0},
    {"cls": "Contract", "cut": None, "route": "einsum",
     "backend": "cpu", "predicted": 2.0, "measured_us": 40.0},
    {"cls": "CutJoin", "cut": 2, "route": "kernel",
     "backend": "cpu", "predicted": 5.0, "measured_us": 5.0},
]


@pytest.mark.parametrize("xs, ys", [
    ([1, 2, 3], [10, 20, 30]), ([1, 2, 3], [30, 20, 10]),
    ([1, 2, 3, 4], [1, 3, 2, 4]), ([1, 1, 2], [1, 2, 3]), ([1], [2]),
    ([1, 1], [2, 3]), ([1, 2], [2, 3, 4]), ([3, 3, 1, 2, 3], [5, 4, 4, 1, 0]),
])
def test_ranks_and_spearman_equal_the_reference(reference, xs, ys):
    from repro.obs import drift as rdrift
    assert tdrift._ranks(list(xs)) == rdrift._ranks(list(xs))
    assert tdrift.spearman(xs, ys) == rdrift.spearman(xs, ys)


def test_drift_of_both_traces_equals_the_reference(reference, traced):
    """``pairs_from_trace`` and ``aggregate`` of each package's trace
    dict, by both packages' functions: equal; and the port's trace
    groups as the reference's under the route mapping."""
    from repro.obs import drift as rdrift
    r = traced("k5-minus-edge")
    for d in (r["ttr"].to_dict(), r["rtr"].to_dict()):
        tp, rp = tdrift.pairs_from_trace(d), rdrift.pairs_from_trace(d)
        assert tp == rp and tp
        assert tdrift.aggregate(tp) == rdrift.aggregate(rp)
        assert tdrift.render(tdrift.aggregate(tp)) == \
            rdrift.render(rdrift.aggregate(rp))
        assert tdrift.bench_summary(tdrift.aggregate(tp)) == \
            rdrift.bench_summary(rdrift.aggregate(rp))
    tkeys = [tdrift.group_key(p) for p in
             tdrift.pairs_from_trace(r["ttr"].to_dict())]
    rkeys = [tdrift.group_key(p) for p in
             tdrift.pairs_from_trace(r["rtr"].to_dict())]
    assert tkeys == rkeys and "CutJoin|cut=3|kernel" in tkeys
    assert all(p["cls"] in tdrift.NODE_KINDS for p in
               tdrift.pairs_from_trace(r["ttr"].to_dict()))


def test_drift_aggregate_synthetic(reference):
    from repro.obs import drift as rdrift
    got = tdrift.aggregate(SYNTHETIC)
    assert got == rdrift.aggregate(SYNTHETIC)
    g = got["groups"]["Contract|cut=-|einsum"]
    assert g["n"] == 2 and g["rank_corr"] == pytest.approx(1.0)
    assert g["ratio_spread"] == pytest.approx(2.0)
    assert got["groups"]["CutJoin|cut=2|kernel"]["ratio_spread"] is None


def test_drift_cli_reads_both_files(reference, traced, tmp_path, capsys):
    """``python -m repro_torch.obs.drift`` over a port trace, a reference
    trace and a ``drift_pairs`` table: the reference CLI's report."""
    from repro.obs import drift as rdrift
    r = traced("k5-minus-edge")
    files = [r["ttr"].save(str(tmp_path / "port.json")),
             r["rtr"].save(str(tmp_path / "ref.json"))]
    table = tmp_path / "pairs.json"
    table.write_text(json.dumps({"drift_pairs": SYNTHETIC}))
    files.append(str(table))
    for args in (files, files + ["--json"]):
        want = rdrift.main(args)
        rout = capsys.readouterr().out
        got = tdrift.main(args)
        assert got == want and capsys.readouterr().out == rout
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="neither a trace"):
        tdrift.load_pairs(str(bad))
