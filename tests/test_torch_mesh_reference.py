"""The reference's own mesh tier vs the port's, plan node by plan node.

The reference shards over ``jax`` devices, so it runs in a subprocess
with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and the
``enable_x64`` attribute installed before it is imported (recent jax
releases removed it; ``test_torch_reference`` explains the shim).  There
it compiles four plans with ``mesh=data_mesh()``: the counts of four
patterns with a mesh-bound engine (``einsum-sharded`` contractions,
``kernel-sharded`` joins), anchored reads of a local plan
(``kernel-sharded-keep``), a local plan on a skewed graph whose guard
refusals take its ``xla-sharded`` route, and a local plan with the kernel
tier off (``xla-sharded-keep``).
The port compiles the same plans at four CPU slots.  Compared: the plan
JSON, every count, and per evaluated node its route (the reference's
``xla-*`` labels mapped to the port's), ``mesh_axes`` and
``num_shards``; every anchored vector against the reference's
single-device one and, but for the disagreement pinned in
``REFERENCE_MESH_ROUNDS``, its mesh one.  Tolerance is **0**.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch import compiler as tcompiler
from repro_torch import obs as tobs
from repro_torch.core.apct import APCT as TAPCT
from repro_torch.core.pattern import chain, cycle, tailed_triangle
from repro_torch.distributed import meshes
from repro_torch.graph.storage import Graph

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the reference's labels as the port names them on the CPU; on the card
# ``kernel-f64-sharded[-keep]`` (an f64 kernel instance on each slice)
# also stands where the reference takes ``xla-sharded[-keep]``, as
# ``kernel-f64`` / ``kernel-keep-f64`` stand for ``xla-dense`` / ``xla-keep``
ROUTE = {"xla-dense": "dense-f64", "xla-keep": "dense-f64-keep",
         "xla-sharded": "dense-f64-sharded",
         "xla-sharded-keep": "dense-f64-sharded-keep"}

_SHARED = """
    import numpy as np
    from repro.graph import generators as gen

    def hub_edges(n=300, hubs=10, p=0.1, seed=0):
        rng = np.random.default_rng(seed)
        iu, ju = np.triu_indices(n, 1)
        pick = (iu < hubs) | (rng.random(iu.shape) < p)
        return np.stack([iu[pick], ju[pick]], axis=1)

    def graphs():
        g = gen.erdos_renyi(72, 7.0, seed=3)
        return {"er72": (g.n, np.asarray(g.edges)),
                "hub300": (300, hub_edges())}
"""

_REFERENCE = """
    import functools, json
    import jax
    jax.experimental.enable_x64 = functools.partial(jax.enable_x64, True)
    from repro import compiler, obs
    from repro.core.pattern import Pattern, chain, cycle, tailed_triangle
    from repro.distributed import meshes
    from repro.graph.storage import Graph

    mesh = meshes.data_mesh()
    assert meshes.num_shards(mesh) == 4
    made = {k: Graph(n, e) for k, (n, e) in graphs().items()}
    out = {}
    for name, gname, pats, flags in PLANS:
        pats = [Pattern(n, edges) for n, edges in pats]
        cp = compiler.compile(pats, made[gname], cache=False, mesh=mesh,
                              **flags)
        cp.tracer = obs.Tracer()
        counts = [cp.count(p) for p in pats]
        anchored, single = {}, {}
        if flags.get("local"):
            one = compiler.compile(pats, made[gname], cache=False, **flags)
            for i, p in enumerate(pats):
                for orbit in p.vertex_orbits():
                    key = f"{i}@{orbit[0]}"
                    anchored[key] = np.asarray(
                        cp.local_counts(p, orbit[0])).tolist()
                    single[key] = np.asarray(
                        one.local_counts(p, orbit[0])).tolist()
        nodes = {}
        for s in cp.tracer.walk():
            if "route" in s.attrs:
                nodes.setdefault(s.name, [s.attrs["route"],
                                          s.attrs.get("mesh_axes"),
                                          s.attrs.get("num_shards")])
        out[name] = {"plan": cp.plan.to_json(), "counts": counts,
                     "anchored": anchored, "single": single,
                     "nodes": nodes}
    print(json.dumps(out))
"""

PLANS = [
    ("counts", "er72", [cycle(4), chain(4), chain(5), tailed_triangle()],
     {}),
    ("local", "er72", [cycle(4), chain(4)], {"local": True}),
    ("refused", "hub300", [cycle(4), chain(5)], {"local": True}),
    ("kernel-off", "er72", [chain(4)],
     {"local": True, "cutjoin_kernel": False}),
]
# Anchored vectors on which the reference's mesh route disagrees with its
# own single-device route (jax 0.9.0 with the shim): chain(5)'s anchors 0
# and 2 on the skewed graph read |cut| = 3 keep joins, which its
# ``sharded_cutjoin3_keep`` returns rounded to f32 (entries near 2e7 off
# by 1-2, near 1.9e8 off by 8).  The port equals the single-device route
# there (ROADMAP.md queue 3).
REFERENCE_MESH_ROUNDS = {"refused": {"1@0", "1@2"}}


def _shared():
    ns = {}
    exec(textwrap.dedent(_SHARED), ns)
    return ns["graphs"]()


@pytest.fixture(scope="module")
def reference_mesh():
    plans = [(name, g, [(p.n, sorted(p.edges)) for p in pats], flags)
             for name, g, pats, flags in PLANS]
    code = textwrap.dedent(_SHARED) + f"\nPLANS = {plans!r}\n" + \
        textwrap.dedent(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [p[0] for p in PLANS])
def test_mesh_plans_equal_the_reference_mesh_node_by_node(reference_mesh,
                                                          name):
    want = reference_mesh[name]
    _, gname, pats, flags = next(p for p in PLANS if p[0] == name)
    n, edges = _shared()[gname]
    g = Graph(n, edges)
    cp = tcompiler.compile(pats, g, cache=False,
                           mesh=meshes.data_mesh(4, device="cpu"),
                           apct=TAPCT(g), **flags)
    cp.tracer = tobs.Tracer()
    assert cp.plan.to_json() == want["plan"]
    assert [cp.count(p) for p in pats] == want["counts"]
    rounds = set()
    for i, p in enumerate(pats):
        for orbit in p.vertex_orbits() if flags.get("local") else ():
            key = f"{i}@{orbit[0]}"
            got = cp.local_counts(p, orbit[0]).numpy()
            assert np.array_equal(got, want["single"][key]), key
            if not np.array_equal(got, want["anchored"][key]):
                rounds.add(key)
    assert rounds == REFERENCE_MESH_ROUNDS.get(name, set())
    nodes = {}
    for s in cp.tracer.walk():
        if "route" in s.attrs:
            nodes.setdefault(s.name, [s.attrs["route"],
                                      s.attrs.get("mesh_axes"),
                                      s.attrs.get("num_shards")])
    mapped = {k: [ROUTE.get(r, r), ax, d]
              for k, (r, ax, d) in want["nodes"].items()}
    assert nodes == mapped
    routes = {r for r, _, _ in nodes.values()}
    assert {"counts": {"einsum-sharded", "kernel-sharded"},
            "local": {"kernel-sharded-keep"},
            "refused": {"dense-f64-sharded", "kernel-sharded-keep"},
            "kernel-off": {"dense-f64-sharded-keep"}}[name] <= routes, routes
