"""The JAX reference, as the port's tests reach it.

The port (``repro_torch``) is held against the reference package
(``repro``) on the same inputs: graphs and factors are made with numpy
from a seed and handed to both.  Tolerance everywhere is **0** — exact
equality — since every compared quantity is an integer held in f64.

``reference`` is the one module-scoped fixture the ``test_torch_*``
files share.  It never clears the reference's metrics registry: those
counters are monotonic and the reference's own tests read what earlier
tests in the same process recorded; a comparison reads what moved
(``counters_moved``).  The reference reads ``jax.experimental.enable_x64``, which
recent jax releases no longer have; where it is missing the fixture
installs ``functools.partial(jax.enable_x64, True)`` for the duration of
the requesting module and removes it again at module teardown, so the
reference's own tests see the same jax before and after (under
``xdist --dist loadfile`` a worker runs several files in turn).
"""
import functools
import types

import numpy as np
import pytest

import jax

from repro_torch import interop

_APCTS = {}     # (side, graph signature) -> APCT, built once per test run


@pytest.fixture(scope="module")
def reference():
    """Namespace over the reference package, usable while the fixture is
    live: ``compiler``, ``obs``, ``ops``, ``H`` (homomorphism),
    ``counting``, ``pattern``, ``generators``, ``analysis``, ``matreduce``,
    ``bitset``, ``sddmm``, ``kref`` (the kernels' oracles)."""
    installed = not hasattr(jax.experimental, "enable_x64")
    if installed:
        jax.experimental.enable_x64 = functools.partial(jax.enable_x64, True)
    from repro import analysis, compiler, obs
    from repro.core import counting, homomorphism, pattern
    from repro.core.apct import APCT
    from repro.graph import generators
    from repro.kernels import bitset, matreduce, ops, sddmm
    from repro.kernels import ref as kref
    ns = types.SimpleNamespace(
        compiler=compiler, obs=obs, ops=ops, H=homomorphism,
        counting=counting, pattern=pattern, generators=generators,
        analysis=analysis, matreduce=matreduce, bitset=bitset, sddmm=sddmm,
        kref=kref, APCT=APCT, x64=jax.experimental.enable_x64)
    try:
        yield ns
    finally:
        if installed:
            del jax.experimental.enable_x64


def counters_moved(obs, before, names):
    """The reference's counters ``names`` as they moved since ``before``
    (an ``obs.snapshot()``): {name: {label string: increase}}, series that
    did not move left out — what a cleared registry would read after the
    same calls, with the registry left as it is."""
    now = obs.snapshot()
    moved = {}
    for name in names:
        was = before.get(name, {})
        moved[name] = {lbl: v - was.get(lbl, 0.0)
                       for lbl, v in now.get(name, {}).items()
                       if v != was.get(lbl, 0.0)}
    return moved


def port_graph(g):
    """The port's ``Graph`` for a reference graph, through numpy only."""
    return interop.graph_from_numpy(g.n, np.asarray(g.edges),
                                    None if g.labels is None
                                    else np.asarray(g.labels))


def shared_apct(side: str, graph, cls):
    """One APCT per graph and package for the whole test run (building one
    dominates a small compile); both sides seed it alike, so selection is
    identical."""
    from hashlib import sha256
    h = sha256(str(graph.n).encode() + np.asarray(graph.edges).tobytes()
               + (b"" if graph.labels is None
                  else np.asarray(graph.labels).tobytes())).hexdigest()
    key = (side, h)
    if key not in _APCTS:
        _APCTS[key] = cls(graph)
    return _APCTS[key]


def test_reference_counts_of_the_three_canonical_patterns(reference):
    """The reference itself, shimmed: the three patterns that reach the
    three join kernels on ``erdos_renyi(60, 6.0, seed=1)``."""
    P = reference.pattern
    g = reference.generators.erdos_renyi(60, 6.0, seed=1)
    pats = [P.tailed_triangle(), P.cycle(4), P.chain(5)]
    cp = reference.compiler.compile(
        pats, g, cache=False, apct=shared_apct("ref", g, reference.APCT))
    assert [cp.count(p) for p in pats] == [1377.0, 309.0, 69497.0]
    assert list(cp.plan.meta["styles"].values()) == \
        ["decomposed", "decomposed", "decomposed-subset"]
    assert list(cp.plan.meta["cuts"].values()) == [[2], [0, 2], [0, 2, 4]]
