#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

It imports only ``repro_torch`` (from ``src/`` beside this file) and
exits non-zero on any failure.  Phases, each printing one JSON line:

1. ``device``     the card's name and power limit; fails without CUDA.
2. ``kernel_cases``  builds ``csrc/cutjoin.cu`` with nvcc and holds each
   join kernel (vector, pair, tri) against its plain PyTorch version on
   the card, at n = 8192, over factor counts, rectangular slices with
   offsets, axis-subset mixes and chunk sizes 8 / 128 / 1024.  Tolerance:
   none — the difference must be 0 (integer-valued factors within the
   exactness guard).
3. ``main_path``  ``compile(patterns, graph)`` on ``rmat(13, 24.0, seed=0)``
   (8192 vertices, about 10^5 edges, skewed degrees: the user's graph),
   then the same call on a *coverage graph*, ``erdos_renyi(8192, 24.0,
   seed=0)`` (same size, uniform degrees).  The coverage graph is not
   claimed to be what users bring: it is there because on it the cost
   model cuts chain(5) three ways and every join is precertified, so the
   entry points reach all three kernels.  Each graph: ``.counts()`` twice,
   a second compile that hits the plan cache; every count is checked
   against the f64 dense route (``cutjoin_kernel=False``; where that route
   refuses a |cut| = 3 join as too wide, against the direct Möbius count
   of ``CountingEngine.edge_induced``), and ``cycle(4)`` against the closed
   form (tr(A^4) - 2 Σd² + Σd) / 8.  Launches are reported per graph;
   which joins the R-MAT graph leaves to the dense route is said plainly.
4. ``kernels``    per kernel: launches over phase 3 (and on each graph
   apart), error against the plain version, time, the plain version's
   time, the card's bound for the timed function and a PyTorch yardstick
   for it, at the shapes phase 3 gave the kernel.
5. last line: ``{"ok": true, "device": {...}}``.

No phase catches a failure and carries on.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

from repro_torch import compiler, obs                       # noqa: E402
from repro_torch.core.apct import APCT                      # noqa: E402
from repro_torch.core.counting import CountingEngine        # noqa: E402
from repro_torch.core.homomorphism import PlanTooWide       # noqa: E402
from repro_torch.core.motifs import motif_patterns          # noqa: E402
from repro_torch.core.pattern import (chain, cycle,         # noqa: E402
                                      tailed_triangle)
from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: E402
from repro_torch.kernels import build as kbuild             # noqa: E402
from repro_torch.kernels import matreduce as mr             # noqa: E402

DEV = torch.device("cuda")
N = 8192
# published peaks of one H100 SXM (NVIDIA data sheet): memory rate and the
# f32 rate outside the tensor cores, which is what the join kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/cutjoin.cu"


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_factor(rng, shape, hi: int) -> torch.Tensor:
    """Seeded integer-valued f64 factor with entries in [0, hi]."""
    return torch.from_numpy(
        rng.integers(0, hi + 1, size=shape).astype(np.float64)).to(DEV)


def max_value(nf: int, block: int, cells: int = 1) -> int:
    """Largest per-factor magnitude hi for ``nf`` factors such that the
    guard admits chunk ``block`` (hi^nf * block <= 2^24) and the whole
    sum over ``cells`` cells stays an exact f64 integer (hi^nf * cells <=
    2^53)."""
    cap = min(mr.EXACT_LIMIT / block, float(1 << 53) / cells)
    hi = int(cap ** (1.0 / nf))
    while (hi + 1) ** nf <= cap:
        hi += 1
    while hi ** nf > cap:
        hi -= 1
    return max(hi, 1)


# -- phase 1 ------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))
    return smi


# -- phase 2 ------------------------------------------------------------------------

def check_case(kernel: str, name: str, run_kernel, run_plain, cases: list):
    before = dict(mr.launches)
    got = run_kernel()
    torch.cuda.synchronize()
    assert mr.launches[kernel] == before[kernel] + 1, \
        f"{name}: wrapper did not launch {kernel}"
    t0 = time.perf_counter()
    want = run_plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = abs(got - want)
    cases.append({"kernel": kernel, "case": name, "value": got,
                  "max_abs_err": diff, "plain_s": round(plain_s, 4)})
    if diff != 0:
        raise AssertionError(f"{name}: kernel {got!r} != plain {want!r}")


def phase_kernel_cases():
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    mr._lib()                                # builds csrc/cutjoin.cu
    build_s = time.perf_counter() - t0
    cases: list = []
    blocks = (8, 128, 1024)

    # K1: 1-4 vector factors
    for k in (1, 2, 3, 4):
        for block in blocks:
            fs = [int_factor(rng, (N,), max_value(k, block))
                  for _ in range(k)]
            check_case("vecjoin", f"vec k={k} block={block}",
                       lambda: mr.prod_reduce(fs, block=block),
                       lambda: mr.prod_reduce_plain(fs, block=block), cases)

    # K2: square, and a rectangular row slice with non-zero offsets
    for k in (1, 2, 3):
        for block in blocks:
            hi = max_value(k, block)
            fs = [int_factor(rng, (N, N), hi) for _ in range(k)]
            for distinct in (True, False):
                check_case(
                    "pairjoin",
                    f"pair square k={k} block={block} distinct={distinct}",
                    lambda: mr.prod_reduce(fs, distinct=distinct,
                                           block=block),
                    lambda: mr.prod_reduce_plain(fs, distinct=distinct,
                                                 block=block), cases)
            rows, start = 1000, 3001
            sl = [F[start:start + rows] for F in fs]
            check_case(
                "pairjoin", f"pair slice {rows}x{N} offsets=({start},0) "
                            f"k={k} block={block}",
                lambda: mr.prod_reduce(sl, block=block, offsets=(start, 0)),
                lambda: mr.prod_reduce_plain(sl, block=block,
                                             offsets=(start, 0)), cases)
            del fs, sl

    # K4: axis-subset mixes at n = 8192
    mixes = {
        "tri (0,1)+(1,2)": [(0, 1), (1, 2)],
        "tri (0,1)+(1,2)+(0,2)": [(0, 1), (1, 2), (0, 2)],
        "tri (0,1)+(1,2)+(2,)": [(0, 1), (1, 2), (2,)],
    }
    for label, axes in mixes.items():
        for block in blocks:
            hi = max_value(len(axes), block, N ** 3)
            fs = [int_factor(rng, (N,) * len(ax), hi) for ax in axes]
            check_case(
                "trijoin", f"{label} n={N} block={block}",
                lambda: mr.tri_reduce(fs, axes, n=N, block=block),
                lambda: mr.tri_reduce_plain(fs, axes, n=N, block=block),
                cases)
            del fs
    # K4: a full 3-D factor at n = 256 beside one, two and three factors
    # that span axes 0 and 1 (the kernel's compile-time and run-time
    # paths for such factors), masked and unmasked, and as an axis-0 slice
    # with offsets
    n3 = 256
    mixes3 = [[(0, 1, 2), (0, 2)], [(0, 1, 2), (0, 1), (1, 2)],
              [(0, 1, 2), (0, 1), (0, 1), (2,)]]
    for axes in mixes3:
        label = "+".join(str(ax).replace(" ", "") for ax in axes)
        for block in blocks:
            hi = max_value(len(axes), block)
            fs = [int_factor(rng, (n3,) * len(ax), hi) for ax in axes]
            for distinct in (True, False):
                check_case(
                    "trijoin", f"tri {label} n={n3} block={block} "
                               f"distinct={distinct}",
                    lambda: mr.tri_reduce(fs, axes, n=n3, distinct=distinct,
                                          block=block),
                    lambda: mr.tri_reduce_plain(fs, axes, n=n3,
                                                distinct=distinct,
                                                block=block), cases)
            sl = [F[100:150] if 0 in ax else F for F, ax in zip(fs, axes)]
            check_case(
                "trijoin", f"tri {label} slice (50,{n3},{n3}) "
                           f"offsets=(100,0,0) block={block}",
                lambda: mr.tri_reduce(sl, axes, n=(50, n3, n3), block=block,
                                      offsets=(100, 0, 0)),
                lambda: mr.tri_reduce_plain(sl, axes, n=(50, n3, n3),
                                            block=block, offsets=(100, 0, 0)),
                cases)
    # surplus factors beyond the kernel's table are folded exactly
    fs = [int_factor(rng, (N,), 2) for _ in range(11)]
    check_case("vecjoin", "vec k=11 (surplus factors folded) block=8",
               lambda: mr.prod_reduce(fs, block=8),
               lambda: mr.prod_reduce_plain(fs, block=8), cases)

    emit("kernel_cases", build_s=round(build_s, 3),
         nvcc_s=round(kbuild.build_seconds.get("cutjoin", 0.0), 3),
         n_cases=len(cases), max_abs_err=max(c["max_abs_err"] for c in cases),
         cases=cases)
    torch.cuda.empty_cache()


# -- phase 3 ------------------------------------------------------------------------

def closed_form_cycle4(A: torch.Tensor) -> float:
    """# 4-cycles = (tr(A^4) - 2 Σd² + Σd) / 8, in f64."""
    A2 = A @ A
    tr4 = torch.sum(A2 * A2)                 # tr(A^4) = ||A²||_F², A symmetric
    d = A.sum(1)
    return ((tr4 - 2.0 * torch.sum(d * d) + torch.sum(d)) / 8.0).item()


def time_nodes(cp) -> dict:
    """Attribute the first ``counts()`` to node kinds: wraps the plan's node
    evaluation, synchronises after each node and adds its own time (without
    its children's) to its kind.  Clique enumeration, the one host-only
    node, is named as such."""
    seconds: dict = {}
    children = []
    evaluate = cp._eval

    def timed(node):
        kind = type(node).__name__
        if kind == "Intersect":
            kind += " (host clique enumeration)"
        elif kind == "CutJoin":
            kind += f" cut={node.cut_size}"
        elif kind == "Contract":
            kind += " free" if node.free else " closed"
        t0 = time.perf_counter()
        children.append(0.0)
        try:
            return evaluate(node)
        finally:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            seconds[kind] = seconds.get(kind, 0.0) + dt - children.pop()
            if children:
                children[-1] += dt

    cp._eval = timed
    return seconds


def drive(label: str, make_graph, patterns) -> dict:
    """The main path on one graph: compile, ``counts()`` twice (the second
    from the memo), and a second compile that hits the plan cache."""
    t0 = time.perf_counter()
    g = make_graph()
    graph_s = time.perf_counter() - t0
    cache = compiler.PlanCache()
    before = dict(mr.launches)
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    apct = APCT(g)                           # what compile() builds unasked
    apct_s = time.perf_counter() - t0
    cp = compiler.compile(patterns, g, cache=cache, apct=apct)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    node_s = time_nodes(cp)
    t0 = time.perf_counter()
    counts = cp.counts()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: mr.launches[k] - before[k] for k in mr.launches}
    evals = cp.stats["node_evals"]
    t0 = time.perf_counter()
    again = cp.counts()
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    assert again == counts, "second counts() differs from the first"
    assert cp.stats["node_evals"] == evals, \
        "second counts() re-evaluated nodes instead of reading the memo"
    assert {k: mr.launches[k] - before[k] for k in mr.launches} == launches, \
        "second counts() launched kernels"
    snapshot = obs.snapshot()
    peak_bytes = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    cp_hit = compiler.compile(patterns, g, cache=cache)
    cached_compile_s = time.perf_counter() - t0
    assert cp_hit.from_cache and (cache.hits, cache.misses) == (1, 1), \
        "second compile did not hit the plan cache"
    return {"label": label, "g": g, "cp": cp, "counts": counts,
            "launches": launches, "obs": snapshot,
            "peak_device_bytes": peak_bytes,
            "seconds": {"make_graph": round(graph_s, 3),
                        "compile": round(compile_s, 3),
                        "compile_apct_sampling": round(apct_s, 3),
                        "first_counts": round(first_s, 3),
                        "first_counts_by_node": {
                            k: round(v, 4) for k, v in node_s.items()},
                        "repeat_counts": round(repeat_s, 6),
                        "cached_compile": round(cached_compile_s, 4)}}


def verify_run(run: dict, patterns) -> dict:
    """Hold one main-path run against routes that launch no kernel."""
    g, cp, counts = run["g"], run["cp"], run["counts"]
    for v in counts.values():
        assert np.isfinite(v) and v >= 0 and v == round(v), counts
    # the f64 dense route, on an engine of its own (fresh memo, so the
    # cost model selects the same plan)
    engine = CountingEngine(g)
    cp_dense = compiler.compile(patterns, g, cache=False, counter=engine,
                                cutjoin_kernel=False)
    assert cp_dense.plan.meta["cuts"] == cp.plan.meta["cuts"]
    checks = {}
    for p in patterns:
        key = compiler.pattern_key(p)
        try:
            want, against = cp_dense.count(p), "dense-f64 route"
        except PlanTooWide:
            # the dense route refuses to materialise n^3 cells; the direct
            # Möbius count over f64 einsums is independent of the kernels
            want, against = engine.edge_induced(p), \
                "CountingEngine.edge_induced (dense route: PlanTooWide)"
        checks[key] = {"count": counts[key], "reference": want,
                       "against": against}
        if counts[key] != want:
            raise AssertionError(f"{run['label']} {key}: kernel route "
                                 f"{counts[key]!r} != {against} {want!r}")
    c4 = closed_form_cycle4(engine.A)
    if cp.count(cycle(4)) != c4:
        raise AssertionError(f"{run['label']} cycle(4): "
                             f"{cp.count(cycle(4))!r} != closed form {c4!r}")
    refused = [j["node"] for j in cp.join_log if j["route"] != "kernel"]
    return {"graph": {"generator": run["label"], "n": g.n, "edges": g.m,
                      "max_degree": int(np.max(g.degrees))},
            "counts": counts, "checks": checks, "cycle4_closed_form": c4,
            "styles": cp.plan.meta["styles"], "cuts": cp.plan.meta["cuts"],
            "joins": cp.join_log,
            "cut3_join_chosen": any(j["cut"] == 3 for j in cp.join_log),
            "joins_refused_by_guard": refused,
            "launches": run["launches"], "obs": run["obs"],
            "peak_device_bytes": run["peak_device_bytes"],
            "seconds": run["seconds"]}


MAIN_GRAPH = "rmat(13, 24.0, seed=0)"
COVERAGE_GRAPH = "erdos_renyi(8192, 24.0, seed=0)"


def phase_main_path() -> dict:
    """The user's graph is the skewed one (R-MAT, the scale of the paper's
    WikiVote input): what the cost model and the exactness guard choose
    there is reported as it falls, and it must launch a kernel at least
    once.  The uniform graph of the same size (Erdős–Rényi) is a coverage
    graph, chosen because the same entry points reach all three kernels on
    it; it is not claimed to be user traffic, and its launches are kept
    apart from the R-MAT graph's."""
    patterns = [tailed_triangle(), cycle(4), chain(5)] + \
        list(motif_patterns(4))
    graphs = [(MAIN_GRAPH, "main", lambda: rmat(13, 24.0, seed=0)),
              (COVERAGE_GRAPH, "coverage",
               lambda: erdos_renyi(8192, 24.0, seed=0))]
    mr.reset_launches()                      # counts start at 0 here ...
    runs = [dict(drive(label, make, patterns), role=role)
            for label, role, make in graphs]
    launches = dict(mr.launches)             # ... and are read here
    by_role = {run["role"]: run["launches"] for run in runs}
    assert sum(by_role["main"].values()) >= 1, \
        f"{MAIN_GRAPH} launched no kernel"
    for kernel, count in launches.items():
        assert count >= 1, f"neither graph launched {kernel}"
    reports = [dict(verify_run(run, patterns), role=run["role"])
               for run in runs]
    emit("main_path", patterns=len(patterns), launches=launches,
         launches_main_graph=by_role["main"],
         launches_coverage_graph=by_role["coverage"],
         kernels_not_reached_on_main_graph=[
             k for k, c in by_role["main"].items() if c == 0],
         graphs=reports)
    joins = [j for run in runs for j in run["cp"].join_log]
    del runs
    torch.cuda.empty_cache()
    return {"launches": launches, "by_role": by_role, "joins": joins}


# -- phase 4 ------------------------------------------------------------------------

def phase_kernels(main: dict):
    """The three kernels at the shapes phase 3 gave them (two factors
    each, as its joins carry; chunk = what the guard granted there, 128
    where neither graph reached the tier).  ``bound_ms`` is for the
    function that is timed, computed the cheapest way known, not for the
    way the kernel computes it."""
    rng = np.random.default_rng(1)
    granted = {j["cut"]: j["block"] for j in main["joins"]
               if j["route"] == "kernel"}
    out = []

    def entry(name, kernel, replaces, block, run, plain, library, reps,
              nbytes, nops, **more):
        got = run()
        want = plain()
        err = abs(got - want)
        if err != 0:
            raise AssertionError(f"{name}: kernel {got!r} != plain {want!r}")
        ms = timed_ms(run, reps)
        plain_ms = timed_ms(plain, 1)
        library_ms = None
        if library is not None:
            lib_val = library().item()
            assert lib_val == got, (name, lib_val, got)
            library_ms = timed_ms(library, reps)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
        out.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": replaces,
                    "launches": main["launches"][kernel],
                    "launches_main_graph": main["by_role"]["main"][kernel],
                    "launches_coverage_graph":
                        main["by_role"]["coverage"][kernel],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms, "block": block,
                    "bytes": nbytes, "operations": nops, **more})

    # K1: Σ_x F1[x] F2[x]
    b = granted.get(1, 128)
    fs = [int_factor(rng, (N,), max_value(2, b)) for _ in range(2)]
    blocks1 = -(-N // 256)
    entry("cutjoin_vec", "vecjoin", "src/repro/kernels/matreduce.py:195", b,
          lambda: mr.prod_reduce(fs, block=b),
          lambda: mr.prod_reduce_plain(fs, block=b),
          lambda: torch.dot(fs[0], fs[1]), 200,
          2 * N * 8 + blocks1 * 8, 2 * N)
    # K2: Σ_{x≠y} F1[x,y] F2[x,y]
    b = granted.get(2, 128)
    fs2 = [int_factor(rng, (N, N), max_value(2, b)) for _ in range(2)]
    eye = torch.eye(N, dtype=torch.bool, device=DEV)
    entry("cutjoin_pair", "pairjoin", "src/repro/kernels/matreduce.py:180",
          b, lambda: mr.prod_reduce(fs2, block=b),
          lambda: mr.prod_reduce_plain(fs2, block=b),
          lambda: (fs2[0] * fs2[1]).masked_fill(eye, 0).sum(), 20,
          2 * N * N * 8, 2 * N * N)
    del fs2
    # K4 as chain(5)'s join calls it: Σ_{x,y,z distinct} F1[x,y] F2[y,z].
    # With pair factors on (0,1) and (1,2) only, this function needs no
    # n^3 loop: it is Σ_y a[y] b[y] - Σ_{x≠y} F1[x,y] F2[y,x], where
    # a[y] = Σ_{x≠y} F1[x,y] and b[y] = Σ_{z≠y} F2[y,z].  That is one read
    # of both factors and about 4 n^2 operations, which is what the bound
    # counts, and the yardstick computes it so in f64 torch.
    b = granted.get(3, 128)
    hi = max_value(2, b, N ** 3)
    fs3 = [int_factor(rng, (N, N), hi) for _ in range(2)]
    axes = [(0, 1), (1, 2)]

    def chain_closed_form():
        F1, F2 = fs3
        a = F1.sum(0) - F1.diagonal()
        bb = F2.sum(1) - F2.diagonal()
        back = (F1 * F2.T).sum() - torch.dot(F1.diagonal(), F2.diagonal())
        return torch.dot(a, bb) - back

    entry("cutjoin_tri", "trijoin", "src/repro/kernels/matreduce.py:346", b,
          lambda: mr.tri_reduce(fs3, axes, n=N, block=b),
          lambda: mr.tri_reduce_plain(fs3, axes, n=N, block=b),
          chain_closed_form, 3, 2 * N * N * 8, 4 * N * N,
          factors="(0,1)+(1,2)",
          yardstick="a.b - sum_{x!=y} F1[x,y] F2[y,x], f64 torch calls")
    # K4 on a mix whose function does need n^3 work: with a third pair
    # factor on (0,2) it is Σ_{x≠z} F3[x,z] (F1' F2')[x,z], F1' and F2'
    # being F1 and F2 without their diagonals: a matrix product, 2 n^3
    # operations.  No join of phase 3 has this mix; it is kept inside K4's
    # entry so that the kernel's loop is also read against a bound it
    # cannot sidestep.
    axes3 = [(0, 1), (1, 2), (0, 2)]
    hi = max_value(3, b, N ** 3)
    fs4 = [int_factor(rng, (N, N), hi) for _ in range(3)]

    def triangle_matmul():
        F1, F2, F3 = fs4
        P = F1.masked_fill(eye, 0) @ F2.masked_fill(eye, 0)
        return (P * F3).masked_fill(eye, 0).sum()

    got3 = mr.tri_reduce(fs4, axes3, n=N, block=b)
    want3 = mr.tri_reduce_plain(fs4, axes3, n=N, block=b)
    lib3 = triangle_matmul().item()
    if not got3 == want3 == lib3:
        raise AssertionError(f"tri (0,1)+(1,2)+(0,2): kernel {got3!r}, "
                             f"plain {want3!r}, matmul form {lib3!r}")
    nbytes3, nops3 = 3 * N * N * 8, 2 * N ** 3
    out[-1]["mix_with_n3_work"] = {
        "factors": "(0,1)+(1,2)+(0,2)", "block": b, "max_abs_err": 0.0,
        "ms": timed_ms(lambda: mr.tri_reduce(fs4, axes3, n=N, block=b), 3),
        "bound_ms": max(nbytes3 / PEAK_BYTES_PER_S,
                        nops3 / PEAK_F32_OPS_PER_S) * 1e3,
        "bound_by": "operations", "library_ms": timed_ms(triangle_matmul, 3),
        "yardstick": "((F1' @ F2') * F3).masked_fill(eye, 0).sum() in f64",
        "bytes": nbytes3, "operations": nops3}
    print(json.dumps({"kernels": out}), flush=True)


def main():
    smi = phase_device()
    phase_kernel_cases()
    main_path = phase_main_path()
    phase_kernels(main_path)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)          # the one device this drives


if __name__ == "__main__":
    main()
