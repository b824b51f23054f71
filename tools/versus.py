#!/usr/bin/env python3
"""K9's and K9-bwd's bf16 kernels, K4's triangle route and optionally the
train step, of several checkouts side by side on one CUDA card.

    python3 tools/versus.py [--train] [--only attn|tri] LABEL=DIR [...]

Each DIR is the root of a checkout of this repository (this one, ``.``,
or another commit unpacked by ``git archive <commit> | tar -x -C DIR``
into a git-ignored directory).  The arguments run in the order given,
each in a process of its own that imports only that checkout's
``repro_torch`` (and, with ``--train``, its ``chip_smoke``); give a
label more than once to alternate turns, e.g. ``parent=build/parent
this=. this=. parent=build/parent``.  Every checkout's kernels are built
first, into its own ``build/``, all at once.

A turn prints one JSON line ``{"turn": ...}``, measured in that process:

- ``fwd``: K9 bf16 causal at each of ``FWD_SHAPES`` on seeded random
  inputs, mean ms of 10 calls by CUDA events after a warm-up (``ms``), and
  the same work as 4 calls on a quarter of the heads (``same_work_ms``);
- ``bwd``: K9-bwd bf16 causal at ``BWD_SHAPES`` on K9's output and lse
  for the same inputs, ms by events, and device ms and launches a call by
  kernel, for whatever kernels the checkout's backward launches (CUDA
  activity of ``torch.profiler`` over 3 calls, kernels by their
  unqualified names);
- ``digests``: SHA-256 of the bits of O, lse, dQ, dK and dV at each of
  ``BITS_SHAPES``, and ``same_bits_twice``: whether a second backward at
  each gave the same dQ, dK and dV;
- ``tri``: K4's triangle route (``tri_reduce`` on the cycles' mix of
  three pair factors, seeded integers in [0, 25], so that every sum is an
  exact f64 integer) at each of ``TRI_TIMED``: the join, the call's mean
  ms by CUDA events over 5 calls after a warm-up, and device ms and
  launches a call by kernel (CUDA activity of ``torch.profiler`` over 3
  calls); beside the first, the yardstick ``((F1' @ F2') * F3').sum()``
  (cuBLAS's f64 product, ' = the diagonal zeroed) the same way, its
  kernels by their full names; then ``_tri_checks``: the route at its
  edges (operands read row-inner or k-inner, in place or copied by the
  wrapper where TMA cannot read them, other factors on A′ and B′, offsets
  on every axis, ragged and tiny sizes, unmasked), each join against
  ``_tri_triangle_plain`` on the card;
- with ``--train``: qwen3-4b and deepseek-v3 (3 dense layers) at full
  width, batch 1 x 4096, 7 steps each by the checkout's own
  ``chip_smoke.big_model_steps`` (host-clock seconds; one more qwen3-4b
  step traced for device time); the median of steps 2-7.

``--only attn`` runs K9 and K9-bwd alone, ``--only tri`` the triangle
route alone (and builds only the join libraries).

Then one line ``{"versus": ...}``: each label's median of every time over
its turns; ``same_bits``, whether within each label every turn gave the
same digests and every backward the same bits twice, and every turn the
same triangle joins (exact integers: equal across labels too); and
``same_bits_across_labels``, reported only: two checkouts whose attention
kernels sum in another order may differ.  Exits non-zero where a turn
failed (a triangle join off its plain version fails it) or ``same_bits``
is false.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

# (B, S, H, Dq, Dv): deepseek-v3's prefill, qwen3-4b's serving, dbrx-132b's
# 48 heads, musicgen-large's (64, 64)
FWD_SHAPES = ((1, 4096, 128, 192, 128), (1, 4096, 32, 128, 128),
              (1, 4096, 48, 128, 128), (1, 4096, 32, 64, 64))
# deepseek-v3's and qwen3-4b's training shapes
BWD_SHAPES = ((1, 4096, 128, 192, 128), (1, 4096, 32, 128, 128))
# (B, S, H, Dq, Dv, causal): the training and serving shapes, Sq = 1000 at
# each pair, full attention, and B·H = 65600 at two tiles a pair
BITS_SHAPES = ((1, 4096, 128, 192, 128, True), (1, 4096, 32, 128, 128, True),
               (2, 1000, 3, 192, 128, True), (2, 1000, 3, 128, 128, True),
               (2, 1000, 3, 64, 64, True), (2, 1000, 3, 192, 128, False),
               (2050, 129, 32, 64, 64, True))
KERNEL_NAME = re.compile(r"::(\w+)<")     # a templated kernel's own name
# K4's triangle route: the cycles' mix, timed at (sizes, offsets) = the
# main path's n = 8192 and the smoke's axis-0 slice of 1000 rows
TRI_AXES = [(0, 1), (1, 2), (0, 2)]
TRI_TIMED = (((8192, 8192, 8192), (0, 0, 0)),
             ((1000, 8192, 8192), (3001, 0, 0)))
TRI_HI = 25               # 25^3 · 8192^3 < 2^53
TURN_SECONDS = 900        # a turn that runs longer is killed (a hung kernel)


def _timed_ms(torch, fn, reps=10):
    """Mean ms of ``fn`` over ``reps`` calls by CUDA events, after one."""
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


def _device_ms(torch, fn, calls: int = 3, full_names: bool = False):
    """Device ms and launches a call of each kernel ``fn`` launches, by its
    unqualified name (or its full name): CUDA activity of
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = None if full_names else KERNEL_NAME.search(evt.name)
        name = m[1] if m else evt.name
        ms, n = by.get(name, (0.0, 0))
        by[name] = (ms + evt.device_time_total / (1e3 * calls), n + 1)
    assert sum(ms for ms, _ in by.values()) > 0, "no device time traced"
    return ({k: ms for k, (ms, _) in by.items()},
            {k: n / calls for k, (_, n) in by.items()})


def _worker(root: str, train: bool, build_only: bool, only: str) -> dict:
    """One turn in this process, on the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flashattn as kfa
    assert kfa.__file__.startswith(root), kfa.__file__
    attn, tri = only in ("", "attn"), only in ("", "tri")
    if not train:                 # only the libraries of the kernels run
        kbuild.SOURCES = {
            k: v for k, v in kbuild.SOURCES.items()
            if (attn and k.startswith("flashattn"))
            or (tri and k in ("cutjoin", "trijoin", "matreduce"))}
    kbuild.load_all(kbuild.SOURCES)
    if build_only:
        out = {"root": root, "built": sorted(kbuild.SOURCES)}
        if tri:
            out["tri_build"] = _tri_build(kbuild)
        return out
    dev = torch.device("cuda")
    out: dict = {"root": root}
    if tri:
        out["tri"] = _tri_turn(torch)
    if not attn:
        return out

    def timed_ms(fn, reps=10):
        return _timed_ms(torch, fn, reps)

    def inputs(seed, B, S, H, Dq, Dv):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((B, S, H, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for d in (Dq, Dq, Dv, Dv)]

    def digest(x):
        return hashlib.sha256(x.contiguous().view(-1).view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()[:16]

    out.update(fwd=[], bwd=[], digests=[])
    for B, S, H, Dq, Dv in FWD_SHAPES:
        q, k, v, _ = inputs(11, B, S, H, Dq, Dv)
        part = H // 4
        out["fwd"].append({
            "shape": [B, S, H, Dq, Dv],
            "ms": timed_ms(lambda: kfa.flash_attention(q, k, v, causal=True)),
            "same_work_ms": timed_ms(lambda: [kfa.flash_attention(
                q[:, :, i:i + part], k[:, :, i:i + part],
                v[:, :, i:i + part], causal=True)
                for i in range(0, H, part)])})
    for B, S, H, Dq, Dv in BWD_SHAPES:
        q, k, v, do = inputs(12, B, S, H, Dq, Dv)
        o, lse, _ = kfa._forward(q, k, v, True, Dq ** -0.5, with_lse=True)
        call = lambda: kfa.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=True)
        row = {"shape": [B, S, H, Dq, Dv], "ms": timed_ms(call, 5)}
        row["device_ms"], row["launches_per_call"] = _device_ms(torch, call)
        out["bwd"].append(row)
        del q, k, v, do, o, lse
    for B, S, H, Dq, Dv, causal in BITS_SHAPES:
        q, k, v, do = inputs(7, B, S, H, Dq, Dv)
        o, lse, _ = kfa._forward(q, k, v, causal, Dq ** -0.5, with_lse=True)
        grads = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        again = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        out["digests"].append([digest(x) for x in (o, lse, *grads)])
        out.setdefault("same_bits_twice", []).append(
            all(torch.equal(a, b) for a, b in zip(grads, again)))
        del q, k, v, do, o, lse, grads, again
    if train:
        torch.cuda.empty_cache()
        out["train"] = _train_steps(root)
    return out


def _tri_build(kbuild) -> dict:
    """The triangle kernels' ptxas lines (registers, spills) from this
    build, and their f64 mma instructions in the SASS by opcode."""
    lines, entry = [], None
    for line in kbuild.build_logs.get("trijoin", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m[1] if "tri_mma" in m[1] else None
        elif entry and ("spill" in line or "Used" in line):
            lines.append(f"{entry}: {line.strip()}")
    count = getattr(kbuild, "sass_opcodes", None)   # not in older checkouts
    sass = count and count("trijoin", r"DMMA(?:\.\w+)*")
    return {"ptxas": lines, "dmma": None if sass is None else {
        k: v for k, v in sass.items() if "tri_mma" in k}}


def _tri_turn(torch) -> dict:
    """K4's triangle route: the timed joins, the yardstick and the checks
    (see the module docstring)."""
    from repro_torch.kernels import matreduce as mr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)

    def factor(shape, hi=TRI_HI):
        return torch.randint(0, hi + 1, shape, generator=gen, device=dev,
                             dtype=torch.float64)

    n = TRI_TIMED[0][0][0]
    fs = [factor((n, n)) for _ in TRI_AXES]
    rows = []
    for sizes, off in TRI_TIMED:
        sl = [F[off[0]:off[0] + sizes[0]] if 0 in ax else F
              for F, ax in zip(fs, TRI_AXES)]
        call = lambda: mr.tri_reduce(sl, TRI_AXES, n=sizes,  # noqa: E731
                                     offsets=off)
        row = {"sizes": list(sizes), "offsets": list(off), "join": call(),
               "ms": _timed_ms(torch, call, 5)}
        row["device_ms"], row["launches_per_call"] = _device_ms(torch, call)
        rows.append(row)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    P1, P2, P3 = (F.masked_fill(eye, 0) for F in fs)
    library = lambda: ((P1 @ P2) * P3).sum()  # noqa: E731
    assert library().item() == rows[0]["join"], "yardstick differs"
    lib = {"ms": _timed_ms(torch, lambda: library().item(), 5)}
    lib["device_ms"], lib["launches_per_call"] = _device_ms(
        torch, library, full_names=True)
    del P1, P2, P3, eye, fs
    return {"timed": rows, "library": lib, "checks": _tri_checks(torch, mr,
                                                                factor)}


def _tri_checks(torch, mr, factor) -> list:
    """The triangle route at its edges, each join against the route's plain
    version on the card; fails on a difference.  Returns (case, join)."""
    out = []
    cycle = TRI_AXES
    mix = [(0, 1), (0, 1), (1, 2), (0, 2), (1,)]

    def check(label, fs, axes, sizes, offsets=None, distinct=True):
        got = mr.tri_reduce(fs, axes, n=sizes, offsets=offsets,
                            distinct=distinct)
        want = mr._tri_triangle_plain(fs, axes, sizes, distinct,
                                      offsets).sum().item()
        assert got == want, f"{label}: kernel {got!r}, plain {want!r}"
        out.append([label, got])

    def shaped(axes, sizes, hi=TRI_HI):
        return [factor(tuple(sizes[a] for a in ax), hi) for ax in axes]

    # a vector on y and a second factor on (0, 1): extra factors on A′;
    # a second factor on (1, 2): on B′, vectors on x and z on C′
    sizes = (1000, 777, 333)
    for axes in (mix, [(0, 1), (1, 2), (1, 2), (0, 2), (0,), (2,)]):
        fs = shaped(axes, sizes, 3)
        for distinct in (True, False):
            check(f"{axes} {sizes} offsets (5,130,7) distinct={distinct}",
                  fs, axes, sizes, (5, 130, 7), distinct)
    # A′ row-inner and B′ k-inner (transposed views), read in place
    nx, ny, nz = 700, 600, 500
    fs = [factor((ny, nx)).T, factor((nz, ny)).T, factor((nx, nz))]
    check("A row-inner, B k-inner, TMA", fs, cycle, (nx, ny, nz))
    check("A row-inner, B k-inner, offsets (3,0,650)", fs, cycle,
          (nx, ny, nz), (3, 0, 650))
    # no unit stride (copied by the wrapper) beside an operand read in place
    big = factor((2 * 300, 3 * 257))
    fs = [big[::2, ::3], factor((257, 130)), factor((300, 130))]
    check("A strided, B TMA", fs, cycle, (300, 257, 130), (0, 2, 1))
    # bases off a 16-byte boundary and odd strides: both copied
    flat = factor((1 + 129 * 127 + 127 * 255 + 1,))
    fa = flat[1:1 + 129 * 127].view(129, 127)
    fb = flat[1 + 129 * 127:1 + 129 * 127 + 127 * 255].view(127, 255)
    check("unaligned, odd strides", [fa, fb, factor((129, 255))], cycle,
          (129, 127, 255), (1, 0, 2))
    # an odd k extent under an even stride (read in place) beside an
    # odd-strided B
    wide = factor((301, 258))
    check("odd k extent", [wide[:, :257], factor((257, 131)),
                           factor((301, 131))], cycle, (301, 257, 131))
    # diagonal tiles under offsets, tiles past the edges, tiny joins
    for sizes, offsets, m in (((50, 256, 256), (100, 0, 0), 256),
                              ((400, 1024, 1024), (301, 0, 0), 1024),
                              ((2730, 8192, 8192), (5462, 0, 0), 8192),
                              ((37, 19, 11), (0, 3, 1), None),
                              ((1, 1, 1), (0, 0, 0), None),
                              ((129, 129, 129), (0, 0, 0), None)):
        if m is None:
            fs = shaped(cycle, sizes)
        else:
            whole = shaped(cycle, (m, m, m))
            fs = [F[offsets[0]:offsets[0] + sizes[0]] if 0 in ax else F
                  for F, ax in zip(whole, cycle)]
        check(f"{sizes} offsets {offsets}", fs, cycle, sizes, offsets)
    fs = shaped(cycle, (1024, 1024, 1024))
    check("n=1024 distinct=False", fs, cycle, (1024, 1024, 1024),
          distinct=False)
    return out


def _train_steps(root: str) -> dict:
    """Seconds a step of the checkout's own ``big_model_steps``."""
    import dataclasses
    sys.path.insert(0, root)
    import chip_smoke as cs
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    cs.TRAIN_BIG_STEPS = 7
    runs = {"qwen3-4b": cs.big_model_steps(
        {}, cs.get_config(cs.TRAIN_BIG), 4_022_468_096),
        "deepseek-v3-3-layers": cs.big_model_steps(
            {}, dataclasses.replace(cs.get_config(cs.MLA_ARCH),
                                    num_layers=cs.MLA_TRAIN_LAYERS),
            cs.MLA_TRAIN_PARAMS, profile=False)}
    out = {}
    for name, r in runs.items():
        seconds = [s["seconds"] for s in r["steps"]]
        out[name] = {"seconds": seconds,
                     "median_2_7": statistics.median(seconds[1:])}
        if "profile" in r:
            out[name]["device_ms"] = r["profile"]["device_ms"]
            out[name]["k9_bwd_ms"] = r["profile"]["k9_bwd_ms"]
    return out


def _times(turn: dict):
    """(name, ms) of every time in a turn."""
    if "tri" in turn:
        for row in turn["tri"]["timed"]:
            name = f"tri {row['sizes']} {row['offsets']}"
            yield name, row["ms"]
            for kernel, ms in row["device_ms"].items():
                yield f"{name} {kernel} device", ms
        for kernel, ms in turn["tri"]["library"]["device_ms"].items():
            yield f"tri library {kernel[:60]} device", ms
    for row in turn.get("fwd", []):
        yield f"fwd {row['shape']}", row["ms"]
        yield f"fwd {row['shape']} same work", row["same_work_ms"]
    for row in turn.get("bwd", []):
        yield f"bwd {row['shape']}", row["ms"]
        for kernel, ms in row["device_ms"].items():
            yield f"bwd {row['shape']} {kernel} device", ms
    for name, r in turn.get("train", {}).items():
        yield f"train {name} s", r["median_2_7"]


def main(argv) -> int:
    only = ""
    if "--only" in argv:
        at = argv.index("--only")
        only = argv[at + 1] if at + 1 < len(argv) else "?"
        argv = argv[:at] + argv[at + 2:]
    if only not in ("", "attn", "tri"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[:1] == ["--worker"]:
        root, flags = argv[1], argv[2:]
        out = _worker(root, "--train" in flags, "--build" in flags, only)
        print(json.dumps({"turn": out}), flush=True)
        return 0
    train = "--train" in argv
    turns = [a.split("=", 1) for a in argv if a != "--train"]
    if not turns or any(len(t) != 2 for t in turns):
        print(__doc__, file=sys.stderr)
        return 2
    me = os.path.abspath(__file__)
    flags = (["--train"] if train else []) + \
        (["--only", only] if only else [])
    builds = [subprocess.Popen([sys.executable, me, "--worker", d, "--build",
                                *flags], stdout=subprocess.PIPE, text=True)
              for d in sorted({d for _, d in turns})]
    for p in builds:
        built = p.communicate()[0]
        if p.returncode != 0:
            return 1
        print(built.strip().splitlines()[-1], flush=True)
    done = []
    for label, d in turns:
        proc = subprocess.run([sys.executable, me, "--worker", d, *flags],
                              stdout=subprocess.PIPE, text=True,
                              timeout=TURN_SECONDS)
        if proc.returncode != 0:
            return 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])["turn"]
        print(json.dumps({"turn": {"label": label, **turn}}), flush=True)
        done.append((label, turn))
    medians: dict = {}
    for label in dict.fromkeys(lb for lb, _ in done):
        per: dict = {}
        for lb, turn in done:
            if lb == label:
                for name, ms in _times(turn):
                    per.setdefault(name, []).append(ms)
        medians[label] = {n: statistics.median(x) for n, x in per.items()}
    same = all(
        len({json.dumps(t.get("digests")) for lb, t in done
             if lb == label}) == 1
        for label in medians) and all(all(t.get("same_bits_twice", [True]))
                                      for _, t in done)
    # the triangle route's joins are exact integers: one set for all turns
    same = same and len({json.dumps(
        [[r["join"] for r in t["tri"]["timed"]], t["tri"]["checks"]])
        for _, t in done if "tri" in t}) <= 1
    across = len({json.dumps(t.get("digests")) for _, t in done}) == 1
    print(json.dumps({"versus": {"medians": medians, "same_bits": same,
                                 "same_bits_across_labels": across}}),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
