#!/usr/bin/env python3
"""K9's and K9-bwd's bf16 kernels, and optionally the train step, of
several checkouts side by side on one CUDA card.

    python3 tools/versus.py [--train] LABEL=DIR [LABEL=DIR ...]

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
- with ``--train``: qwen3-4b and deepseek-v3 (3 dense layers) at full
  width, batch 1 x 4096, 7 steps each by the checkout's own
  ``chip_smoke.big_model_steps`` (host-clock seconds; one more qwen3-4b
  step traced for device time); the median of steps 2-7.

Then one line ``{"versus": ...}``: each label's median of every time over
its turns; ``same_bits``, whether within each label every turn gave the
same digests and every backward the same bits twice; and
``same_bits_across_labels``, reported only: two checkouts whose kernels
sum in another order may differ.  Exits non-zero where a turn failed or
``same_bits`` is false.
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


def _worker(root: str, train: bool, build_only: bool) -> dict:
    """One turn in this process, on the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flashattn as kfa
    assert kfa.__file__.startswith(root), kfa.__file__
    if not train:                 # only the attention libraries are needed
        kbuild.SOURCES = {k: v for k, v in kbuild.SOURCES.items()
                          if k.startswith("flashattn")}
    kbuild.load_all(kbuild.SOURCES)
    if build_only:
        return {"root": root, "built": sorted(kbuild.SOURCES)}
    dev = torch.device("cuda")

    def timed_ms(fn, reps=10):
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

    def inputs(seed, B, S, H, Dq, Dv):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((B, S, H, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for d in (Dq, Dq, Dv, Dv)]

    def digest(x):
        return hashlib.sha256(x.contiguous().view(-1).view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()[:16]

    out: dict = {"root": root, "fwd": [], "bwd": [], "digests": []}
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
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        by: dict = {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = KERNEL_NAME.search(evt.name)
            name = m[1] if m else evt.name
            ms, n = by.get(name, (0.0, 0))
            by[name] = (ms + evt.device_time_total / 3e3, n + 1)
        row["device_ms"] = {k: ms for k, (ms, _) in by.items()}
        row["launches_per_call"] = {k: n / 3 for k, (_, n) in by.items()}
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
    for row in turn["fwd"]:
        yield f"fwd {row['shape']}", row["ms"]
        yield f"fwd {row['shape']} same work", row["same_work_ms"]
    for row in turn["bwd"]:
        yield f"bwd {row['shape']}", row["ms"]
        for kernel, ms in row["device_ms"].items():
            yield f"bwd {row['shape']} {kernel} device", ms
    for name, r in turn.get("train", {}).items():
        yield f"train {name} s", r["median_2_7"]


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        root, flags = argv[1], argv[2:]
        out = _worker(root, "--train" in flags, "--build" in flags)
        print(json.dumps({"turn": out}), flush=True)
        return 0
    train = "--train" in argv
    turns = [a.split("=", 1) for a in argv if a != "--train"]
    if not turns or any(len(t) != 2 for t in turns):
        print(__doc__, file=sys.stderr)
        return 2
    me = os.path.abspath(__file__)
    flags = ["--train"] if train else []
    builds = [subprocess.Popen([sys.executable, me, "--worker", d, "--build",
                                *flags])
              for d in sorted({d for _, d in turns})]
    if any(p.wait() != 0 for p in builds):
        return 1
    done = []
    for label, d in turns:
        proc = subprocess.run([sys.executable, me, "--worker", d, *flags],
                              stdout=subprocess.PIPE, text=True)
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
        len({json.dumps(t["digests"]) for lb, t in done if lb == label}) == 1
        for label in medians) and all(all(t["same_bits_twice"])
                                      for _, t in done)
    across = len({json.dumps(t["digests"]) for _, t in done}) == 1
    print(json.dumps({"versus": {"medians": medians, "same_bits": same,
                                 "same_bits_across_labels": across}}),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
