#!/usr/bin/env python3
"""K9-bwd bf16 of several checkouts on one CUDA card, one process each.

    python3 tools/bwd_variants.py [--cases] [--time] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository: this one (``.``),
another commit unpacked by ``git archive <commit> | tar -x -C DIR``, or a
copy of ``src/`` and ``chip_smoke.py`` whose ``csrc/flashattn_bwd.cu`` was
edited to try a design, each in a git-ignored directory.  Every
checkout's attention libraries are built first, all at once, into its own
``build/``; for each, the bf16 kernels' ptxas lines (registers, spills)
and any warning or serialisation note are printed, and the whole ``nvcc``
log is written to ``build/bwd_variants/ptxas_<dir name>.txt`` of this
checkout.  Then, for each argument in the order given (give a label more
than once to alternate turns), in a process that imports only that
checkout's ``repro_torch`` and ``chip_smoke``:

- ``--cases``: ``chip_smoke.flash_bwd_cases`` (every K9-bwd check of the
  smoke), each bf16 case's worst error over its bound and whether two
  launches gave the same bits;
- ``--time``: K9-bwd bf16 causal at (B, S, H, Dq, Dv) = (1, 4096, 128,
  192, 128), (1, 4096, 32, 128, 128) and (1, 4096, 32, 64, 64) on seeded
  random inputs and K9's output and lse for them: the call's mean ms over
  5 calls by CUDA events after a warm-up, and each kernel's device ms a
  call over 3 calls (CUDA activity of ``torch.profiler``).

Exits non-zero when a build or a turn fails.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time

SHAPES = ((1, 4096, 128, 192, 128), (1, 4096, 32, 128, 128),
          (1, 4096, 32, 64, 64))
LOGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "bwd_variants")


def _worker(root: str, flags: list) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flashattn as kfa
    assert kfa.__file__.startswith(root), kfa.__file__
    if "--build" in flags:
        kbuild.load_all({k: v for k, v in kbuild.SOURCES.items()
                         if k.startswith("flashattn")})
        log = kbuild.build_logs.get("flashattn_bwd", "")
        os.makedirs(LOGS, exist_ok=True)
        with open(os.path.join(LOGS, f"ptxas_{os.path.basename(root)}.txt"),
                  "w") as f:
            f.write(log)
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m[1] if "bf16k" in m[1] else None
                if entry:
                    print("entry", entry[:90])
            elif entry and ("spill" in line or "Used" in line):
                print("   ", line.strip()[:160])
            if "arning" in line or "serializ" in line:
                print("warning", line.strip()[:300])
        return 0
    dev = torch.device("cuda")
    if "--cases" in flags:
        import chip_smoke as cs
        t = time.time()
        cases = cs.flash_bwd_cases(torch.Generator(device=dev).manual_seed(3))
        print("cases", len(cases), "worst", max(
            c.get("worst_err_over_tolerance", 0) for c in cases),
            "seconds", round(time.time() - t, 1), flush=True)
        for c in cases:
            if "bf16" in c.get("dtype", "") + c.get("case", ""):
                print("  ", c["case"][:60],
                      round(c.get("worst_err_over_tolerance", 0), 4),
                      c.get("two_launches_same_bits"))
    if "--time" in flags:
        def timed_ms(fn, reps):
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

        for B, S, H, Dq, Dv in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(12)
            q, k, v, do = [torch.randn((B, S, H, d), generator=gen,
                                       device=dev, dtype=torch.bfloat16)
                           for d in (Dq, Dq, Dv, Dv)]
            o, lse, _ = kfa._forward(q, k, v, True, Dq ** -0.5,
                                     with_lse=True)

            def call():
                return kfa.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=True)
            ms = timed_ms(call, 5)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            by: dict = {}
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    m = re.search(r"::(\w+)<", evt.name)
                    name = m[1] if m else evt.name[:40]
                    by[name] = by.get(name, 0.0) + evt.device_time_total / 3e3
            print("time", [B, S, H, Dq, Dv], round(ms, 4),
                  {n: round(x, 4) for n, x in by.items()}, flush=True)
            del q, k, v, do, o, lse
    return 0


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], argv[2:])
    flags = [a for a in argv if a.startswith("--")]
    turns = [a.split("=", 1) for a in argv if not a.startswith("--")]
    if not turns or any(len(t) != 2 for t in turns):
        print(__doc__, file=sys.stderr)
        return 2
    me = os.path.abspath(__file__)
    builds = {d: subprocess.Popen([sys.executable, me, "--worker", d,
                                   "--build"], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dict.fromkeys(d for _, d in turns)}
    rc = 0
    for d, proc in builds.items():
        out = proc.communicate()[0]
        print("===== build", d, "rc", proc.returncode, flush=True)
        print(out[-6000:], flush=True)
        rc |= proc.returncode
    if rc:
        return 1
    for label, d in turns:
        print("=====", label, d, flush=True)
        rc |= subprocess.run([sys.executable, me, "--worker", d,
                              *flags]).returncode
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
