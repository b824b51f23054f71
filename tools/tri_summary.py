#!/usr/bin/env python3
"""One line per build and per turn of a ``tools/versus.py`` log that ran
K4's triangle route: each checkout's triangle kernels' ptxas registers and
spills and their f64 mma opcodes; each turn's device ms of the kernel by
timed shape; then each label's medians.

    python3 tools/tri_summary.py VERSUS_LOG
"""
from __future__ import annotations

import json
import re
import sys


def main(path: str) -> int:
    for line in open(path):
        d = json.loads(line)
        turn = d.get("turn", {})
        if "tri_build" in turn:
            b = turn["tri_build"]
            regs = sorted({int(m) for x in b["ptxas"]
                           for m in re.findall(r"Used (\d+) registers", x)})
            spills = sorted({int(m) for x in b["ptxas"]
                             for m in re.findall(r"(\d+) bytes spill stores",
                                                 x)})
            ops = sorted({op for v in (b["dmma"] or {}).values() for op in v})
            print(f"build {turn['root'][-28:]:>28}: registers {regs}, "
                  f"spill stores {spills}, {ops}")
        elif "tri" in turn:
            rows = turn["tri"]["timed"]
            ms = [r["device_ms"].get("tri_mma") for r in rows]
            print(f"turn {turn['label']:>8}: tri_mma device ms {ms}, "
                  f"library "
                  f"{max(turn['tri']['library']['device_ms'].values()):.4f}, "
                  f"{len(turn['tri']['checks'])} checks")
        elif "versus" in d:
            v = d["versus"]
            for label, med in v["medians"].items():
                keys = [k for k in med if k.endswith("tri_mma device")]
                print(f"median {label:>8}: "
                      + ", ".join(f"{k.split(']')[0]}] {med[k]:.4f}"
                                  for k in keys))
            print("same_bits", v["same_bits"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
