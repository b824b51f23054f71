"""§Perf hillclimb: circulant-tuning layout search per cell, from the CLI.

The reference package's ``repro.launch.hillclimb``, on the port's dry run
(meta tensors on the CPU; no card, no forced host devices)::

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch qwen3-4b --shape train_4k --mesh single --budget 18

Every evaluation is a dry run of the cell with its per-device terms and
collectives (``distributed.autoshard.evaluate``); records land in
``build/repro_torch/autoshard/`` and the search log in
``build/repro_torch/hillclimb_<arch>__<shape>__<mesh>.json``.
"""
import argparse
import json
import pathlib

from repro_torch.distributed.autoshard import circulant_autoshard

OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--budget", type=int, default=18)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    assign, rec, history = circulant_autoshard(
        args.arch, args.shape, args.mesh, max_rounds=args.rounds,
        budget_evals=args.budget)
    log = {
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "best_assignment": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in assign.items()},
        "best": {k: rec[k] for k in
                 ("t_compute", "t_memory", "t_collective", "dominant",
                  "useful_flops_ratio")},
        "best_memory_gib": rec["memory"]["peak_est_bytes"] / 2**30,
        "history": [({k: list(v) if isinstance(v, tuple) else v
                      for k, v in a.items()}, c) for a, c in history],
    }
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"hillclimb_{args.arch}__{args.shape}__{args.mesh}.json"
    out.write_text(json.dumps(log, indent=1))
    print(f"wrote {out}")
    print(json.dumps(log["best"], indent=1))


if __name__ == "__main__":
    main()
