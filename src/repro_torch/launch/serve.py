"""Batched serving driver: continuous batching over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --reduced --requests 12 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Runs on the CUDA device; ``--device cpu`` asks for the CPU (without it, a
machine with no card raises).  Flags and printed lines are the reference
package's (``python -m repro.launch.serve``), ``--reduced`` included: it
is a ``store_true`` flag whose default is True, so this command line
always serves the reduced config (as the reference's does).  The full
width is reached through the library:
``ContinuousBatcher(get_config("qwen3-4b"), params, ...)``.  Weights are
random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import device as _device
from repro_torch.configs.base import reduced_config
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import Model
from repro_torch.serve.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                    "device, raising without one; 'cpu' asks for the CPU)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg)
    params = model.init(args.seed, device=device)
    rng = np.random.default_rng(args.seed)

    b = ContinuousBatcher(cfg, params, slots=args.slots,
                          capacity=args.capacity, device=device)
    for i in range(args.requests):
        T = int(rng.integers(4, 17))
        prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
        b.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    steps = b.run_to_completion()      # every step reads its tokens back
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in b.finished)
    print(f"served {len(b.finished)}/{args.requests} requests, "
          f"{tokens} tokens in {steps} engine steps, {dt:.2f}s "
          f"({tokens / max(dt, 1e-9):.1f} tok/s)")
    for r in b.finished[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")
    return b


if __name__ == "__main__":
    main()
