"""End-to-end training driver.

Runs any ported registry config (full or reduced) with the training
substrate: deterministic data pipeline, microbatched AdamW, async
checkpointing, preemption handling, restart-from-latest, straggler
watchdog.  Flags and printed lines are the reference package's
(``python -m repro.launch.train``), plus ``--device``: it runs on the
CUDA device, raising without one; ``--device cpu`` asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
      --steps 200 --batch 8 --seq 1024 --ckpt-dir /tmp/ck100m
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20 \\
      --device cpu

Weights are drawn from ``--seed`` with a ``torch.Generator``, so they (and
the losses) differ from the reference's for the same seed; the data
batches are the same arrays.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as _device
from repro_torch.configs.base import reduced_config
from repro_torch.configs.registry import get_config
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import tree
from repro_torch.train.data import TokenPipeline
from repro_torch.train.fault_tolerance import PreemptionGuard, StepWatchdog
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for smoke runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                    "device, raising without one; 'cpu' asks for the CPU)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt_cfg = opt_mod.OptConfig(lr=args.lr, warmup_steps=20,
                                total_steps=max(args.steps, 100))
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)

    state = init_state(cfg, opt_cfg, args.seed, device=device)
    start = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        restored, s = ckpt.restore_latest(args.ckpt_dir, state)
        if restored is not None:
            state, start = restored, s
            print(f"resumed from step {start}")

    n_params = sum(x.numel() for x in tree.leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")

    guard = PreemptionGuard()
    watchdog = StepWatchdog()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipe.batch_at(step).items()}
        watchdog.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = watchdog.stop(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  {dt:.2f}s",
                  flush=True)
        if writer and ((step + 1) % args.ckpt_every == 0
                       or guard.requested):
            writer.save(step + 1, state)
            if guard.requested:
                print(f"preempted: saved step {step + 1}, exiting")
                writer.wait()
                return losses
    if writer:
        writer.save(args.steps, state)
        writer.wait()
    if watchdog.straggler_events:
        print(f"straggler steps: {watchdog.straggler_events}")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
