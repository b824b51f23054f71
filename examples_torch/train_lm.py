"""End-to-end training on the PyTorch/CUDA port: the ~130M-parameter
repro-100m decoder on the synthetic pipeline with checkpoint/resume.
(Use --steps 200+ for a real run; the default is sized for a quick
demonstration: 30 steps of 8 x 128 tokens.)

    PYTHONPATH=src python examples_torch/train_lm.py [--steps N]
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu [--full]

On the card (the default device) it trains the full-width config; on the
CPU the reduced width, unless ``--full`` is given.  The reduced config's
head dim, 16, is not one the attention kernel K9 takes (64 and 128), and
its 128-token sequences are longer than its flash block (32), so on the
card the reduced width would raise in K9.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=30)
ap.add_argument("--full", action="store_true",
                help="full repro-100m config (the default on the card; on "
                "the CPU the default is the reduced width)")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

ckpt = tempfile.mkdtemp(prefix="repro100m_")
argv = ["--arch", "repro-100m", "--steps", str(args.steps),
        "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt,
        "--ckpt-every", "10", "--log-every", "5"]
if not args.full and (args.device or "").startswith("cpu"):
    argv.append("--reduced")
if args.device:
    argv += ["--device", args.device]

losses = train_main(argv)
print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
print(f"checkpoints in {ckpt} — rerun with the same dir to resume")
