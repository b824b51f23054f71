"""Batched serving with continuous batching (slot reuse, per-request
prefill + shared decode steps), on the PyTorch/CUDA port: reduced
qwen3-4b with random weights.

    PYTHONPATH=src python examples_torch/serve_batched.py
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device; 'cpu' asks "
                "for the CPU)")
args = ap.parse_args()

serve_main(["--arch", "qwen3-4b", "--requests", "10", "--slots", "4",
            "--max-new", "8"]
           + (["--device", args.device] if args.device else []))
