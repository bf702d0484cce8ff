"""End-to-end training example of the PyTorch port (the twin of
examples/train_lm.py): a reduced llama-family model for a few hundred
steps on synthetic structured text, with checkpoints and restart, through
the port's launcher (``repro_torch.launch.train``).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]   # GPU
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps), "--batch", "16", "--seq", "256",
        "--lr", "6e-4",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_train_lm"),
        "--log-every", "20", "--device", args.device,
    ])


if __name__ == "__main__":
    main()
