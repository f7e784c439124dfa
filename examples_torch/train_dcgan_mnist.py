"""Train DCGAN on MNIST (or the synthetic fallback when MNIST isn't on disk)
with the PyTorch port (``tpugan_torch``).

Equivalent of the reference's `main_dcgan.py --dataset mnist` entry point.

    python examples_torch/train_dcgan_mnist.py [--steps 5000] [--data-dir data]
        [--device cuda]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import dataclasses
import os

from tpugan_torch.configs import get_preset
from tpugan_torch.data.datasets import _find  # idx-file probe
from tpugan_torch.train.trainer import Trainer
from tpugan_torch.utils.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out", default="runs/dcgan_mnist")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    args = ap.parse_args()
    resolve_device(args.device)

    cfg = get_preset("dcgan_mnist")
    have_mnist = _find(args.data_dir, ["train-images-idx3-ubyte.gz",
                                       "train-images-idx3-ubyte"]) is not None
    overrides = {"train.total_steps": args.steps,
                 "data.data_dir": args.data_dir}
    if not have_mnist:
        print("MNIST idx files not found -> deterministic synthetic dataset")
        overrides["data.dataset"] = "synthetic"
    cfg = cfg.override(overrides)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, out_dir=args.out, ckpt_dir=os.path.join(args.out, "ckpt")))

    trainer = Trainer(cfg, device=args.device)
    metrics = trainer.train()
    print("final:", metrics)
    trainer.sampler().save_grid(os.path.join(args.out, "final_grid.png"),
                                n=64, seed=0)


if __name__ == "__main__":
    main()
