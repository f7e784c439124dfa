"""Train WGAN-GP on CIFAR-10 (synthetic fallback offline) with the PyTorch
port (``tpugan_torch``).

The double-backward gradient penalty runs as ``torch.autograd.grad`` with
``create_graph=True`` inside the train step; n_critic=5 critic steps per
generator step.

    python examples_torch/train_wgan_gp_cifar10.py [--steps 20000]
        [--device cuda]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import dataclasses
import os

from tpugan_torch.configs import get_preset
from tpugan_torch.train.trainer import Trainer
from tpugan_torch.utils.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out", default="runs/wgan_gp_cifar10")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    args = ap.parse_args()
    resolve_device(args.device)

    cfg = get_preset("wgan_gp_cifar10")
    overrides = {"train.total_steps": args.steps,
                 "data.data_dir": args.data_dir,
                 "train.eval_every": 2000}
    if not os.path.exists(os.path.join(args.data_dir,
                                       "cifar-10-batches-py")):
        print("CIFAR-10 not found -> deterministic synthetic dataset")
        overrides["data.dataset"] = "synthetic"
    cfg = cfg.override(overrides)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, out_dir=args.out, ckpt_dir=os.path.join(args.out, "ckpt")))

    print(Trainer(cfg, device=args.device).train())


if __name__ == "__main__":
    main()
