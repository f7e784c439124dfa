"""Data-parallel training over ranks, one per card, with the PyTorch port
(``tpugan_torch``).

Each rank is a process holding its shard of the global batch on its card;
the ranks join one ``torch.distributed`` process group (NCCL between
cards) and the step all-reduces the gradients and BatchNorm's batch
statistics over the ('data',) mesh.  With one rank it degenerates to the
plain step.  To try the multi-rank path without cards, run gloo ranks on
the CPU:

    python examples_torch/data_parallel_training.py --device cpu --world 2 \\
        --steps 20

``--world 2 --backend gloo`` runs two ranks on a one-card machine.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse

import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.parallel import make_mesh, multihost
from tpugan_torch.train.trainer import Trainer
from tpugan_torch.utils.device import resolve_device


def train_rank(rank, cfg, n, device):
    mesh = make_mesh(n, device) if n > 1 else None
    return Trainer(cfg, mesh=mesh, device=device).train()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks (default: one per card; one on the CPU)")
    ap.add_argument("--backend", default="", choices=["", "nccl", "gloo"],
                    help="process group backend (default: NCCL for CUDA "
                         "ranks, one a card; gloo shares a card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n = args.world or cards or 1
    print(f"{n} device(s): "
          f"{[f'cuda:{r % cards}' if cards else 'cpu' for r in range(n)]}")
    cfg = get_preset("dcgan_cifar10").override({
        "data.dataset": "synthetic",
        "data.batch_size": 16 * n,  # global batch scales with the mesh
        "train.total_steps": args.steps,
        "train.log_every": max(args.steps // 5, 1),
        "train.sample_every": 0, "train.ckpt_every": 0,
    })
    if n == 1:
        print(train_rank(0, cfg, n, args.device))
    else:
        print(multihost.spawn(train_rank, n, (cfg, n, args.device),
                              backend=args.backend or None,
                              device=args.device)[0])


if __name__ == "__main__":
    main()
