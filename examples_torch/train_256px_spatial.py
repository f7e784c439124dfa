"""Spatially-sharded training of the 256px DCGAN (the >=256px scaling path)
with the PyTorch port (``tpugan_torch``).

Feature maps are H-sharded over a ('space',) mesh of ranks: the convs
exchange one-row halos between neighbouring ranks
(``tpugan_torch/parallel/spatial.py``), BatchNorm's statistics are
all-reduced over the mesh, and the models themselves are unchanged: the
Trainer just sets train.spatial_shards.  Each rank is a process on its
card (NCCL between cards).

To try without cards, on gloo ranks on the CPU:

    python examples_torch/train_256px_spatial.py --device cpu --world 2 \\
        --steps 4 --width 8
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse

import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.parallel import multihost
from tpugan_torch.train.trainer import Trainer
from tpugan_torch.utils.device import resolve_device


def train_rank(rank, cfg, device):
    return Trainer(cfg, device=device).train()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--width", type=int, default=32,
                    help="ngf/ndf (use 8 for a quick CPU-mesh demo)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data-shards", type=int, default=0,
                    help=">0 composes data parallelism with spatial on a "
                         "2-D (data, space) mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks available (default: one per card; one on "
                         "the CPU)")
    ap.add_argument("--backend", default="", choices=["", "nccl", "gloo"],
                    help="process group backend (default: NCCL for CUDA "
                         "ranks, one a card; gloo shares a card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n = args.world or cards or 1
    print(f"{n} device(s): "
          f"{[f'cuda:{r % cards}' if cards else 'cpu' for r in range(n)]}")
    cfg = get_preset("dcgan_256_spatial").override({
        "data.dataset": "synthetic", "data.synthetic_size": 64,
        "data.batch_size": args.batch,
        "model.ngf": args.width, "model.ndf": args.width,
        "train.total_steps": args.steps,
        "train.log_every": max(args.steps // 5, 1),
        "train.sample_every": 0, "train.ckpt_every": 0,
        "train.spatial_shards": (min(4, n // args.data_shards)
                                 if args.data_shards else min(8, n)),
        "train.mesh_shape": args.data_shards or None,
    })
    # the mesh's ranks: the first (mesh_shape or 1) x spatial_shards
    need = (cfg.train.mesh_shape or 1) * max(cfg.train.spatial_shards, 1)
    if need == 1:
        print(train_rank(0, cfg, args.device))
    else:
        print(multihost.spawn(train_rank, need, (cfg, args.device),
                              backend=args.backend or None,
                              device=args.device)[0])


if __name__ == "__main__":
    main()
