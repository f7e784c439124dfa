"""Multi-host training with the PyTorch port (``tpugan_torch``): one Trainer
per process, one global mesh.

Every process runs THIS script with the same arguments plus its own
--process-id; `initialize_multihost` joins them in one torch.distributed
process group (one rank a process, on its card), after which
`make_mesh()` spans every rank and `Trainer(cfg, mesh=mesh).train()` runs
the usual loop: each rank feeds its own shard of the global batch, the
step all-reduces gradients and BatchNorm statistics, rank 0 writes
samples, metrics and checkpoints, and `train.resume` works across
restarts of the whole job.

Try it on one machine with two processes of gloo ranks on the CPU:

    python examples_torch/train_multihost.py --device cpu --num-processes 2 \\
        --process-id 0 --coordinator 127.0.0.1:9876 --out /tmp/mh &
    python examples_torch/train_multihost.py --device cpu --num-processes 2 \\
        --process-id 1 --coordinator 127.0.0.1:9876 --out /tmp/mh

(two processes sharing one card: --device cuda --backend gloo).  Under
`torchrun`, drop the explicit flags and pass --autodetect:
`initialize_multihost(autodetect=True)` reads the launcher's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import dataclasses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun: "
                         "autodetected)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--autodetect", action="store_true",
                    help="torchrun: bootstrap from the launcher's "
                         "environment instead of explicit coordinator flags")
    ap.add_argument("--preset", default="dcgan_cifar10")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="runs/multihost")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    ap.add_argument("--backend", default="", choices=["", "nccl", "gloo"],
                    help="process group backend (default: NCCL for CUDA "
                         "ranks, one a card; gloo shares a card)")
    args = ap.parse_args()

    from tpugan_torch.parallel import multihost
    from tpugan_torch.utils.device import resolve_device

    resolve_device(args.device)
    idx = multihost.initialize_multihost(
        args.coordinator, args.num_processes, args.process_id,
        autodetect=args.autodetect, backend=args.backend or None,
        device=args.device)

    from tpugan_torch.configs import get_preset
    from tpugan_torch.parallel import make_mesh
    from tpugan_torch.train.trainer import Trainer

    world = multihost.world_size()
    print(f"[process {idx}] {world} processes, {world} global devices")

    cfg = get_preset(args.preset).override({
        "data.dataset": "synthetic", "data.batch_size": 16,
        "data.synthetic_size": 64, "model.ngf": 8, "model.ndf": 8,
        "model.nz": 8, "train.precision": "fp32",
        "train.total_steps": args.steps, "train.log_every": 5,
        "train.sample_every": 0, "train.ckpt_every": 10})
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, out_dir=args.out, ckpt_dir=args.out + "/ckpt"))

    # all ranks, one ('data',) axis (one process alone: the plain step)
    mesh = make_mesh(device=args.device) if world > 1 else None
    try:
        metrics = Trainer(cfg, mesh=mesh, device=args.device).train()
    finally:
        multihost.shutdown()
    print(f"[process {idx}] done: loss_d={metrics['loss_d']:.4f} "
          f"(identical on every process — the state is replicated)")


if __name__ == "__main__":
    main()
