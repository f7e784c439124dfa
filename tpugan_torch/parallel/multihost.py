"""The multi-process bootstrap (port of ``tpugan/parallel/multihost.py``).

The JAX package runs one process that drives a mesh of devices; the port
runs one process per rank, joined by ``torch.distributed``.  A rank's
device is ``cuda:(local_rank % torch.cuda.device_count())``, or the CPU
when the caller asks for it.  The backend is chosen explicitly:

- NCCL for CUDA ranks, one rank per card;
- gloo for CPU ranks;
- gloo for CUDA ranks only when the caller passes ``backend="gloo"`` (how
  two ranks share one card: NCCL refuses two ranks on one GPU); asking for
  more CUDA ranks than cards without it raises.

``initialize_multihost`` joins a process group (a coordinator address,
explicit, or the launcher's environment under ``torchrun``), ``spawn``
starts ``world`` local ranks that meet through a file store in a fresh
temporary directory, never a fixed port.  Ranks fork from a forkserver
that has imported ``torch`` and the package once (``rank_context``), so
a rank does not pay those imports again; the forkserver touches no CUDA
API, and a rank binds its card after the fork.  In the port every
process holds only its own shard of a batch, so ``make_global_batch``
just moves the local rows to the rank's device.
"""

from __future__ import annotations

import atexit
import os
import queue
import shutil
import signal
import tempfile
import threading
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpugan_torch.utils.device import resolve_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def is_main_process() -> bool:
    """True on the process that owns side effects (PNG grids, metric files,
    checkpoint writes); compute runs everywhere."""
    return process_index() == 0


def choose_backend(device, n_local: int, backend: Optional[str] = None
                   ) -> str:
    """The process group's backend for ``n_local`` ranks on this host, each
    on ``device``: NCCL for CUDA, gloo for the CPU, gloo for CUDA only when
    asked for."""
    kind = torch.device(device).type
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA ranks; use gloo for the CPU")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if n_local > cards:
        raise ValueError(
            f"{n_local} CUDA ranks on this host but only {cards} card(s): "
            f"NCCL takes one rank per card; pass backend='gloo' to share "
            f"cards")
    return "nccl"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: its card (``local_rank % device_count``) for
    CUDA, the CPU for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         autodetect: bool = False, *,
                         backend: Optional[str] = None,
                         device="cuda") -> int:
    """Join the process group; returns this process's rank.

    With no arguments on a single process this is a no-op returning 0.
    ``autodetect=True`` reads the launcher's environment (``torchrun``'s
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  An
    explicit cluster is ``coordinator_address`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL), ``num_processes`` and ``process_id``.
    CUDA ranks bind their card (``rank_device``).
    """
    # ranks on this host: the launcher's LOCAL_WORLD_SIZE (``spawn`` and
    # torchrun set it), else this process alone
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if autodetect and coordinator_address is None and num_processes is None:
        dist.init_process_group(choose_backend(device, n_local, backend),
                                init_method="env://")
    elif coordinator_address is None and num_processes in (None, 1):
        if process_id not in (None, 0):
            # a half-specified cluster: running alone would train every
            # process independently, with no gradient sync
            raise ValueError(
                f"process_id={process_id} given without "
                f"coordinator_address/num_processes: pass both (or "
                f"autodetect=True under torchrun) to join the cluster")
        return 0
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "an explicit cluster needs coordinator_address, "
                "num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(choose_backend(device, n_local, backend),
                                init_method=url, world_size=num_processes,
                                rank=process_id)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rows(global_batch: int, n: int, index: int, accum: int = 1
               ) -> np.ndarray:
    """The rows of a global batch that shard ``index`` of ``n`` holds:
    its slice of each of ``accum`` microbatches (microbatch-major), so
    that ``local.chunk(accum)[j]`` is its slice of global microbatch j."""
    if global_batch % (n * accum):
        raise ValueError(
            f"batch {global_batch} does not split into {accum} "
            f"microbatch(es) over {n} data shard(s)")
    micro, per = global_batch // accum, global_batch // (accum * n)
    return np.concatenate([np.arange(j * micro + index * per,
                                     j * micro + (index + 1) * per)
                           for j in range(accum)])


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a batch sharded over every
    process."""
    n, i = world_size(), process_index()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def make_global_batch(local_batch: dict, device) -> dict:
    """This rank's rows, on its device: in the port every process holds
    only its own shard, so the JAX package's assembly of a global array is
    a copy to the device."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in local_batch.items()}


# ---------------------------------------------------------------------------
# The local spawner
# ---------------------------------------------------------------------------

# What a rank imports before its first step, imported once in the
# forkserver: ``torch._dynamo`` comes with the first optimizer
# (``torch.optim``'s ``add_param_group`` imports it), the package with the
# Trainer and the CLI's rank functions.  None of these calls a CUDA API
# when imported.
PRELOAD = ("torch", "torch.distributed", "torch._dynamo",
           "tpugan_torch.parallel", "tpugan_torch.train.trainer",
           "tpugan_torch.cli")


def rank_context():
    """The ``multiprocessing`` context that rank processes start from: a
    forkserver that preloads ``PRELOAD``.  The forkserver is started on
    the first ``Process.start`` and serves this process from then on (its
    preload is fixed then); this process stops it at exit
    (``stop_forkserver``)."""
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    # left alone, it would outlive this process by the second or two it
    # takes to tear down its imports
    atexit.unregister(stop_forkserver)
    atexit.register(stop_forkserver)
    return ctx


def stop_forkserver() -> None:
    """Stop the ranks' forkserver, if one runs, and wait for it to exit
    (``multiprocessing``'s own stop, the one its tests use)."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _entry(rank, world, fn, args, url, backend, device, env, threads,
           results):
    # a forked rank has the forkserver's environment: take the parent's
    os.environ.clear()
    os.environ.update(env)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    try:
        initialize_multihost(url, world, rank, backend=backend,
                             device=device)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:  # report to the parent, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: Sequence = (), *,
          backend: Optional[str] = None, device="cuda",
          timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group; returns their results by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path); the ranks
    fork from ``rank_context``'s forkserver with this process's working
    directory, ``sys.path`` and environment, and meet through a file store
    in a fresh temporary directory.  CPU ranks split this process's
    threads (``torch.get_num_threads``) between them: each taking as many
    would oversubscribe the host ``world`` times over.  A SIGTERM or
    SIGINT sent to this process is passed on to the ranks; a rank that
    fails or dies stops the others, and the failure is raised here with its
    traceback.
    """
    world = int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    choose_backend(device, world, backend)  # refuse before starting any
    ctx = rank_context()
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tpugan_torch_rdzv_")
    url = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_entry, daemon=False,
                         args=(r, world, fn, tuple(args), url, backend,
                               str(device), dict(os.environ),
                               max(1, torch.get_num_threads() // world),
                               results))
             for r in range(world)]

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    main = threading.current_thread() is threading.main_thread()
    prev = ({s: signal.signal(s, forward)
             for s in (signal.SIGTERM, signal.SIGINT)} if main else {})
    out, failed = {}, None
    try:
        for p in procs:
            p.start()
        waited = 0.0
        while len(out) < world and failed is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [p for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    # a rank that died without reporting (a signal, a
                    # crash in native code): drain what was reported
                    try:
                        rank, ok, val = results.get(timeout=5.0)
                    except queue.Empty:
                        failed = (f"rank exited with code "
                                  f"{dead[0].exitcode} without a result")
                        break
                elif timeout is not None and waited > timeout:
                    failed = f"ranks timed out after {timeout} s"
                    break
                else:
                    continue
            if ok:
                out[rank] = val
            else:
                failed = f"rank {rank} failed:\n{val}"
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        for p in procs:
            p.join(timeout=30 if failed is None else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed is not None:
        raise RuntimeError(failed)
    return [out[r] for r in range(world)]
