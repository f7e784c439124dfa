"""Data parallelism over a mesh of ranks (port of
``tpugan/parallel/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` whose dimension names are
the JAX package's mesh axes: ``("data",)`` here, ``("data", "model")`` for
FSDP (``fsdp.py``), ``("data", "space")`` or ``("space",)`` for spatial
sharding (``spatial.py``).  Each axis's collectives run on that
dimension's process group.

- The global batch is sharded over ``data``: each rank holds its rows
  (``shard_batch``); parameters, optimizer state and BatchNorm / spectral
  norm state are replicated (``shard_train_state`` broadcasts them from
  the mesh's first rank).
- The train step (``train/steps.py``) all-reduces what XLA's partitioner
  all-reduces for the JAX step: the gradients over ``data``, and, through
  ``batch_ctx``, BatchNorm's batch statistics (``nn/layers.py``).
- Eval-side gathers (FID feature pooling) use ``all_gather_arrays``.

Every rank of the process group must call ``make_mesh`` (it creates
process groups); a mesh over the first n ranks leaves the others out.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpugan_torch.parallel import collectives
from tpugan_torch.parallel.multihost import world_size


def build_mesh(shape, names, device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks, dimensions
    named ``names``."""
    n = 1
    for s in shape:
        if s < 1:
            raise ValueError(f"mesh axes must be >= 1, got {tuple(shape)}")
        n *= s
    have = world_size()
    if n > have:
        raise ValueError(
            f"mesh {' x '.join(map(str, shape))} "
            f"{tuple(names)} needs {n} ranks, but only {have} rank(s) are "
            f"available")
    if not dist.is_initialized():
        raise ValueError("a mesh needs torch.distributed initialized "
                         "(multihost.initialize_multihost or spawn)")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """A ``("data",)`` mesh over the first ``n_devices`` ranks (default:
    all).  Asking for more ranks than exist raises: a silently smaller
    mesh would run a planned N-way job with a larger per-rank batch."""
    n = world_size() if n_devices is None else int(n_devices)
    if n > world_size():
        raise ValueError(f"requested a {n}-rank mesh but only "
                         f"{world_size()} rank(s) are available")
    return build_mesh((n,), ("data",), device)


def has_axis(mesh, name: str) -> bool:
    return mesh is not None and name in (mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name)) \
        if has_axis(mesh, name) else 1


def axis_index(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if has_axis(mesh, name) else 0


def axis_group(mesh, name: str):
    return mesh.get_group(name) if has_axis(mesh, name) else None


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def in_mesh(mesh) -> bool:
    return mesh is not None and mesh.get_coordinate() is not None


def _broadcast_over(tensors, mesh) -> None:
    """Every rank of the mesh takes coordinate 0's values, one axis after
    the other."""
    for name in mesh.mesh_dim_names:
        if axis_size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Replicate a module's parameters and buffers across the mesh (a
    broadcast from its first rank); returns the module."""
    _broadcast_over([t.data for t in module.parameters()]
                    + list(module.buffers()), mesh)
    return module


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them): its slice of the leading axis over ``data``."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def take(x):
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


def shard_train_state(state, mesh: DeviceMesh):
    """Replicate the whole TrainState (modules, EMA; the optimizers,
    key and step are the same on every rank by construction)."""
    for m in (state.g, state.d, state.g_ema):
        if m is not None:
            replicate(m, mesh)
    return state


def all_gather_arrays(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """A batch sharded over ``data``, gathered whole onto every rank (eval
    pooling)."""
    if axis_size(mesh, "data") == 1:
        return x
    return torch.cat(collectives.all_gather(x, axis_group(mesh, "data")))


# ---------------------------------------------------------------------------
# The batch axes of a train step: BatchNorm in train mode reduces its
# statistics over them (the JAX package's jnp.mean over a sharded batch).
# Process-wide, as the spatial context is: one process is one rank.
# ---------------------------------------------------------------------------

_BATCH_GROUP = [None]


@contextlib.contextmanager
def batch_ctx(mesh):
    """Inside the block, train-mode BatchNorm reduces over the mesh's
    ``data`` axis (a no-op for a mesh without one, or of one rank)."""
    prev = _BATCH_GROUP[0]
    _BATCH_GROUP[0] = (axis_group(mesh, "data")
                       if axis_size(mesh, "data") > 1 else None)
    try:
        yield
    finally:
        _BATCH_GROUP[0] = prev


def batch_group():
    """The ``data`` group train-mode BatchNorm reduces over, or None."""
    return _BATCH_GROUP[0]
