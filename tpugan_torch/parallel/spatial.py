"""Spatial (H or W) sharding with a halo exchange (port of
``tpugan/parallel/spatial.py``).

A feature map's H (``dim=1``) or W (``dim=2``) axis is sharded over the
mesh axis ``space``: each rank holds its rows and convolves them with one
row borrowed from each neighbour (``collectives.halo``; zeros at the
global borders, the convs' padding).  Per shard the convs are plain
``F.conv2d`` / ``F.conv_transpose2d`` on the haloed rows, as the JAX
package's are ``lax.conv_general_dilated`` under ``shard_map``; autograd
differentiates them, the halo's backward returns each borrowed row's
cotangent to its owner, and the weight, replicated, enters the sharded
compute through ``collectives.feed_sharded``, whose backward sums its
partial gradients over ``space``.  The ``data`` axis of a 2-D mesh is the
train step's: it all-reduces every gradient over ``data`` itself.

Halo arithmetic, k4/s2/p1: a conv shard of rows [h0, h0 + Hs) needs rows
h0 - 1 and h0 + Hs, and then no padding along the sharded axis: its
(Hs + 2) rows give Hs / 2 outputs.  The transpose conv shard needs the same
two rows; its full (unpadded) output over them has 2Hs + 6 rows, of which
rows 3 .. 2Hs + 2 are this shard's outputs 2h0 .. 2h0 + 2Hs - 1, so the
per-shard ConvT is padded by 3 along the sharded axis (1 along the other).

Which maps are sharded: a context (``spatial_ctx`` / ``set_spatial_mesh``)
holds the mesh, and ``ops/convs.py`` consults it ahead of the impl.  A
qualifying conv (k4/s2/p1; extent at least ``max(min_extent, 2n)`` and a
multiple of 2n for a conv, ``max(min_extent, n)`` and a multiple of n for
a transpose conv, n the ``space`` size) runs sharded and returns its
shard; a map too small runs replicated and enters or leaves the sharded
region through ``collectives.shard_of`` / ``gather_from_shard``.  A
model's input and output are replicated (``replicated``: the generator's
image and the discriminator's tail gather), so what happens between the
models (augmentation, the penalty's interpolates, the losses) is the
dense code.  Whether a map is a shard is read from its shape: a shard's
sharded extent is 1/n of the other spatial extent, and every whole map is
square (``is_sharded``).  So the context takes square maps only: a
non-square map that is not a shard raises, and so does a model input
read as a shard (``require_whole``), rather than being misread.
Train-mode BatchNorm over a shard reduces its statistics over ``space``
as well (``nn/layers.py``).

The context is process-wide (one process is one rank), not thread-local:
activation recomputation (``train.remat``) may re-run a forward on
autograd's own thread.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpugan_torch.parallel import collectives
from tpugan_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                        build_mesh, has_axis)


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def _space(mesh, axis: str):
    return axis_group(mesh, axis), axis_size(mesh, axis)


def _haloed(xs, mesh, axis: str, dim: int):
    group, _ = _space(mesh, axis)
    up, down = collectives.halo(xs, group, dim)
    return torch.cat([up, xs, down], dim=dim)


def spatial_conv2d(xs, w, mesh, *, axis: str = "space", dim: int = 1):
    """Conv(k=4, s=2, p=1) of a map sharded on H (dim=1) or W (dim=2).

    ``xs`` is this rank's shard (N, H/n, W, Cin) of a map whose extent is a
    multiple of 2n; w (4, 4, Cin, Cout).  Returns this rank's shard of the
    stride-2 output."""
    group, n = _space(mesh, axis)
    if (xs.shape[dim] * n) % (2 * n):
        raise ValueError(
            f"sharded dim {dim} extent {xs.shape[dim] * n} must be "
            f"divisible by 2*n_shards={2 * n} (stride-2 windows align with "
            f"shards)")
    xh = _haloed(xs, mesh, axis, dim)
    pad = (0, 1) if dim == 1 else (1, 0)
    wf = collectives.feed_sharded(w, group)
    return _to_nhwc(F.conv2d(_to_nchw(xh), wf.permute(3, 2, 0, 1),
                             stride=2, padding=pad))


def spatial_conv_transpose2d(xs, w, mesh, *, axis: str = "space",
                             dim: int = 1):
    """ConvT(k=4, s=2, p=1) (out = 2 x in) of a map sharded on H or W; w is
    HWIO unflipped, as in ``ops.convs.conv_transpose2d``.  Returns this
    rank's shard of the output."""
    group, n = _space(mesh, axis)
    xh = _haloed(xs, mesh, axis, dim)
    pad = (3, 1) if dim == 1 else (1, 3)
    wf = collectives.feed_sharded(w, group)
    return _to_nhwc(F.conv_transpose2d(_to_nchw(xh), wf.permute(2, 3, 0, 1),
                                       stride=2, padding=pad))


def shard_spatial(x, mesh, axis: str = "space", dim: int = 1):
    """This rank's tile of a whole (N, H, W, C) map: its slice of ``dim``
    over ``axis`` (and of the batch over ``data`` on a 2-D mesh)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    k = x.shape[dim] // n
    x = x.narrow(dim, i * k, k)
    if has_axis(mesh, "data") and axis != "data":
        nd, j = axis_size(mesh, "data"), axis_index(mesh, "data")
        b = x.shape[0] // nd
        x = x[j * b:(j + 1) * b]
    return x.contiguous()


def make_mesh_dp_spatial(n_data: int, n_space: int, device="cuda"):
    """2-D (data, space) mesh: the batch data-parallel and the feature maps
    spatially sharded; the gradient all-reduces ride ``data``, the halos
    ``space`` (adjacent ranks)."""
    if n_data < 1 or n_space < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"({n_data} data, {n_space} space)")
    return build_mesh((n_data, n_space), ("data", "space"), device)


# ---------------------------------------------------------------------------
# The spatial context: ops.convs.conv2d / conv_transpose2d consult it and
# route qualifying convs to the halo convs; the models stay unchanged.
# ---------------------------------------------------------------------------

class _SpatialCtx:
    mesh = None
    axis: str = "space"
    dim: int = 1
    min_extent: int = 0


_CTX = _SpatialCtx()


class spatial_ctx:
    """Context manager enabling spatial conv dispatch.  ``min_extent``
    keeps maps whose sharded extent is smaller replicated."""

    def __init__(self, mesh, *, axis: str = "space", dim: int = 1,
                 min_extent: int = 0):
        self.prev = None
        self.vals = (mesh, axis, dim, min_extent)

    def __enter__(self):
        self.prev = (_CTX.mesh, _CTX.axis, _CTX.dim, _CTX.min_extent)
        _CTX.mesh, _CTX.axis, _CTX.dim, _CTX.min_extent = self.vals
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.axis, _CTX.dim, _CTX.min_extent = self.prev


def set_spatial_mesh(mesh, *, axis: str = "space", dim: int = 1,
                     min_extent: int = 0) -> None:
    """Non-contextual form of spatial_ctx (the Trainer holds it for a whole
    run); pass None to disable."""
    _CTX.mesh, _CTX.axis, _CTX.dim, _CTX.min_extent = (
        mesh, axis, dim, min_extent)


def spatial_active() -> bool:
    """True while a spatial context is set (the fused paths' guard)."""
    return _CTX.mesh is not None


def current():
    """(mesh, axis, dim) of the active context; mesh None when off."""
    return _CTX.mesh, _CTX.axis, _CTX.dim


def _n() -> int:
    return axis_size(_CTX.mesh, _CTX.axis)


def is_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` (N, H, W, C) is this rank's shard of a map: its
    sharded extent is 1/n of the other spatial extent.  A whole map must
    be square: any other shape raises."""
    if _CTX.mesh is None or x.dim() != 4 or _n() == 1:
        return False
    d = _CTX.dim
    if x.shape[3 - d] == x.shape[d] * _n():
        return True
    if x.shape[1] != x.shape[2]:
        raise ValueError(
            f"spatial sharding takes square maps (a shard is told by its "
            f"shape); got a {tuple(x.shape[1:3])} map that is not a "
            f"{_n()}-way shard")
    return False


def require_whole(x: torch.Tensor) -> None:
    """A model's input map under a spatial context: whole and square (a
    map shaped as a shard would be misread as one)."""
    if is_sharded(x):
        raise ValueError(
            f"spatial sharding takes square maps; a model input of "
            f"{tuple(x.shape[1:3])} reads as a {_n()}-way shard")


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank: a shard is gathered (its backward takes
    the slice back); anything else passes through."""
    if not is_sharded(x):
        return x
    return collectives.gather_from_shard(x, axis_group(_CTX.mesh, _CTX.axis),
                                         _CTX.dim)


def feed(p: Optional[torch.Tensor], y: torch.Tensor):
    """Parameter ``p`` as it enters compute on ``y``: through
    ``feed_sharded`` when ``y`` is a shard (its gradient then sums over
    ``space``), else as it is."""
    if p is None or not is_sharded(y):
        return p
    return collectives.feed_sharded(p, axis_group(_CTX.mesh, _CTX.axis))


def bn_groups(x: torch.Tensor) -> list:
    """The ``space`` group when train-mode BatchNorm sees a shard."""
    return [axis_group(_CTX.mesh, _CTX.axis)] if is_sharded(x) else []


def _extent(x) -> int:
    return x.shape[_CTX.dim] * (_n() if is_sharded(x) else 1)


def _qualifies(w, stride: int, padding: int) -> bool:
    return (_CTX.mesh is not None and _n() > 1 and stride == 2
            and padding == 1 and tuple(w.shape[:2]) == (4, 4))


def _shard_input(x):
    if is_sharded(x):
        return x
    return collectives.shard_of(x, axis_group(_CTX.mesh, _CTX.axis),
                                _CTX.dim)


def maybe_spatial_conv2d(x, w, *, stride: int, padding: int):
    """ops.conv2d's seam: the sharded conv's output shard, or None for the
    default path (which then takes ``replicated(x)``)."""
    if not _qualifies(w, stride, padding):
        return None
    n, ext = _n(), _extent(x)
    if ext < max(_CTX.min_extent, 2 * n) or ext % (2 * n):
        return None
    return spatial_conv2d(_shard_input(x), w, _CTX.mesh, axis=_CTX.axis,
                          dim=_CTX.dim)


def maybe_spatial_conv_transpose2d(x, w, *, stride: int, padding: int):
    """ops.conv_transpose2d's seam: the sharded transpose conv's output
    shard, or None for the default path."""
    if not _qualifies(w, stride, padding):
        return None
    n, ext = _n(), _extent(x)
    if ext < max(_CTX.min_extent, n) or ext % n:
        return None
    return spatial_conv_transpose2d(_shard_input(x), w, _CTX.mesh,
                                    axis=_CTX.axis, dim=_CTX.dim)
