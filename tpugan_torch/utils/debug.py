"""Sanitizers (port of ``tpugan/utils/debug.py``).

A NaN or Inf creeping through a train step is the failure this module
finds: ``sanitize`` is the checking mode for CI and post-mortem reruns,
and ``assert_finite`` names the first non-finite leaf of a state on
demand (cheap enough to run on logged metrics every step).

``sanitize`` turns on ``torch.autograd.detect_anomaly(check_nan=True)``,
PyTorch's counterpart of ``jax.debug_nans``: every backward function's
output is checked, and the first one holding a NaN raises
``RuntimeError`` with the forward call that made it.  The JAX package's
``leaks`` argument (``jax.checking_leaks``) has no counterpart and is not
accepted: eager PyTorch has no tracers to leak.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import torch


@contextlib.contextmanager
def sanitize(nans: bool = True):
    """Check every backward for NaNs in the enclosed scope (CI mode).

    Anomaly mode records each forward's stack and checks each backward
    function's outputs: expensive, meant for tests, CI and post-mortem
    reruns, not production steps.
    """
    with (torch.autograd.detect_anomaly(check_nan=True) if nans
          else contextlib.nullcontext()):
        yield


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in ``jax.tree_util``'s order and ``keystr``'s
    notation: dict keys sorted, ``['k']`` for a key, ``[i]`` for a list or
    tuple index, ``.name`` for a namedtuple field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree: Any, where: str = "") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (nested
    dicts, lists and tuples of tensors) whose floating values hold a NaN or
    Inf (a host-side check; leaves that are not tensors are not checked)."""
    for name, leaf in _leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(
                    f"non-finite values at {name} {where}")
