"""Carry ``tpugan`` generator weights into a port module.

The JAX package keeps params and state as nested dicts (``head.dense.w``,
``block{i}.conv.w``, ``block{i}.bn.{scale,bias}``, state
``block{i}.bn.{mean,var}``, ``final.conv.{w,b}``, ``embed.table``, and the
conditional generator's ``g.*``).  The port's modules keep the same layouts
under the same names, so carrying weights across is a name map: the dotted
keys of params and state together are the module's ``state_dict`` keys.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dicts -> {dotted key: leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


@torch.no_grad()
def load_jax_generator(module: torch.nn.Module, params: Mapping,
                       state: Mapping) -> torch.nn.Module:
    """Copy JAX ``params`` and ``state`` (nested dicts of numpy arrays) into
    ``module`` in place; returns it.  A missing or extra key, or a wrong
    shape, raises."""
    src = flatten(params)
    for k, v in flatten(state).items():
        if k in src:
            raise KeyError(f"{k!r} is both a param and a state entry")
        src[k] = v
    dst = module.state_dict(keep_vars=True)
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"key mismatch: missing {missing}, extra {extra}")
    for k, t in dst.items():
        arr = np.array(src[k], np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {arr.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(arr))
    return module
