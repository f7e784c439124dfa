"""InceptionV3 (the FID variant) as ``nn.Module``s: the true-FID feature
extractor (port of ``tpugan/eval/inception.py``).

The network is pytorch-fid's FID InceptionV3: a 299 x 299 input in
[-1, 1], stem, 3 x InceptionA, InceptionB, 4 x InceptionC, InceptionD,
2 x InceptionE, a global average pool to 2048-d features and an fc to 1008
logits.  BatchNorm eps 1e-3, convs without bias; the branch average pools
divide by the count of valid cells (``count_include_pad=False``) and
Mixed_7c's pool branch is a stride-1 max pool, the FID checkpoint's quirks.

The modules keep the JAX package's parameter paths (``Mixed_5b.branch1x1``
holds ``w`` in HWIO, ``scale``, ``bias``, ``mean``, ``var``; ``fc`` holds
``w`` (2048, 1008) and ``b``), so carrying weights across is a name map:
``InceptionV3.from_params`` takes the JAX package's nested dict, from
``init_random`` (threefry, the JAX draws), ``load_weights`` (an npz or
pickle of those paths, a local file only) or ``convert_torch_state_dict``
(a pytorch-fid ``state_dict``).  Nothing is downloaded: real weights come
through ``eval.inception_weights``.

Layout: NHWC in (the port's convention), NCHW inside, where PyTorch's
convolutions want it.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ckpt.from_jax import load_jax_module
from tpugan_torch.sample import threefry

BN_EPS = 1e-3
FEATURE_DIM = 2048
N_LOGITS = 1008  # the TF-ported FID checkpoint's class count


class BasicConv(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3, running statistics) + ReLU;
    the weight in HWIO, as the JAX package keeps it."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(kh, kw, cin, cout),
                              requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x, stride: int = 1, padding=0):
        y = F.conv2d(x, self.w.permute(3, 2, 0, 1), stride=stride,
                     padding=padding)
        inv = torch.rsqrt(self.var + BN_EPS) * self.scale
        y = ((y - self.mean[:, None, None]) * inv[:, None, None]
             + self.bias[:, None, None])
        return torch.relu(y)


class Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, dout), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(dout), requires_grad=False)

    def forward(self, x):
        return x @ self.w + self.b


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, k, s)


def _avgpool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _inception_a(m, x):
    b1 = m.branch1x1(x)
    b5 = m.branch5x5_2(m.branch5x5_1(x), padding=2)
    b3 = m.branch3x3dbl_1(x)
    b3 = m.branch3x3dbl_2(b3, padding=1)
    b3 = m.branch3x3dbl_3(b3, padding=1)
    return _cat(b1, b5, b3, m.branch_pool(_avgpool(x)))


def _inception_b(m, x):
    b3 = m.branch3x3(x, stride=2)
    bd = m.branch3x3dbl_1(x)
    bd = m.branch3x3dbl_2(bd, padding=1)
    bd = m.branch3x3dbl_3(bd, stride=2)
    return _cat(b3, bd, _maxpool(x))


def _inception_c(m, x):
    b1 = m.branch1x1(x)
    b7 = m.branch7x7_1(x)
    b7 = m.branch7x7_2(b7, padding=(0, 3))
    b7 = m.branch7x7_3(b7, padding=(3, 0))
    bd = m.branch7x7dbl_1(x)
    bd = m.branch7x7dbl_2(bd, padding=(3, 0))
    bd = m.branch7x7dbl_3(bd, padding=(0, 3))
    bd = m.branch7x7dbl_4(bd, padding=(3, 0))
    bd = m.branch7x7dbl_5(bd, padding=(0, 3))
    return _cat(b1, b7, bd, m.branch_pool(_avgpool(x)))


def _inception_d(m, x):
    b3 = m.branch3x3_2(m.branch3x3_1(x), stride=2)
    b7 = m.branch7x7x3_1(x)
    b7 = m.branch7x7x3_2(b7, padding=(0, 3))
    b7 = m.branch7x7x3_3(b7, padding=(3, 0))
    b7 = m.branch7x7x3_4(b7, stride=2)
    return _cat(b3, b7, _maxpool(x))


def _inception_e(m, x, pool="avg"):
    b1 = m.branch1x1(x)
    b3 = m.branch3x3_1(x)
    b3 = _cat(m.branch3x3_2a(b3, padding=(0, 1)),
              m.branch3x3_2b(b3, padding=(1, 0)))
    bd = m.branch3x3dbl_1(x)
    bd = m.branch3x3dbl_2(bd, padding=1)
    bd = _cat(m.branch3x3dbl_3a(bd, padding=(0, 1)),
              m.branch3x3dbl_3b(bd, padding=(1, 0)))
    # the FID checkpoint's Mixed_7c pools its pool branch with a stride-1
    # padded MAX pool where every other block averages
    bp = F.max_pool2d(x, 3, 1, 1) if pool == "max" else _avgpool(x)
    return _cat(b1, b3, bd, m.branch_pool(bp))


class InceptionV3(nn.Module):
    """The FID InceptionV3; ``forward`` takes (N, 299, 299, 3) float in
    [-1, 1] and returns (pool3 features (N, 2048), logits (N, 1008))."""

    def __init__(self):
        super().__init__()
        for path, cin, cout, kh, kw in _conv_defs():
            parent = self
            *blocks, leaf = path.split(".")
            for b in blocks:
                if not hasattr(parent, b):
                    parent.add_module(b, nn.Module())
                parent = getattr(parent, b)
            parent.add_module(leaf, BasicConv(cin, cout, kh, kw))
        self.fc = Dense(FEATURE_DIM, N_LOGITS)

    @classmethod
    def from_params(cls, params: Dict, device="cuda") -> "InceptionV3":
        """The network holding the JAX-layout ``params`` (nested dicts of
        arrays) on ``device``; a missing or extra path raises."""
        return load_jax_module(cls(), params, {}).to(device).eval()

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2)
        x = self.Conv2d_1a_3x3(x, stride=2)        # 149
        x = self.Conv2d_2a_3x3(x)                  # 147
        x = self.Conv2d_2b_3x3(x, padding=1)       # 147
        x = _maxpool(x)                            # 73
        x = self.Conv2d_3b_1x1(x)                  # 73
        x = self.Conv2d_4a_3x3(x)                  # 71
        x = _maxpool(x)                            # 35
        x = _inception_a(self.Mixed_5b, x)
        x = _inception_a(self.Mixed_5c, x)
        x = _inception_a(self.Mixed_5d, x)
        x = _inception_b(self.Mixed_6a, x)         # 17
        for blk in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d,
                    self.Mixed_6e):
            x = _inception_c(blk, x)
        x = _inception_d(self.Mixed_7a, x)         # 8
        x = _inception_e(self.Mixed_7b, x)
        x = _inception_e(self.Mixed_7c, x, pool="max")  # 8 x 8 x 2048
        feat = x.float().mean(dim=(2, 3))          # (N, 2048)
        return feat, self.fc(feat)


def resize_to_299(images: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of NHWC float images to 299 x 299 (half-pixel
    centres, the border pixels clamped): ``jax.image.resize``'s bilinear
    for the enlargements the eval makes (28, 32, 64 or 128 px)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(299, 299),
                      mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


# (path, cin, cout, kh, kw) for every conv, in the JAX package's order
def _conv_defs() -> List[Tuple[str, int, int, int, int]]:
    defs = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]

    def a_block(path, cin, pool):
        return [
            (f"{path}.branch1x1", cin, 64, 1, 1),
            (f"{path}.branch5x5_1", cin, 48, 1, 1),
            (f"{path}.branch5x5_2", 48, 64, 5, 5),
            (f"{path}.branch3x3dbl_1", cin, 64, 1, 1),
            (f"{path}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{path}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{path}.branch_pool", cin, pool, 1, 1),
        ]

    defs += a_block("Mixed_5b", 192, 32)
    defs += a_block("Mixed_5c", 256, 64)
    defs += a_block("Mixed_5d", 288, 64)
    defs += [
        ("Mixed_6a.branch3x3", 288, 384, 3, 3),
        ("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1),
        ("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3),
    ]

    def c_block(path, c7):
        return [
            (f"{path}.branch1x1", 768, 192, 1, 1),
            (f"{path}.branch7x7_1", 768, c7, 1, 1),
            (f"{path}.branch7x7_2", c7, c7, 1, 7),
            (f"{path}.branch7x7_3", c7, 192, 7, 1),
            (f"{path}.branch7x7dbl_1", 768, c7, 1, 1),
            (f"{path}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{path}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{path}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{path}.branch7x7dbl_5", c7, 192, 1, 7),
            (f"{path}.branch_pool", 768, 192, 1, 1),
        ]

    defs += c_block("Mixed_6b", 128)
    defs += c_block("Mixed_6c", 160)
    defs += c_block("Mixed_6d", 160)
    defs += c_block("Mixed_6e", 192)
    defs += [
        ("Mixed_7a.branch3x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch3x3_2", 192, 320, 3, 3),
        ("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
        ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
        ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3),
    ]

    def e_block(path, cin):
        return [
            (f"{path}.branch1x1", cin, 320, 1, 1),
            (f"{path}.branch3x3_1", cin, 384, 1, 1),
            (f"{path}.branch3x3_2a", 384, 384, 1, 3),
            (f"{path}.branch3x3_2b", 384, 384, 3, 1),
            (f"{path}.branch3x3dbl_1", cin, 448, 1, 1),
            (f"{path}.branch3x3dbl_2", 448, 384, 3, 3),
            (f"{path}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{path}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{path}.branch_pool", cin, 192, 1, 1),
        ]

    defs += e_block("Mixed_7b", 1280)
    defs += e_block("Mixed_7c", 2048)
    return defs


def param_paths() -> List[str]:
    return [d[0] for d in _conv_defs()] + ["fc"]


def init_random(seed: int = 0) -> Dict:
    """Random weights (shape and flow testing; NOT a trained network): the
    JAX package's ``init_random(seed)``, drawn with the numpy threefry
    (normals within an ulp of JAX's), as its nested dict of float32
    arrays."""
    key = threefry.prng_key(seed)
    params: Dict = {}
    for (path, cin, cout, kh, kw) in _conv_defs():
        key, k = threefry.split(key, 2)
        params[path] = {
            "w": threefry.normal(k, (kh, kw, cin, cout))
            / np.float32(np.sqrt(kh * kw * cin)),
            "scale": np.ones((cout,), np.float32),
            "bias": np.zeros((cout,), np.float32),
            "mean": np.zeros((cout,), np.float32),
            "var": np.ones((cout,), np.float32),
        }
    key, k = threefry.split(key, 2)
    params["fc"] = {
        "w": threefry.normal(k, (FEATURE_DIM, N_LOGITS))
        / np.float32(np.sqrt(FEATURE_DIM)),
        "b": np.zeros((N_LOGITS,), np.float32),
    }
    return params


def load_weights(path: str) -> Dict:
    """A converted weight file (npz with ``<path>/<leaf>`` keys, or a
    pickle of the nested dict) as nested dicts of float32 arrays.  Unpickle
    only a file you made: unpickling runs code."""
    if path.endswith(".npz"):
        nested: Dict = {}
        with np.load(path) as flat:
            for k in flat.files:
                mod, leaf = k.rsplit("/", 1)
                nested.setdefault(mod, {})[leaf] = np.asarray(flat[k],
                                                              np.float32)
        return nested
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return {mod: {leaf: np.asarray(a, np.float32) for leaf, a in d.items()}
            for mod, d in raw.items()}


def convert_torch_state_dict(state_dict) -> Dict:
    """A pytorch-fid / torchvision InceptionV3 ``state_dict`` (numpy-fied)
    in this module's layout: '<block>.conv.weight' (O, I, H, W) -> w HWIO;
    '<block>.bn.{weight,bias,running_mean,running_var}' -> scale / bias /
    mean / var; 'fc.weight' (1008, 2048) -> w.T, 'fc.bias' -> b."""
    out: Dict = {}
    for (path, cin, cout, kh, kw) in _conv_defs():
        w = np.asarray(state_dict[f"{path}.conv.weight"])
        out[path] = {
            "w": w.transpose(2, 3, 1, 0),
            "scale": np.asarray(state_dict[f"{path}.bn.weight"]),
            "bias": np.asarray(state_dict[f"{path}.bn.bias"]),
            "mean": np.asarray(state_dict[f"{path}.bn.running_mean"]),
            "var": np.asarray(state_dict[f"{path}.bn.running_var"]),
        }
    out["fc"] = {"w": np.asarray(state_dict["fc.weight"]).T,
                 "b": np.asarray(state_dict["fc.bias"])}
    return out
