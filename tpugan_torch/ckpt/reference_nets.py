"""The reference ``.pth`` layout: the gan-playground idiom of each
architecture as plain ``torch.nn`` modules, and the map between their keys
and the port's (the port's copy of the JAX package's
``tpugan/parity/torch_twin.py`` modules and ``build_torch_twins``).

A reference-style checkpoint is a ``state_dict`` of these modules: NCHW
convolutions (``Conv2d`` weights OIHW, ``ConvTranspose2d`` weights IOHW),
``Linear`` weights (dout, din), ``BatchNorm2d`` with ``running_mean`` /
``running_var`` / ``num_batches_tracked``, and spectral norm's ``u`` as a
buffer beside the weight.  The port keeps the JAX layouts and names
(HWIO ``w``, Dense ``(din, dout)``, BatchNorm ``scale`` / ``bias`` /
``mean`` / ``var``), so one checkpoint maps onto the other key by key:

    port ConvT w HWIO -> ConvTranspose2d IOHW: permute(2, 3, 0, 1)
    port Conv  w HWIO -> Conv2d OIHW:          permute(3, 2, 0, 1)
    port Dense w (din, dout) -> Linear (dout, din): .T

``key_map`` gives that map for a reference module, ``build_reference_nets``
the modules with the port's weights and buffers copied in.  The modules'
``parameters()`` order indexes an exported optimizer state
(``ckpt/torch_export.py``).  Their forwards compute what the port's
modules compute (NCHW in, the head reshaped in the port's NHWC order).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as tnn

from tpugan_torch.configs import Config
from tpugan_torch.models.dcgan import _d_schedule, _g_schedule
from tpugan_torch.models.registry import resolve_embed_dim

# port -> reference layout of a weight, by kind; "id" copies
_TO_REF = {
    "convt": lambda t: t.permute(2, 3, 0, 1),
    "conv": lambda t: t.permute(3, 2, 0, 1),
    "dense": lambda t: t.t(),
    "id": lambda t: t,
}
# reference -> port: the inverses
_FROM_REF = {
    "convt": lambda t: t.permute(2, 3, 0, 1),
    "conv": lambda t: t.permute(2, 3, 1, 0),
    "dense": lambda t: t.t(),
    "id": lambda t: t,
}
_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean",
       "running_var": "var"}


class TorchGenerator(tnn.Module):
    """The generator in the reference idiom (Dense head variant)."""

    def __init__(self, image_size: int, channels: int, nz: int, ngf: int,
                 batchnorm: bool = True, head_in: int = 0):
        super().__init__()
        s0, chans = _g_schedule(image_size, ngf)
        self.s0, self.c0 = s0, chans[0]
        self.head = tnn.Linear(head_in or nz, s0 * s0 * chans[0],
                               bias=not batchnorm)
        self.head_bn = tnn.BatchNorm2d(chans[0]) if batchnorm else None
        blocks = []
        for cin, cout in zip(chans[:-1], chans[1:]):
            blocks.append(tnn.ConvTranspose2d(cin, cout, 4, 2, 1,
                                              bias=not batchnorm))
            blocks.append(tnn.BatchNorm2d(cout) if batchnorm
                          else tnn.Identity())
            blocks.append(tnn.ReLU(True))
        self.blocks = tnn.Sequential(*blocks)
        self.final = tnn.ConvTranspose2d(chans[-1], channels, 4, 2, 1,
                                         bias=True)

    def forward(self, z):
        x = self.head(z).view(-1, self.s0, self.s0, self.c0)
        x = x.permute(0, 3, 1, 2)  # the port's NHWC reshape order
        if self.head_bn is not None:
            x = self.head_bn(x)
        x = torch.relu(x)
        x = self.blocks(x)
        return torch.tanh(self.final(x))


def _sn_normalize(x):
    return x * torch.rsqrt(torch.sum(x * x) + 1e-12)


class _SNBase(tnn.Module):
    """Spectral norm as the port computes it (``nn/spectral_norm.py``): the
    weight as a (d, cout) matrix, one power iteration in training forwards
    only, sigma = v . (W u) with u and v constant."""

    def _init_u(self, cout: int):
        self.register_buffer("u", _sn_normalize(torch.randn(cout)))

    def _w_mat(self):
        raise NotImplementedError

    def _normed_weight(self):
        w_mat = self._w_mat()
        u = self.u
        with torch.no_grad():
            wm = w_mat.detach()
            if self.training:
                v = _sn_normalize(wm @ u)
                u = _sn_normalize(wm.t() @ v)
                self.u.copy_(u)
            v = _sn_normalize(wm @ u)
        return self.weight / (v @ (w_mat @ u))


class SNConv2d(_SNBase):
    """Conv2d on its spectrally normalized weight."""

    def __init__(self, cin, cout, kernel, stride, padding, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = tnn.Parameter(torch.empty(cout, cin, kernel, kernel))
        tnn.init.normal_(self.weight, 0.0, 0.02)
        self.bias = tnn.Parameter(torch.zeros(cout)) if bias else None
        self._init_u(cout)

    def _w_mat(self):
        # the port's HWIO w.reshape(-1, cout) is OIHW permuted to HWIO
        return self.weight.permute(2, 3, 1, 0).reshape(
            -1, self.weight.shape[0])

    def forward(self, x):
        return torch.nn.functional.conv2d(
            x, self._normed_weight(), self.bias, stride=self.stride,
            padding=self.padding)


class SNLinear(_SNBase):
    """Linear on its spectrally normalized weight."""

    def __init__(self, din, dout, bias=True):
        super().__init__()
        self.weight = tnn.Parameter(torch.empty(dout, din))
        tnn.init.normal_(self.weight, 0.0, 0.02)
        self.bias = tnn.Parameter(torch.zeros(dout)) if bias else None
        self._init_u(dout)

    def _w_mat(self):
        return self.weight.t()  # the port's Dense w is (din, dout)

    def forward(self, x):
        return torch.nn.functional.linear(x, self._normed_weight(),
                                          self.bias)


class TorchDiscriminator(tnn.Module):
    """The discriminator in the reference idiom (spectral norm on every
    conv and the tail, and no BatchNorm, for SNGAN)."""

    def __init__(self, image_size: int, channels: int, ndf: int,
                 batchnorm: bool = True, leak: float = 0.2,
                 spectral_norm: bool = False):
        super().__init__()
        s0, chans = _d_schedule(image_size, ndf)
        layers = []
        cin = channels
        for i, cout in enumerate(chans):
            bn = batchnorm and not spectral_norm and i > 0
            if spectral_norm:
                layers.append(SNConv2d(cin, cout, 4, 2, 1, bias=True))
            else:
                layers.append(tnn.Conv2d(cin, cout, 4, 2, 1, bias=not bn))
            if bn:
                layers.append(tnn.BatchNorm2d(cout))
            layers.append(tnn.LeakyReLU(leak, True))
            cin = cout
        self.features = tnn.Sequential(*layers)
        din = s0 * s0 * chans[-1]
        self.tail = (SNLinear(din, 1, bias=True) if spectral_norm
                     else tnn.Linear(din, 1, bias=True))

    def forward(self, x):
        h = self.features(x)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
        return self.tail(h)[:, 0]


class TorchCondGenerator(tnn.Module):
    """The conditional generator: the label's embedding joins z."""

    def __init__(self, image_size: int, channels: int, nz: int, ngf: int,
                 n_classes: int, embed_dim: int = 50, batchnorm: bool = True):
        super().__init__()
        self.embed = tnn.Embedding(n_classes, embed_dim)
        self.g = TorchGenerator(image_size, channels, nz, ngf,
                                batchnorm=batchnorm, head_in=nz + embed_dim)

    def forward(self, z, y):
        return self.g(torch.cat([z, self.embed(y)], dim=-1))


class TorchCondDiscriminator(tnn.Module):
    """The conditional discriminator: the label's plane is an extra input
    channel."""

    def __init__(self, image_size: int, channels: int, ndf: int,
                 n_classes: int, embed_dim: int = 50, batchnorm: bool = True,
                 spectral_norm: bool = False):
        super().__init__()
        self.image_size = image_size
        self.embed = tnn.Embedding(n_classes, embed_dim)
        self.proj = tnn.Linear(embed_dim, image_size * image_size)
        self.d = TorchDiscriminator(image_size, channels + 1, ndf,
                                    batchnorm=batchnorm,
                                    spectral_norm=spectral_norm)

    def forward(self, x, y):
        s = self.image_size
        plane = self.proj(self.embed(y)).view(-1, 1, s, s)
        return self.d(torch.cat([x, plane], dim=1))


KeyMap = Dict[str, Tuple[str, str]]


def _g_map(tg: TorchGenerator) -> KeyMap:
    m: KeyMap = {"head.weight": ("head.dense.w", "dense"),
                 "final.weight": ("final.conv.w", "convt"),
                 "final.bias": ("final.conv.b", "id")}
    if tg.head.bias is not None:
        m["head.bias"] = ("head.dense.b", "id")
    if tg.head_bn is not None:
        m.update({f"head_bn.{k}": (f"head.bn.{v}", "id")
                  for k, v in _BN.items()})
    for j, mod in enumerate(tg.blocks):  # (ConvT, BN | Identity, ReLU) x n
        blk = f"block{j // 3}"
        if isinstance(mod, tnn.ConvTranspose2d):
            m[f"blocks.{j}.weight"] = (f"{blk}.conv.w", "convt")
            if mod.bias is not None:
                m[f"blocks.{j}.bias"] = (f"{blk}.conv.b", "id")
        elif isinstance(mod, tnn.BatchNorm2d):
            m.update({f"blocks.{j}.{k}": (f"{blk}.bn.{v}", "id")
                      for k, v in _BN.items()})
    return m


def _d_map(td: TorchDiscriminator) -> KeyMap:
    m: KeyMap = {"tail.weight": ("tail.dense.w", "dense"),
                 "tail.bias": ("tail.dense.b", "id")}
    if isinstance(td.tail, SNLinear):
        m["tail.u"] = ("tail.dense.u", "id")
    i = -1
    for j, mod in enumerate(td.features):  # (Conv, [BN], LeakyReLU) x n
        if isinstance(mod, (tnn.Conv2d, SNConv2d)):
            i += 1
            m[f"features.{j}.weight"] = (f"block{i}.conv.w", "conv")
            if mod.bias is not None:
                m[f"features.{j}.bias"] = (f"block{i}.conv.b", "id")
            if isinstance(mod, SNConv2d):
                m[f"features.{j}.u"] = (f"block{i}.conv.u", "id")
        elif isinstance(mod, tnn.BatchNorm2d):
            m.update({f"features.{j}.{k}": (f"block{i}.bn.{v}", "id")
                      for k, v in _BN.items()})
    return m


def key_map(net: tnn.Module) -> KeyMap:
    """{reference key: (port key, layout kind)} for every parameter and
    buffer of the reference module ``net`` that the port holds
    (``num_batches_tracked`` has no port counterpart)."""
    if isinstance(net, TorchGenerator):
        return _g_map(net)
    if isinstance(net, TorchDiscriminator):
        return _d_map(net)
    if isinstance(net, TorchCondGenerator):
        return {"embed.weight": ("embed.table", "id"),
                **{f"g.{k}": (f"g.{p}", kind)
                   for k, (p, kind) in _g_map(net.g).items()}}
    if isinstance(net, TorchCondDiscriminator):
        return {"embed.weight": ("embed.table", "id"),
                "proj.weight": ("proj.w", "dense"),
                "proj.bias": ("proj.b", "id"),
                **{f"d.{k}": (f"d.{p}", kind)
                   for k, (p, kind) in _d_map(net.d).items()}}
    raise TypeError(f"not a reference net: {type(net).__name__}")


def to_reference(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A port tensor in the reference layout (a contiguous CPU copy)."""
    return _TO_REF[kind](t.detach().cpu()).clone(
        memory_format=torch.contiguous_format)


def from_reference(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A reference tensor in the port's layout (a contiguous copy)."""
    return _FROM_REF[kind](t.detach()).clone(
        memory_format=torch.contiguous_format)


def reference_nets(cfg: Config, only: str = "gd"
                   ) -> Tuple[Optional[tnn.Module], Optional[tnn.Module]]:
    """(G, D) in the reference idiom for ``cfg``'s architecture, freshly
    initialised; ``only`` ("g", "d" or "gd") limits which are built."""
    m = cfg.model
    conditional = m.arch == "cdcgan"
    ed = resolve_embed_dim(m) if conditional else 0
    tg = td = None
    if "g" in only:
        tg = (TorchCondGenerator(m.image_size, m.channels, m.nz, m.ngf,
                                 m.n_classes, ed, batchnorm=m.g_batchnorm)
              if conditional else
              TorchGenerator(m.image_size, m.channels, m.nz, m.ngf,
                             batchnorm=m.g_batchnorm))
    if "d" in only:
        td = (TorchCondDiscriminator(m.image_size, m.channels, m.ndf,
                                     m.n_classes, ed,
                                     batchnorm=m.d_batchnorm,
                                     spectral_norm=m.d_spectral_norm)
              if conditional else
              TorchDiscriminator(m.image_size, m.channels, m.ndf,
                                 batchnorm=m.d_batchnorm,
                                 spectral_norm=m.d_spectral_norm))
    return tg, td


@torch.no_grad()
def copy_into_reference(net: tnn.Module, port_sd: Mapping[str, torch.Tensor]
                        ) -> tnn.Module:
    """Copy a port ``state_dict`` (parameters and buffers by the port's
    names) into the reference module ``net``; returns it."""
    own = net.state_dict(keep_vars=True)
    for ref_key, (port_key, kind) in key_map(net).items():
        own[ref_key].copy_(to_reference(port_sd[port_key], kind))
    return net


def build_reference_nets(cfg: Config, g_sd: Optional[Mapping] = None,
                         d_sd: Optional[Mapping] = None):
    """(G, D) reference modules holding the port state_dicts ``g_sd`` /
    ``d_sd`` (either may be None: that net is not built), on the CPU."""
    only = ("g" if g_sd is not None else "") + ("d" if d_sd is not None
                                                else "")
    tg, td = reference_nets(cfg, only)
    if tg is not None:
        copy_into_reference(tg, g_sd)
    if td is not None:
        copy_into_reference(td, d_sd)
    return tg, td
