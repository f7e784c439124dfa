"""The plain reference: the repo's DCGAN G and D (its published widths
follow pytorch/examples ``dcgan/main.py``), the non-saturating BCE losses,
Adam and one train step (FusedProp or alternating), in plain PyTorch.

Layout: the weights are held as the port names and lays them out (conv
and transposed-conv weights HWIO, unflipped; Dense ``(din, dout)``; the
head's output and the tail's input flattened channels-last), so that the
benchmark can hand one set of tensors to both sides; the forward passes
here compute in NCHW.  Against pytorch/examples the architecture departs
where the repo does: G's first layer is a Dense to a 4x4 map (the same
function as a ConvTranspose from 1x1), D's last a Dense over the 4x4 map
(a 4x4 valid conv), D's first conv and G's last ConvT carry a bias, and
D returns the logit (the loss is BCE with logits).

``precision`` selects the control of the comparison (``portbench/check.py``):
"fp32" is the reference (TF32 off); "tf32" the same with TF32 on, and
"fp8" rounded to float8 where the program at bf16 rounds to bf16: every
conv's and matmul's operands and every layer's output (e4m3, a per-tensor
scale), and the gradient arriving at each of those points (e5m2).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
INIT_STD = 0.02
F8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _channels(model: dict):
    """(G's channels coarsest -> finest, D's channels finest -> coarsest)
    of the 32, 64 and 128 px DCGANs (s0 = 4)."""
    k = int(math.log2(model["image_size"] // 4))
    if model["image_size"] not in (32, 64, 128):
        raise ValueError(f"no reference for image_size {model['image_size']}")
    g = [model["ngf"] * 2 ** (k - 1 - i) for i in range(k)]
    d = [model["ndf"] * 2 ** i for i in range(k)]
    return g, d


def param_spec(model: dict) -> dict:
    """{"g": [(name, shape, init)], "d": [...]}: every parameter of G and D
    under the port's names, init "w" (N(0, 0.02)), "scale" (1 + N(0,
    0.02)) or "zero"."""
    if model["arch"] != "dcgan" or not (model["g_batchnorm"]
                                        and model["d_batchnorm"]):
        raise ValueError("the reference is the unconditional DCGAN with BN "
                         "in G and D")
    return stack_spec(model, model["nz"], model["channels"])


def stack_spec(model: dict, head_in: int, d_in: int) -> dict:
    """``param_spec`` of the G and D stacks with G's head taking
    ``head_in`` features and D's first conv ``d_in`` channels."""
    gc, dc = _channels(model)
    ch = model["channels"]

    def bn(prefix, c):
        return [(f"{prefix}.bn.scale", (c,), "scale"),
                (f"{prefix}.bn.bias", (c,), "zero")]

    g = [("head.dense.w", (head_in, 16 * gc[0]), "w"), *bn("head", gc[0])]
    for i, (cin, cout) in enumerate(zip(gc[:-1], gc[1:])):
        g += [(f"block{i}.conv.w", (4, 4, cin, cout), "w"),
              *bn(f"block{i}", cout)]
    g += [("final.conv.w", (4, 4, gc[-1], ch), "w"),
          ("final.conv.b", (ch,), "zero")]
    d = [("block0.conv.w", (4, 4, d_in, dc[0]), "w"),
         ("block0.conv.b", (dc[0],), "zero")]
    for i in range(1, len(dc)):
        d += [(f"block{i}.conv.w", (4, 4, dc[i - 1], dc[i]), "w"),
              *bn(f"block{i}", dc[i])]
    d += [("tail.dense.w", (16 * dc[-1], 1), "w"),
          ("tail.dense.b", (1,), "zero")]
    return {"g": g, "d": d}


def make_weights(model: dict, seed: int, device) -> dict:
    """The weights of G and D from ``seed``: one normal draw on ``device``
    (a ``torch.Generator`` there), sliced into the leaves in spec order."""
    return draw_weights(param_spec(model), seed, device)


def draw_weights(spec: dict, seed: int, device) -> dict:
    """``make_weights`` of any spec; an "embed" leaf is N(0, 1)."""
    leaves = [leaf for part in ("g", "d") for leaf in spec[part]]
    sizes = [math.prod(shape) for _, shape, init in leaves if init != "zero"]
    gen = torch.Generator(device=device).manual_seed(2 * int(seed) % 2 ** 63)
    r = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {"g": {}, "d": {}}, 0
    for part in ("g", "d"):
        for name, shape, init in spec[part]:
            if init == "zero":
                out[part][name] = torch.zeros(shape, device=device)
                continue
            n = math.prod(shape)
            std = 1.0 if init == "embed" else INIT_STD
            t = r[at:at + n].reshape(shape) * std
            at += n
            out[part][name] = t + 1.0 if init == "scale" else t
    return out


class _Round8(torch.autograd.Function):
    """Operands to float8 e4m3 (per-tensor scale) in the forward; the
    incoming gradient to e5m2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x, dtype):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / F8_MAX[dtype], torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype)) * scale


def operand(precision: str):
    if precision == "fp8":
        return _Round8.apply
    return lambda t: t


@contextlib.contextmanager
def numerics(precision: str):
    """TF32 on for "tf32", off otherwise, for the block's convs and
    matmuls; the previous flags after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _bn(x, scale, bias):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + BN_EPS) * scale[:, None, None]
            + bias[:, None, None])


def generator(p: dict, z, model: dict, precision: str = "fp32"):
    """G's train-mode forward: z (N, nz) -> images NCHW in [-1, 1]."""
    q = operand(precision)
    gc, _ = _channels(model)
    x = q(q(z) @ q(p["head.dense.w"]))
    x = x.reshape(z.shape[0], 4, 4, gc[0]).permute(0, 3, 1, 2)
    x = q(torch.relu(_bn(x, p["head.bn.scale"], p["head.bn.bias"])))
    for i in range(len(gc) - 1):
        w = p[f"block{i}.conv.w"].permute(2, 3, 0, 1)
        x = q(F.conv_transpose2d(x, q(w), stride=2, padding=1))
        x = q(torch.relu(_bn(x, p[f"block{i}.bn.scale"],
                             p[f"block{i}.bn.bias"])))
    w = p["final.conv.w"].permute(2, 3, 0, 1)
    x = q(F.conv_transpose2d(x, q(w), p["final.conv.b"], stride=2,
                             padding=1))
    return q(torch.tanh(x))


def discriminator(p: dict, x, model: dict, precision: str = "fp32"):
    """D's train-mode forward: images NCHW -> one logit an image."""
    q = operand(precision)
    _, dc = _channels(model)
    leak = model["leak"]
    w = p["block0.conv.w"].permute(3, 2, 0, 1)
    x = q(F.conv2d(q(x), q(w), p["block0.conv.b"], stride=2, padding=1))
    x = q(F.leaky_relu(x, leak))
    for i in range(1, len(dc)):
        w = p[f"block{i}.conv.w"].permute(3, 2, 0, 1)
        x = q(F.conv2d(x, q(w), stride=2, padding=1))
        x = q(F.leaky_relu(_bn(x, p[f"block{i}.bn.scale"],
                               p[f"block{i}.bn.bias"]), leak))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return q(x @ q(p["tail.dense.w"]) + p["tail.dense.b"])[:, 0]


def bce_losses(real_logits, fake_logits, fake_logits_g):
    """(D's loss, G's non-saturating loss) from raw logits."""
    loss_d = (F.softplus(-real_logits).mean()
              + F.softplus(fake_logits).mean())
    return loss_d, F.softplus(-fake_logits_g).mean()


class Adam:
    """Adam as Kingma and Ba write it, in fp32 on the tensors it holds."""

    def __init__(self, params: dict, lr, beta1, beta2, eps):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + self.eps))
