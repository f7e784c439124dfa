"""Operations and bytes from shapes, and the card's peaks: the arithmetic
behind ``k5_roofline`` and ``step_mfu_pct``.

The work is counted once, whatever route computes it: a conv's or a
matmul's multiply-adds (2 operations each), each input byte read once and
each output byte written once.  Operands in bf16 are bound at the bf16
tensor-core peak, fp32 operands at the TF32 peak, whether the program
takes one TF32 pass, three, or the FFMA units: the bound is the work's,
not the route's.  Elementwise work (BatchNorm, activations, the optimizer,
a label's embedding lookup) is not counted.  A layer's input gradient is
counted whole where any part of its input needs one: a conditional D's
first conv takes [image, label plane] as one input.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 495e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "fp32": 4}


def embed_dim(model: dict) -> int:
    """The label embedding's width of a conditional DCGAN, else 0."""
    return model["embed_dim"] if model.get("arch") == "cdcgan" else 0


def g_layers(model: dict) -> list[tuple[str, int, int, int]]:
    """G's layers as (kind, input side, cin, cout): the Dense head to a
    4x4 map (from z, and the label's embedding where G is conditional),
    then ConvT(4, 2, 1) doubling the side (32, 64, 128 px)."""
    k = int(math.log2(model["image_size"] // 4))
    ch = [model["ngf"] * 2 ** (k - 1 - i) for i in range(k)]
    out = [("dense", 1, model["nz"] + embed_dim(model), 16 * ch[0])]
    side = 4
    for cin, cout in zip(ch, ch[1:] + [model["channels"]]):
        out.append(("convt", side, cin, cout))
        side *= 2
    return out


def d_layers(model: dict) -> list[tuple[str, int, int, int]]:
    """D's layers as (kind, input side, cin, cout): where D is conditional
    first ``proj``, the Dense from the label's embedding to the S x S
    plane that joins the image as one more channel; then Conv(4, 2, 1)
    halving the side, then the Dense tail over the 4x4 map."""
    k = int(math.log2(model["image_size"] // 4))
    ch = [model["ndf"] * 2 ** i for i in range(k)]
    side, e = model["image_size"], embed_dim(model)
    out = [("dense", 1, e, side * side)] if e else []
    for cin, cout in zip([model["channels"] + bool(e)] + ch[:-1], ch):
        out.append(("conv", side, cin, cout))
        side //= 2
    out.append(("dense", 1, 16 * ch[-1], 1))
    return out


def layer_flops(layer, n: int) -> int:
    """A layer's forward operations for a batch of n."""
    kind, side, cin, cout = layer
    if kind == "dense":
        return 2 * n * cin * cout
    if kind == "conv":
        return 2 * n * (side // 2) ** 2 * 16 * cin * cout
    if kind == "convt":
        return 2 * n * side ** 2 * 16 * cin * cout
    raise ValueError(kind)


def forward_flops(layers, n: int) -> int:
    return sum(layer_flops(layer, n) for layer in layers)


def pass_flops(layers, n: int, weights: bool, first_input: bool) -> int:
    """A forward and its backward: each layer's forward count again for
    its weight gradient where the weights train, and again for its input
    gradient, the first layer's only where its input needs one."""
    f = forward_flops(layers, n)
    return 3 * f - (0 if weights else f) - (
        0 if first_input else layer_flops(layers[0], n))


def step_flops(model: dict, n: int, fused: bool) -> int:
    """The operations one train step needs at batch n.

    FusedProp: G forward and backward; D on the reals (weights), D on the
    fakes (weights and input).  Alternating: G forward without a graph; D
    on the reals and on the fakes (weights); G forward and backward, D
    with its weights frozen (input gradient).  The first layer's input
    needs a gradient where it trains something: G's head not for z, but
    for a conditional G's embedding; D's first layer on a fake G trains
    through, and a conditional D's ``proj`` for D's embedding while D
    trains (and the image's conv then for the plane)."""
    gl, dl = g_layers(model), d_layers(model)
    cond = bool(embed_dim(model))
    if fused:
        return (pass_flops(gl, n, True, cond) + pass_flops(dl, n, True, cond)
                + pass_flops(dl, n, True, True))
    return (forward_flops(gl, n) + 2 * pass_flops(dl, n, True, cond)
            + pass_flops(gl, n, True, cond) + pass_flops(dl, n, False,
                                                        not cond))


def conv_stats_work(n: int, side: int, cin: int, cout: int,
                    precision: str) -> tuple[int, int]:
    """(operations, bytes) of one conv + BatchNorm-statistics launch
    (kernel 5): the conv's multiply-adds; x and w read once, y and the
    per-channel (mean, var) in fp32 written once."""
    e = ELEMENT_BYTES[precision]
    flops = layer_flops(("conv", side, cin, cout), n)
    nbytes = e * (n * side * side * cin + 16 * cin * cout
                  + n * (side // 2) ** 2 * cout) + 2 * 4 * cout
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: operations at the precision's
    peak or bytes at the memory's, whichever is longer."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def conv_stats_layers(model: dict) -> list[tuple[str, int, int, int]]:
    """D's conv layers that run kernel 5 in a train step: those with
    BatchNorm (every one but the first)."""
    return [layer for layer in d_layers(model) if layer[0] == "conv"][1:]
