"""The plain reference of the conditional DCGAN (``model.arch ==
"cdcgan"``): ``dcgan.py``'s G and D stacks, conditioned on a label as the
repo's conditional DCGAN does it, in plain PyTorch.

G embeds the label (a table of ``n_classes`` x ``embed_dim``) and feeds
[z, embedding] to the Dense head.  D embeds the label with a table of its
own, projects the embedding by a Dense (``proj``, with a bias) to one
S x S plane, laid out channels-last as the port lays it out (element
h * S + w is pixel (h, w)), and takes [image, plane] as C + 1 input
channels.  Everything after those inputs is ``dcgan.generator`` and
``dcgan.discriminator``, with their layout, their controls and their
departures from the published DCGAN.

Against the published conditional GAN (arXiv:1411.1784: the label one-hot,
joined to G's noise and to D's input), the repo departs: the label is a
learned embedding (N(0, 1) at init, as the port's ``Embedding`` draws
it), G and D each have their own table, and D sees the label as one
learned plane beside the image's channels, not as one-hot maps.  The
real labels come with the dataset; the fake labels are drawn by the step
(``train.draws``).
"""

from __future__ import annotations

import torch

from portbench.reference import dcgan


def param_spec(model: dict) -> dict:
    """``dcgan.param_spec``'s form under the port's names of
    ``CondGenerator`` (``embed.table``, ``g.*``) and ``CondDiscriminator``
    (``embed.table``, ``proj.w``, ``proj.b``, ``d.*``); init "embed" is
    N(0, 1)."""
    if model["arch"] != "cdcgan" or model["n_classes"] < 1 or not (
            model["g_batchnorm"] and model["d_batchnorm"]):
        raise ValueError("the reference is the conditional DCGAN with BN in "
                         "G and D and at least one class")
    n, e, s = model["n_classes"], model["embed_dim"], model["image_size"]
    stack = dcgan.stack_spec(model, model["nz"] + e, model["channels"] + 1)
    table = ("embed.table", (n, e), "embed")
    return {"g": [table] + [(f"g.{k}", shape, init)
                            for k, shape, init in stack["g"]],
            "d": [table, ("proj.w", (e, s * s), "w"),
                  ("proj.b", (s * s,), "zero")]
            + [(f"d.{k}", shape, init) for k, shape, init in stack["d"]]}


def make_weights(model: dict, seed: int, device) -> dict:
    """The weights of G and D from ``seed``, as ``dcgan.make_weights``."""
    return dcgan.draw_weights(param_spec(model), seed, device)


def _inner(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def generator(p: dict, z, y, model: dict, precision: str = "fp32"):
    """G's train-mode forward: z (N, nz), labels y (N,) -> images NCHW."""
    h = torch.cat([z, p["embed.table"][y]], dim=-1)
    return dcgan.generator(_inner(p, "g."), h, model, precision)


def discriminator(p: dict, x, y, model: dict, precision: str = "fp32"):
    """D's train-mode forward: images NCHW, labels y (N,) -> one logit an
    image."""
    q = dcgan.operand(precision)
    s = model["image_size"]
    plane = q(q(p["embed.table"][y]) @ q(p["proj.w"]) + p["proj.b"])
    x = torch.cat([x, plane.reshape(-1, 1, s, s)], dim=1)
    return dcgan.discriminator(_inner(p, "d."), x, model, precision)
