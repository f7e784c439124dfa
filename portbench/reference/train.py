"""The reference's first steps of a cell: the step's draws worked out
again from the seed (``threefry.py``, and the host pipeline's epoch
order), then G and D trained by the reference of the configuration's
``model.arch`` (``<arch>.py`` beside this file, found by that name:
``dcgan.py``, ``cdcgan.py``), with what the comparison reads: each step's
losses, each leaf's first gradient and each leaf's change over the
steps."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference import dcgan, threefry

# the step's split of its key: (next, z_d, z_g, gp, y_d, y_g, flip, data)
Y_KEYS = (4, 5)


def of(model: dict):
    """The reference module of ``model["arch"]``: ``<arch>.py`` here."""
    return importlib.import_module(f"portbench.reference.{model['arch']}")


def run_key(seed: int) -> np.ndarray:
    """The run's key: the third of split(PRNGKey(seed), 3)."""
    return threefry.split(threefry.prng_key(seed), 3)[2]


def pipeline_rows(seed: int, step: int, bsz: int, n: int) -> np.ndarray:
    """Rows of batch ``step`` of the host pipeline: epoch e is the
    permutation of default_rng(SeedSequence([seed, e])), the last partial
    batch dropped."""
    per_epoch = n // bsz
    epoch, s = divmod(step, per_epoch)
    order = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)
    return order[s * bsz:(s + 1) * bsz]


def draws(seed: int, steps: int, bsz: int, nz: int, n: int, feed: str,
          n_classes: int = 0, y_keys=Y_KEYS):
    """Per step: (rows of the dataset, hflip mask, z for D's update, z for
    G's update, fake labels for D's update, fake labels for G's update;
    the labels None without classes).  The step splits its key in 8:
    (next, z_d, z_g, gp, y_d, y_g, flip, data); resident data draws its
    rows with replacement from the data key, the host pipeline in its
    epoch order.  ``y_keys`` other than the step's is a planted fault."""
    key = run_key(seed)
    out = []
    for step in range(steps):
        keys = threefry.split(key, 8)
        key = keys[0]
        if feed == "resident":
            rows = threefry.randint(keys[7], 0, n, (bsz,)).astype(np.int64)
        else:
            rows = pipeline_rows(seed, step, bsz, n)
        flip = threefry.uniform(keys[6], (bsz,)) < 0.5
        y_d, y_g = ((threefry.randint(keys[i], 0, n_classes, (bsz,))
                     for i in y_keys) if n_classes else (None, None))
        out.append((rows, flip, threefry.normal(keys[1], (bsz, nz)),
                    threefry.normal(keys[2], (bsz, nz)), y_d, y_g))
    return out


def real_batch(images: np.ndarray, rows, flip, device, hflip: bool):
    """The batch's images, NCHW fp32 in [-1, 1], flipped where drawn."""
    x = torch.from_numpy(images[rows]).to(device).float() / 127.5 - 1.0
    if hflip:
        f = torch.from_numpy(flip).to(device)[:, None, None, None]
        x = torch.where(f, x.flip(2), x)
    return x.permute(0, 3, 1, 2)


def _long(y, device, keep: int):
    """The first ``keep`` labels on ``device``, or None without labels."""
    return None if y is None else torch.from_numpy(y[:keep]).to(device).long()


def _inputs(t, y) -> tuple:
    """A net's inputs: the tensor, and the labels where it takes them."""
    return (t,) if y is None else (t, y)


def follow(cfg: dict, weights: dict, images: np.ndarray, seed: int, *,
           feed: str, labels=None, steps: int = 3, precision: str = "fp32",
           rows_kept: float = 1.0, label_fault: str = "",
           device="cuda") -> dict:
    """Train ``steps`` steps from ``weights`` as the configuration states
    them; returns {"loss": [[loss_d, loss_g] a step], "grad1": {leaf: norm
    of its first gradient}, "delta": {leaf: norm of its change after the
    steps}}, leaves named "g.<name>" / "d.<name>".  ``labels`` are the
    dataset's, where the model takes them.

    ``precision`` other than "fp32" is the control; ``rows_kept`` < 1 keeps
    that share of every batch (a planted fault: the mean over the rest);
    ``label_fault`` "flip" moves each real label to the next class (1 - y
    of two), "wrong_key" draws the fake labels from each other's keys."""
    model, o = cfg["model"], cfg["optim"]
    ref = of(model)
    fused = cfg["train"]["fused_prop"]
    bsz = cfg["data"]["batch_size"]
    keep = int(bsz * rows_kept)
    n_classes = model["n_classes"] if labels is not None else 0
    params = {part: {k: v.detach().clone().to(device).requires_grad_()
                     for k, v in weights[part].items()}
              for part in ("g", "d")}
    start = {part: {k: v.detach().clone() for k, v in ps.items()}
             for part, ps in params.items()}
    opt = {part: dcgan.Adam(params[part], o[f"lr_{part}"], o["beta1"],
                            o["beta2"], o["eps"]) for part in ("g", "d")}
    out = {"loss": [], "grad1": {}, "delta": {}}

    def G(z, y):
        return ref.generator(params["g"], *_inputs(z, y), model, precision)

    def D(x, y):
        return ref.discriminator(params["d"], *_inputs(x, y), model,
                                 precision)

    y_keys = Y_KEYS[::-1] if label_fault == "wrong_key" else Y_KEYS
    with dcgan.numerics(precision):
        for i, (rows, flip, z_d, z_g, y_d, y_g) in enumerate(draws(
                seed, steps, bsz, model["nz"], len(images), feed, n_classes,
                y_keys)):
            x = real_batch(images, rows, flip, device,
                           cfg["data"]["hflip"])[:keep]
            y = None if labels is None else labels[rows]
            if label_fault == "flip":
                y = (y + 1) % n_classes
            y, y_d, y_g = (_long(v, device, keep) for v in (y, y_d, y_g))
            z_d = torch.from_numpy(z_d[:keep]).to(device)
            z_g = torch.from_numpy(z_g[:keep]).to(device)
            pd, pg = list(params["d"].values()), list(params["g"].values())
            if fused:
                # one G forward; both updates from the pre-update D
                fake = G(z_d, y_d)
                lf = D(fake, y_d)
                loss_d, loss_g = dcgan.bce_losses(D(x, y), lf, lf)
                gd = torch.autograd.grad(loss_d, pd, retain_graph=True)
                gg = torch.autograd.grad(loss_g, pg)
                opt["d"].step(dict(zip(params["d"], gd)))
                opt["g"].step(dict(zip(params["g"], gg)))
            else:
                with torch.no_grad():
                    fake = G(z_d, y_d)
                lr, lf = D(x, y), D(fake, y_d)
                loss_d = dcgan.bce_losses(lr, lf, lf)[0]
                gd = torch.autograd.grad(loss_d, pd)
                opt["d"].step(dict(zip(params["d"], gd)))
                loss_g = dcgan.bce_losses(lr, lf, D(G(z_g, y_g), y_g))[1]
                gg = torch.autograd.grad(loss_g, pg)
                opt["g"].step(dict(zip(params["g"], gg)))
            out["loss"].append([loss_d.item(), loss_g.item()])
            if i == 0:
                for part, grads in (("d", gd), ("g", gg)):
                    for k, g in zip(params[part], grads):
                        out["grad1"][f"{part}.{k}"] = float(g.norm())
    for part in ("g", "d"):
        for k, v in params[part].items():
            out["delta"][f"{part}.{k}"] = float((v.detach()
                                                 - start[part][k]).norm())
    return out
