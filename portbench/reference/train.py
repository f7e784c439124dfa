"""The reference's first steps of a cell: the step's draws worked out
again from the seed (``threefry.py``, and the host pipeline's epoch
order), then G and D trained by ``dcgan.py``, with what the comparison
reads: each step's losses, each leaf's first gradient and each leaf's
change over the steps."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dcgan, threefry


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


def draws(seed: int, steps: int, bsz: int, nz: int, n: int, feed: str):
    """Per step: (rows of the dataset, hflip mask, z for D's update, z for
    G's update).  The step splits its key in 8: (next, z_d, z_g, gp, y_d,
    y_g, flip, data); resident data draws its rows with replacement from
    the data key, the host pipeline in its epoch order."""
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
        out.append((rows, flip, threefry.normal(keys[1], (bsz, nz)),
                    threefry.normal(keys[2], (bsz, nz))))
    return out


def real_batch(images: np.ndarray, rows, flip, device, hflip: bool):
    """The batch's images, NCHW fp32 in [-1, 1], flipped where drawn."""
    x = torch.from_numpy(images[rows]).to(device).float() / 127.5 - 1.0
    if hflip:
        f = torch.from_numpy(flip).to(device)[:, None, None, None]
        x = torch.where(f, x.flip(2), x)
    return x.permute(0, 3, 1, 2)


def follow(cfg: dict, weights: dict, images: np.ndarray, seed: int, *,
           feed: str, steps: int = 3, precision: str = "fp32",
           rows_kept: float = 1.0, device="cuda") -> dict:
    """Train ``steps`` steps from ``weights`` as the configuration states
    them; returns {"loss": [[loss_d, loss_g] a step], "grad1": {leaf: norm
    of its first gradient}, "delta": {leaf: norm of its change after the
    steps}}, leaves named "g.<name>" / "d.<name>".

    ``precision`` other than "fp32" is the control; ``rows_kept`` < 1 keeps
    that share of every batch (a planted fault: the mean over the rest)."""
    model, o = cfg["model"], cfg["optim"]
    fused = cfg["train"]["fused_prop"]
    bsz = cfg["data"]["batch_size"]
    keep = int(bsz * rows_kept)
    params = {part: {k: v.detach().clone().to(device).requires_grad_()
                     for k, v in weights[part].items()}
              for part in ("g", "d")}
    start = {part: {k: v.detach().clone() for k, v in ps.items()}
             for part, ps in params.items()}
    opt = {part: dcgan.Adam(params[part], o[f"lr_{part}"], o["beta1"],
                            o["beta2"], o["eps"]) for part in ("g", "d")}
    out = {"loss": [], "grad1": {}, "delta": {}}
    G = lambda z: dcgan.generator(params["g"], z, model, precision)  # noqa
    D = lambda x: dcgan.discriminator(params["d"], x, model,  # noqa: E731
                                      precision)
    with dcgan.numerics(precision):
        for i, (rows, flip, z_d, z_g) in enumerate(draws(
                seed, steps, bsz, model["nz"], len(images), feed)):
            x = real_batch(images, rows, flip, device,
                           cfg["data"]["hflip"])[:keep]
            z_d = torch.from_numpy(z_d[:keep]).to(device)
            z_g = torch.from_numpy(z_g[:keep]).to(device)
            pd, pg = list(params["d"].values()), list(params["g"].values())
            if fused:
                # one G forward; both updates from the pre-update D
                fake = G(z_d)
                lf = D(fake)
                loss_d, loss_g = dcgan.bce_losses(D(x), lf, lf)
                gd = torch.autograd.grad(loss_d, pd, retain_graph=True)
                gg = torch.autograd.grad(loss_g, pg)
                opt["d"].step(dict(zip(params["d"], gd)))
                opt["g"].step(dict(zip(params["g"], gg)))
            else:
                with torch.no_grad():
                    fake = G(z_d)
                lr, lf = D(x), D(fake)
                loss_d = dcgan.bce_losses(lr, lf, lf)[0]
                gd = torch.autograd.grad(loss_d, pd)
                opt["d"].step(dict(zip(params["d"], gd)))
                loss_g = dcgan.bce_losses(lr, lf, D(G(z_g)))[1]
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

