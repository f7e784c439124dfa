"""Config tree for tpugan_torch.

A copy of ``tpugan/configs/config.py`` (the port imports nothing from the
JAX package): the same dataclasses, presets, ``override`` and ``from_dict``,
so a config JSON written by either package loads in the other.  Fields that
only the JAX trainer reads are kept so the two trees stay one schema.

The reference (a PyTorch GAN playground) configures each run through per-script
argparse flags (dataset, batch size, lr, beta1, nz/ngf/ndf, epochs, n_critic,
lambda_gp, image size, output dir, resume, seed).  Here the same surface is a
single typed config tree with named presets covering exactly the reference
configs (BASELINE.json "configs"):

- ``dcgan_mnist``      DCGAN on MNIST 28x28 (tiny G/D)
- ``dcgan_cifar10``    DCGAN on CIFAR-10 32x32 (BatchNorm in G and D)
- ``lsgan_cifar10``    LSGAN (least-squares loss) on CIFAR-10 32x32
- ``wgan_gp_cifar10``  WGAN-GP on CIFAR-10 (gradient-penalty double backward)
- ``sngan_cifar10``    SNGAN on CIFAR-10 (spectral-norm power iteration)
- ``cdcgan_celeba64``  Conditional DCGAN on CelebA 64x64
- ``cdcgan_celeba128`` Conditional DCGAN on CelebA 128x128 (large convs, DP)

Configs are plain dataclasses so they serialize into checkpoints and are
hashable into jit static args where needed.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the G/D pair."""

    arch: str = "dcgan"  # dcgan | cdcgan
    image_size: int = 64
    channels: int = 3  # image channels (1 for MNIST)
    nz: int = 100  # latent dimension
    ngf: int = 64  # generator base width
    ndf: int = 64  # discriminator base width
    n_classes: int = 0  # >0 enables conditional embedding (cdcgan)
    embed_dim: int = 0  # label embedding dim (0 -> default 50)
    g_batchnorm: bool = True
    d_batchnorm: bool = True  # reference: BN in D for CIFAR configs
    d_spectral_norm: bool = False  # SNGAN: spectral norm on D weights
    leak: float = 0.2  # LeakyReLU slope in D


@dataclass(frozen=True)
class LossConfig:
    """Adversarial objective."""

    kind: str = "bce"  # bce (non-saturating) | lsgan | wgan | wgan_gp | hinge
    lambda_gp: float = 10.0  # WGAN-GP gradient penalty weight
    n_critic: int = 1  # D steps per G step (5 for WGAN-GP)
    clip_value: float = 0.01  # weight clipping for kind="wgan" (original WGAN)
    # Label smoothing / flipping hooks (off by default to match reference).
    real_label: float = 1.0
    fake_label: float = 0.0


@dataclass(frozen=True)
class OptimConfig:
    """Two independent optimizers, as in the reference's alternating loop."""

    optimizer: str = "adam"  # adam | rmsprop
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    eps: float = 1e-8
    # RMSprop squared-grad smoothing constant.  Default mirrors
    # torch.optim.RMSprop's alpha=0.99 (the reference runs torch defaults);
    # note optax.rmsprop's own default is 0.9, so this must stay explicit.
    rmsprop_decay: float = 0.99
    # LR schedule: "constant" (the reference) or "linear" (decay to zero
    # from decay_start_frac of total_steps — the pix2pix/CycleGAN recipe).
    schedule: str = "constant"
    decay_start_frac: float = 0.5


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # mnist | cifar10 | celeba | synthetic
    data_dir: str = "data"
    batch_size: int = 128
    num_workers: int = 2  # host prefetch threads
    hflip: bool = False  # random horizontal flip augment (CelebA)
    # Keep the whole (uint8) dataset resident in device HBM and gather
    # batches on-device inside the compiled step — removes the host->device
    # per-batch transfer entirely (MNIST/CIFAR ~50-150MB; CelebA-64 ~2.5GB).
    # Sampling is uniform-with-replacement rather than epoch permutations.
    device_resident: bool = False
    # Device-resident batch sampling: "replacement" (uniform, cheapest) or
    # "epoch" (a fresh on-device permutation per epoch — the reference
    # DataLoader's shuffle=True semantics, matching the host pipeline).
    sampling: str = "replacement"
    # Larger-than-RAM folder datasets: "auto" streams (per-batch threaded
    # decode, host memory bounded by prefetch×batch) when the decoded set
    # would exceed max_ram_mb; "on"/"off" force.  Streaming excludes
    # device_resident (the dataset can't live in HBM either).
    streaming: str = "auto"
    max_ram_mb: int = 4096
    # synthetic dataset controls (deterministic, for offline dev/test)
    synthetic_size: int = 10_000


@dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 10_000
    log_every: int = 50
    sample_every: int = 500
    ckpt_every: int = 1000
    eval_every: int = 0  # FID/IS-proxy eval cadence (0 = only on demand)
    # With eval_every: also keep the best-FID weights in ckpt_dir/best
    # (GAN quality oscillates; 'latest' is the resume point, 'best' the
    # deploy point).
    keep_best: bool = False
    ckpt_dir: str = "runs/ckpt"
    out_dir: str = "runs/out"
    seed: int = 0
    precision: str = "bf16"  # bf16 (params fp32, compute bf16) | fp32
    # EMA decay for generator weights (0 = off).  Eval/sampling use the EMA
    # weights when on.  Pick decay so the averaging window 1/(1-decay) is
    # <= ~1% of the training horizon.
    ema: float = 0.0
    profile_steps: int = 0  # capture an XLA profiler trace of steps 2..2+N
    remat: bool = False  # jax.checkpoint G/D forwards (trade FLOPs for HBM)
    # With device-resident data: run K training steps per dispatch via
    # lax.scan — the host only orchestrates every K steps (hides dispatch
    # latency entirely; metrics/log cadence rounds to K).
    steps_per_call: int = 1
    # xla | pallas — sampling-path kernel backend.  In this package "xla"
    # means PyTorch's own ops and "pallas" the hand-written CUDA kernels
    # (tpugan_torch/csrc): the Sampler runs the whole-generator kernel
    # (ops/cuda_gen2.py).  There is no fallback: an unsupported shape raises.
    kernels: str = "xla"
    # Train-path conv+BN-stats fusion: off | auto | on.  Read by the JAX
    # trainer only; the port's conv+stats kernel comes with the train slice.
    fuse_stats: str = "off"
    # FusedProp (arxiv 2004.03335): share ONE fake forward between the D
    # and G updates and pull both gradients from one linearization — saves
    # a G forward + a D forward per step (~15% of train FLOPs).  Opt-in:
    # it is simultaneous (G's gradient uses the PRE-update D) rather than
    # alternating, so per-step parity with the reference changes; requires
    # n_critic == 1 and no gradient penalty.
    fused_prop: bool = False
    donate: bool = True  # donate train-state buffers into the jitted step
    # GAN runs can diverge; with this on, a non-finite logged loss saves a
    # checkpoint and halts cleanly (NonFiniteLossError) instead of burning
    # chip-hours logging NaNs.  Checked at log_every cadence — free, the
    # host fetches those metrics anyway.
    halt_on_nonfinite: bool = False
    mesh_shape: Optional[int] = None  # data-parallel devices (None = all)
    # Spatial (H-axis) sharding over N devices for ≥256px feature maps
    # (halo-exchange convs; parallel/spatial.py).  0 = off.  Composes with
    # data parallelism: set mesh_shape too and the Trainer builds a 2-D
    # ('data', 'space') mesh (mesh_shape x spatial_shards devices); alone
    # it runs pure spatial over spatial_shards devices.
    spatial_shards: int = 0
    # FSDP/ZeRO-3-style parameter sharding: shard params + optimizer
    # moments over a second 'model' mesh axis (fsdp_shards devices); XLA
    # all-gathers weights on use and reduce-scatters gradients.  Combine
    # with mesh_shape for the 2-D (data, model) mesh; mutually exclusive
    # with spatial_shards (both claim the second axis).
    fsdp_shards: int = 0
    # Gradient accumulation: split each batch into this many microbatches
    # run sequentially (activation memory of one microbatch), average the
    # gradients, apply ONE optimizer update.  Exact full-batch gradients
    # except BatchNorm normalizes per microbatch.  batch_size must divide.
    grad_accum: int = 1
    # Differentiable augmentation of EVERY image D sees — real and fake, in
    # both the D and G updates, gradients flowing through to G (DiffAugment,
    # arXiv:2006.10738).  The standard anti-memorization lever for small
    # datasets, absent from the reference.  Comma-joined ops from
    # ops/augment.py: "color,translation,cutout".  "" = off.
    augment: str = ""
    # Nonzero enables ADA (arXiv:2006.06676): each augment op executes
    # per-sample with probability p, and p is adapted on-device to hold the
    # discriminator overfitting heuristic r_t = E[sign(D(real))] at this
    # target (the paper's default is 0.6; r_t ranges [-1,1], so a negative
    # target forces p to ramp to 1).  0 = fixed p=1 (plain DiffAugment).
    ada_target: float = 0.0
    # ADA adaptation speed: p can traverse [0,1] in ada_kimg thousand images.
    ada_kimg: float = 500.0
    resume: str = ""  # checkpoint path/dir to resume from


@dataclass(frozen=True)
class EvalConfig:
    fid_n: int = 10_000  # generated samples for FID
    fid_batch: int = 256
    metric: str = "proxy"  # proxy (local feature net) | inception (weights-gated)
    # Also report precision/recall/density/coverage (PRDC) — manifold
    # metrics separating fidelity from diversity, which FID conflates.
    prdc: bool = False
    inception_weights: str = ""  # path to Inception pickle, if available


@dataclass(frozen=True)
class Config:
    name: str = "dcgan_mnist"
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            name=d.get("name", "custom"),
            model=ModelConfig(**d.get("model", {})),
            loss=LossConfig(**d.get("loss", {})),
            optim=OptimConfig(**d.get("optim", {})),
            data=DataConfig(**d.get("data", {})),
            train=TrainConfig(**d.get("train", {})),
            eval=EvalConfig(**d.get("eval", {})),
        )

    def replace(self, **sections: Any) -> "Config":
        """Replace whole sections: cfg.replace(loss=new_loss)."""
        return dataclasses.replace(self, **sections)

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {'model.nz': 128, 'train.seed': 1}-style CLI overrides."""
        d = self.to_dict()
        for key, val in dotted.items():
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config field: {key}")
            node[parts[-1]] = _coerce(val, node[parts[-1]])
        return Config.from_dict(d)


def _coerce(val: Any, like: Any) -> Any:
    if not isinstance(val, str):
        return val
    if isinstance(like, str):
        return val
    if val.lower() in ("none", "null"):
        return None  # unset an Optional field (regardless of current value)
    if like is None:
        # Optional fields (e.g. train.mesh_shape): numeric strings are
        # inferred, anything else stays a string (paths).
        for t in (int, float):
            try:
                return t(val)
            except ValueError:
                continue
        return val
    t = type(like)
    if t is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return t(val)


# ---------------------------------------------------------------------------
# Presets — the reference configs.
# ---------------------------------------------------------------------------


def _mnist() -> Config:
    return Config(
        name="dcgan_mnist",
        model=ModelConfig(
            arch="dcgan", image_size=28, channels=1, nz=100, ngf=32, ndf=32,
            g_batchnorm=True, d_batchnorm=False,
        ),
        loss=LossConfig(kind="bce"),
        data=DataConfig(dataset="mnist", batch_size=128),
        train=TrainConfig(total_steps=5000),
    )


def _cifar(name: str, loss_kind: str, sn: bool = False) -> Config:
    n_critic = 5 if loss_kind in ("wgan", "wgan_gp") else 1
    optim = OptimConfig()
    if loss_kind == "wgan_gp":
        # Adam(1e-4, 0.5/0.9) is the canonical WGAN-GP setting.
        optim = OptimConfig(lr_g=1e-4, lr_d=1e-4, beta1=0.5, beta2=0.9)
    elif loss_kind == "wgan":
        # original WGAN: RMSprop(5e-5) + weight clipping
        optim = OptimConfig(optimizer="rmsprop", lr_g=5e-5, lr_d=5e-5)
    return Config(
        name=name,
        model=ModelConfig(
            arch="dcgan", image_size=32, channels=3, nz=100, ngf=64, ndf=64,
            g_batchnorm=True,
            # WGAN-GP's penalty is per-sample; BN in D breaks it. SNGAN uses
            # SN instead of BN in D. DCGAN/LSGAN and original (clipped) WGAN
            # keep BN in both G and D.
            d_batchnorm=(loss_kind in ("bce", "lsgan", "wgan")) and not sn,
            d_spectral_norm=sn,
        ),
        loss=LossConfig(kind=loss_kind, n_critic=n_critic),
        optim=optim,
        data=DataConfig(dataset="cifar10", batch_size=128),
        train=TrainConfig(total_steps=20_000),
    )


def _celeba(size: int) -> Config:
    return Config(
        name=f"cdcgan_celeba{size}",
        model=ModelConfig(
            arch="cdcgan", image_size=size, channels=3, nz=100,
            ngf=64, ndf=64, n_classes=2, embed_dim=50,
            g_batchnorm=True, d_batchnorm=True,
        ),
        loss=LossConfig(kind="bce"),
        data=DataConfig(dataset="celeba", batch_size=128, hflip=True),
        train=TrainConfig(total_steps=50_000),
    )


_PRESETS = {
    "dcgan_mnist": _mnist,
    "dcgan_cifar10": lambda: _cifar("dcgan_cifar10", "bce"),
    "lsgan_cifar10": lambda: _cifar("lsgan_cifar10", "lsgan"),
    "wgan_cifar10": lambda: _cifar("wgan_cifar10", "wgan"),
    "wgan_gp_cifar10": lambda: _cifar("wgan_gp_cifar10", "wgan_gp"),
    "sngan_cifar10": lambda: _cifar("sngan_cifar10", "hinge", sn=True),
    "dcgan_celeba64": lambda: dataclasses.replace(
        _celeba(64),
        name="dcgan_celeba64",
        model=ModelConfig(arch="dcgan", image_size=64, channels=3, nz=100,
                          ngf=64, ndf=64, g_batchnorm=True, d_batchnorm=True),
    ),
    # The flagship tuned for single-chip throughput: FusedProp (one shared
    # fake forward), dataset resident in device memory, scan-fused dispatch.
    "dcgan_celeba64_fast": lambda: dataclasses.replace(
        _PRESETS["dcgan_celeba64"](),
        name="dcgan_celeba64_fast",
        data=dataclasses.replace(_PRESETS["dcgan_celeba64"]().data,
                                 device_resident=True, batch_size=256),
        train=dataclasses.replace(_PRESETS["dcgan_celeba64"]().train,
                                  fused_prop=True, steps_per_call=50),
        loss=dataclasses.replace(_PRESETS["dcgan_celeba64"]().loss,
                                 n_critic=1),
    ),
    "cdcgan_celeba64": lambda: _celeba(64),
    "cdcgan_celeba128": lambda: _celeba(128),
    # Post-parity scaling config (SURVEY §2b SP analog): 256px DCGAN with
    # the feature maps spatially sharded over the mesh (halo-exchange convs,
    # parallel/spatial.py) — train.spatial_shards picks the mesh size.
    "dcgan_256_spatial": lambda: dataclasses.replace(
        _celeba(256),
        name="dcgan_256_spatial",
        model=ModelConfig(arch="dcgan", image_size=256, channels=3, nz=100,
                          ngf=32, ndf=32, g_batchnorm=True, d_batchnorm=True),
        train=TrainConfig(total_steps=50_000, spatial_shards=8),
    ),
}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {list_presets()}")
    return _PRESETS[name]()
