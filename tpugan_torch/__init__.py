"""tpugan_torch — the PyTorch/CUDA port of ``tpugan``.

The JAX package ``tpugan`` stays the reference; this package mirrors its
module layout in PyTorch idiom (``nn.Module``s, plain tensor functions, an
explicit ``device=`` and explicit ``torch.Generator``s) and replaces each
Pallas TPU kernel with a CUDA kernel written by hand for Hopper (``sm_90a``,
sources in ``tpugan_torch/csrc``).  It imports nothing from ``tpugan`` and
never imports ``jax``.

Ported so far: the eval-mode generator serving path (configs, ops, nn,
generator models, sampler, images, HTTP server, JAX-weight import) and
single-device training of every preset from the dataset files (MNIST,
CIFAR-10, CelebA in RAM or streaming) or the synthetic set, with the whole
training state (EMA, LR schedule, checkpoints and exact resume), the step
options (FusedProp, grad_accum, steps_per_call, remat, a device-resident
dataset), DiffAugment and ADA, in-training FID / KID / IS with
``keep_best`` (``eval/``), the command line, the exported generator, and
meshes of ranks over ``torch.distributed`` (``parallel/``: data parallel
with global-batch BatchNorm, FSDP, spatial halo convs, the multi-process
bootstrap and sharded serving).
"""

__version__ = "0.1.0"

from tpugan_torch.configs import Config, get_preset, list_presets  # noqa: F401
