"""tpugan_torch — the PyTorch/CUDA port of ``tpugan``.

The JAX package ``tpugan`` stays the reference; this package mirrors its
module layout in PyTorch idiom (``nn.Module``s, plain tensor functions, an
explicit ``device=`` and explicit ``torch.Generator``s) and replaces each
Pallas TPU kernel with a CUDA kernel written by hand for Hopper (``sm_90a``,
sources in ``tpugan_torch/csrc``).  It imports nothing from ``tpugan`` and
never imports ``jax``.

Ported so far: the eval-mode generator serving path (configs, ops, nn,
generator models, sampler, images, HTTP server, JAX-weight import).
"""

__version__ = "0.1.0"

from tpugan_torch.configs import Config, get_preset, list_presets  # noqa: F401
