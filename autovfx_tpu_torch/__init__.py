"""autovfx_tpu_torch — the PyTorch + CUDA port of ``autovfx_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
names (``core/``, ``ops/``, ``utils/``) and imports neither JAX nor
``autovfx_tpu``.  Tensors on a CUDA device go through the hand-written
kernels in ``csrc/`` (built with ``nvcc`` at first use, see
``ops/_build.py``); tensors on the CPU go through their plain PyTorch
versions.

- ``autovfx_tpu_torch.core``   Gaussians, cameras, SH, quaternions, PLY IO.
- ``autovfx_tpu_torch.ops``    preprocess, binning and blend, their kernel
  wrappers and backwards; ``rasterize`` / ``render``; kNN.
- ``autovfx_tpu_torch.train``  losses, densification, the trainer
  (``train_step``, ``densify_step``, ``reset_opacity_step``, ``train``)
  and ``.npz`` checkpoints.
- ``autovfx_tpu_torch.utils``  seeded synthetic scenes.
- ``autovfx_tpu_torch.convert`` carries arrays of the JAX package's
  parameters and training state into this package's tensors.
"""

__version__ = "0.1.0"

from autovfx_tpu_torch.core.cameras import Camera  # noqa: F401
from autovfx_tpu_torch.core.gaussians import Gaussians  # noqa: F401
from autovfx_tpu_torch.ops.rasterize import (  # noqa: F401
    RasterConfig,
    RenderOutput,
    rasterize,
    render,
)

__all__ = ["Camera", "Gaussians", "RasterConfig", "RenderOutput",
           "rasterize", "render"]
