"""autovfx_tpu_torch — the PyTorch + CUDA port of ``autovfx_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
names (``core/``, ``ops/``, ``render/``, ``physics/``, ``train/``,
``utils/``, ``edit/``, ``gpt/``, ``perception/``, ``sugar/``) and
imports neither JAX nor
``autovfx_tpu``.  Tensors on a CUDA device go through the hand-written
kernels in ``csrc/`` (built with ``nvcc`` at first use, see
``ops/_build.py``); tensors on the CPU go through their plain PyTorch
versions.

- ``autovfx_tpu_torch.core``   Gaussians, cameras, SH, quaternions, PLY IO.
- ``autovfx_tpu_torch.ops``    preprocess, binning and blend, their kernel
  wrappers and backwards; ``rasterize`` / ``render`` / the merged
  ``rasterize_multi``; kNN; ray-mesh casting.
- ``autovfx_tpu_torch.render`` the edited frame: envmap IBL, object
  surfels, hull shadows, the composite and the clip loop; the smoke and
  fire volume, the liquid melt and the other effects; DiffusionLight
  envmaps; panoramas.
- ``autovfx_tpu_torch.physics`` convex hulls, the scene-mesh grid and
  the rigid-body solver that drops objects into a scene.
- ``autovfx_tpu_torch.train``  losses, densification, the trainer
  (``train_step``, ``densify_step``, ``reset_opacity_step``, ``train``),
  ``.npz`` checkpoints and init points cast onto a scene mesh.
- ``autovfx_tpu_torch.utils``  seeded synthetic scenes, LPIPS, the
  evaluation metrics, float32 convolutions.
- ``autovfx_tpu_torch.edit``   the edit layer: the edit IR and events,
  mesh IO, the DSL and ``SceneRepresentation`` (physics, passes and
  composite of an edit); ``edit_scene`` is its CLI.
- ``autovfx_tpu_torch.gpt``    the program runner (``setup_LMP``) and the
  planner prompts.
- ``autovfx_tpu_torch.perception`` precomputed instance masks and object
  extraction; ``autovfx_tpu_torch.sugar`` mesh decimation.
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
    rasterize_multi,
    render,
)

__all__ = ["Camera", "Gaussians", "RasterConfig", "RenderOutput",
           "rasterize", "rasterize_multi", "render"]
