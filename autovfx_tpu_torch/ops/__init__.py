"""Rasterizer stages, their CUDA kernel wrappers and plain versions."""
from autovfx_tpu_torch.ops.rasterize import rasterize, RasterConfig, RenderOutput

__all__ = ["rasterize", "RasterConfig", "RenderOutput"]
