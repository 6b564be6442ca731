"""Gaussians, cameras, SH, quaternions and PLY IO on tensors."""
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.core.cameras import Camera

__all__ = ["Gaussians", "Camera"]
