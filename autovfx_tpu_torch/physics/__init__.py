"""Rigid-body physics: convex hulls, a scene-mesh grid, the impulse solver."""
from autovfx_tpu_torch.physics.world import (
    RigidWorld, simulate, rb_transform_schema,
)

__all__ = ["RigidWorld", "simulate", "rb_transform_schema"]
