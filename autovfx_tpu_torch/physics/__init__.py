"""Rigid-body physics: convex hulls, a scene-mesh grid, the impulse solver."""
