"""Gaussians, cameras, SH, quaternions and PLY IO on tensors."""
