"""Rasterizer stages, their CUDA kernel wrappers and plain versions."""
