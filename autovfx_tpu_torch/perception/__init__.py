"""Perception: precomputed instance masks and object extraction."""
