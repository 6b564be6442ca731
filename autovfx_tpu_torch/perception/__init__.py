"""Perception: precomputed instance masks, object extraction, LaMa
inpainting and the GPT-4V estimates."""
