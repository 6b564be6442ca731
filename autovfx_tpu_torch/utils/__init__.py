"""Seeded synthetic scenes."""
