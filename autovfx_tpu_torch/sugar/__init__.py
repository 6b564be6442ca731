"""Mesh decimation for the mirror-bounce scene mesh."""
