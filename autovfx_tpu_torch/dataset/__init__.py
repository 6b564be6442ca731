"""Dataset ingestion and preparation: COLMAP models, the capture
readers, gravity alignment, re-triangulation under known poses,
monocular normals, the scene's metric scale and custom trajectories."""
