"""SuGaR: the density field and its regularization, coarse training, mesh
extraction, mesh-bound refinement and mesh decimation."""
