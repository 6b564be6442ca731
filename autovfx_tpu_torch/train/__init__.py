"""Training: losses, densification, the trainer and its checkpoints."""
