"""Training: losses and optimizer loop, checkpoints, monitors, predict."""
