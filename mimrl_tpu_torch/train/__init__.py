"""Training: task losses, optimizers, the two-stage steps and the Solver."""
