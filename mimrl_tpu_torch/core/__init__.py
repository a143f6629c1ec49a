"""Configuration and checkpoints."""
