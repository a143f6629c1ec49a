"""PyTorch modules of the MIMRL model and the weight converter from ``mimrl_tpu``."""
