"""The attention kernels' share of their roofline: the sum of each
``flash_fwd`` / ``flash_bwd`` launch's least time (``counts.py``) over the
sum of their device times in the traced window, in %."""

from benchmark import readers


def read(ctx, out):
    return readers.attention_roofline(ctx, out)
