"""The share of the traced window in which no device operation ran (one
minus the union of the profiler's device records over the window), in %."""

from benchmark import readers


def read(ctx, out):
    return readers.idle_share(out)
