"""Device kernel records in the traced window per real train sample of
its epochs."""

from benchmark import readers


def read(ctx, out):
    n = out["counts"]["train_samples"]
    return readers.kernel_records(out) / n if n else None
