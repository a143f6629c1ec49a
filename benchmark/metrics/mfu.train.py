"""Model FLOPs of the traced window's whole epochs (``counts.py``: stage 1,
stage 2 and the eval batches) over the window's time, over the
configuration's peak, in %."""

from benchmark import counts, readers


def read(ctx, out):
    c, ds = out["counts"], ctx.config["dataset"]
    flops = c["epochs"] * counts.train_epoch_flops(
        out["flags"], ds["d_audio"], ds["d_video"], c["nb_train"], c["nb_eval"])
    return readers.mfu(ctx, out, flops)
