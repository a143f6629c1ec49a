"""Model FLOPs of the traced window's forwards over its time, over the
configuration's peak, in %."""

from benchmark import counts, readers


def read(ctx, out):
    ds = ctx.config["dataset"]
    flops = out["counts"]["batches"] * counts.serve_batch_flops(
        out["flags"], ds["d_audio"], ds["d_video"])
    return readers.mfu(ctx, out, flops)
