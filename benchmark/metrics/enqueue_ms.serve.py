"""Mean host ms from a batch's hand-over until ``Predictor.forward``
returns (the input copies and the forward's enqueue), in the traced
window."""


def read(ctx, out):
    return out["counts"]["enqueue_ms"]
