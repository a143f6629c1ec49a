"""What several per-layer readers share: the device's idle share, the
attention kernels' roofline share, and MFU from a FLOP count, over the
traced window."""

from __future__ import annotations

from typing import Dict, Optional

from benchmark import counts


def idle_share(out: Dict) -> Optional[float]:
    tr = out["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def attention_roofline(ctx, out: Dict) -> Optional[float]:
    """Sum of each flash launch's bound over the sum of their device times,
    in %; None where the window ran none."""
    flags = out["flags"]
    H, nh = int(flags["--bert_hidden"]), int(flags["--bert_heads"])
    shape = (int(flags["--batch_size"]), nh, int(flags["--time_len"]), H // nh)
    dtype = ctx.config["attention_dtype"]
    bound = {kind: counts.attention_bound_s(shape, dtype, kind == "flash_bwd")
             for kind in ("flash_fwd", "flash_bwd")}
    need = took = 0.0
    for name, s, t in out["trace"]["kernels"]:
        for kind, b in bound.items():
            if kind in name:
                need += b
                took += (t - s) * 1e-6
    return 100.0 * need / took if took > 0 else None


def mfu(ctx, out: Dict, flops: float) -> Optional[float]:
    tr = out["trace"]
    if not tr or flops <= 0:
        return None
    return 100.0 * flops / tr["window_s"] / float(ctx.config["peak_flops_per_s"])


def kernel_records(out: Dict) -> int:
    return sum(1 for name, _, _ in out["trace"]["kernels"]
               if not name.startswith(("Memcpy", "Memset")))
