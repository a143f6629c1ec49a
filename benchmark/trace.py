"""One profiler session over a measured window, reduced to what the
per-layer readers take: the device's records, the benchmark's own host
spans, the busy time (the union of the device records, so work on
concurrent streams counts once), the longest device operations and the
longest idle gaps, each named by the host span it fell in."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench/"


def span(name: str):
    """A host span of the benchmark's own, recorded when a profiler runs."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Session:
    """``start()`` at the window's start, ``stop()`` at its end (after the
    device is synchronised); then ``reduce()``."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.device = device

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def reduce(self) -> Dict:
        """{kernels: [(name, start_us, end_us)], spans: [(name, start_us,
        end_us)], busy_s, window_s, device_ops, idle_gaps}; raises when
        the session holds no device record on the card."""
        kernels: List[Tuple[str, float, float]] = []
        spans: List[Tuple[str, float, float]] = []
        t_lo, t_hi = None, None
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)
        for e in events:  # us from the session's first event
            s = (e.start_ns() - base) * 1e-3
            t = s + e.duration_ns() * 1e-3
            name = e.name()
            if e.device_type() == cuda:
                # the device timeline mirrors each host span: not an operation
                if t > s and not name.startswith(SPAN_PREFIX):
                    kernels.append((name, s, t))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], s, t))
                if name == SPAN_PREFIX + "window":
                    t_lo, t_hi = s, t
        if self.device.type == "cuda" and not kernels:
            raise RuntimeError("the profiler session holds no device record")
        if t_lo is None:
            raise RuntimeError("the profiler session holds no window span")
        kernels = [k for k in kernels if k[2] > t_lo and k[1] < t_hi]
        kernels.sort(key=lambda k: k[1])
        busy, gaps = union(kernels, t_lo, t_hi)
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, t in kernels:
            by_op[name] += (t - s) * 1e-6
        inner = [x for x in spans if x[0] != "window"]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"kernels": kernels, "spans": spans, "busy_s": busy * 1e-6,
                "window_s": (t_hi - t_lo) * 1e-6,
                "device_ops": sorted(by_op.items(), key=lambda x: -x[1])[:10],
                "idle_gaps": [(span_at(inner, g0), (g1 - g0) * 1e-6)
                              for g0, g1 in longest]}


def union(kernels: List[Tuple[str, float, float]], lo: float, hi: float):
    """(busy us of the records' union inside [lo, hi], the idle gaps
    [(start, end)] between lo and hi)."""
    busy, gaps, cursor = 0.0, [], lo
    for _, s, t in kernels:
        s, t = max(s, lo), min(t, hi)
        if t <= s or t <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            busy += t - s
        else:
            busy += t - cursor
        cursor = t
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def span_at(spans: List[Tuple[str, float, float]], at: float) -> str:
    """The innermost (latest-starting) host span holding ``at``."""
    best: Optional[Tuple[str, float, float]] = None
    for x in spans:
        if x[1] <= at < x[2] and (best is None or x[1] > best[1]):
            best = x
    return "other" if best is None else best[0]
