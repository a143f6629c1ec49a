"""What the program's own layer spans say about a traced window.

The port marks its layers with spans named ``mimrl/<layer>/...``
(``mimrl_tpu_torch/core/spans.py``): record functions of the profiler's
session, on the device records' clock. From one session this module
reads:

- the window's program spans, ``(name, start_us, end_us, thread)``;
- each device record's origin: the thread and instant of its launch (the
  thread of the operator that the profiler links the record to, the
  instant of the CUDA runtime call of the record's correlation id, which
  the profiler links to the same operator) and, for a record launched under
  an autograd backward node, the thread and start of the forward operator
  with the node's sequence number (the profiler's ``sequence_nr`` and
  ``fwd_thread_id``);
- the window's idle time split by what the host's main thread (the thread
  of ``bench/window``) was doing: each idle interval is cut at the
  boundaries of that thread's spans, and each piece goes to the innermost
  span that holds it, or to ``other`` where none does (benchmark code);
- each span's device time: a record's time goes to the innermost span
  that held its launch on the launching thread, a backward record's to
  the span that held its forward operator.

``CLASSES`` groups the spans: ``data`` (loaders, host-to-device copies,
the prefetch queue), ``dispatch`` (the steps, the model, the MI stack, the
optimizer) and ``solver`` (the Solver's stages, evaluation, finalisation
and the host's waits on the device, ``sync/*``).

``trace.py`` does not call this module. ``python benchmark/program_spans.py
--workload <cell> --seed <n> --seconds <s>`` runs a cell traced, with this
reduction beside the benchmark's own, and prints its readings as the last
line.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "mimrl/"
CLASSES = (("data", ("data/",)),
           ("dispatch", ("step/", "model/", "mi/", "optim/")),
           ("solver", ("solver/", "sync/")))
# host spans' copies on the device's timeline: not operations
MIRRORS = ("bench/", PREFIX)

Span = Tuple[str, float, float, int]
# (thread, us) of the launch, then of the forward operator (or None)
Origin = Tuple[int, float, Optional[int], Optional[float]]
Kernel = Tuple[str, float, float, Optional[Origin]]


def span_class(name: str) -> str:
    for cls, prefixes in CLASSES:
        if name.startswith(prefixes):
            return cls
    return "other"


class Innermost:
    """One thread's spans (which nest, as a thread's record functions
    do) cut into disjoint pieces, each named by the innermost span that
    holds it."""

    def __init__(self, spans: Iterable[Tuple[object, float, float]]):
        pieces: List[Tuple[float, float, object]] = []
        stack: List[Tuple[float, object]] = []  # (end, name), outermost first
        at = 0.0
        for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
            while stack and stack[-1][0] <= s:
                at = self._close(stack, pieces, at)
            if stack and at < s:
                pieces.append((at, s, stack[-1][1]))
            at = s
            stack.append((min(e, stack[-1][0]) if stack else e, name))
        while stack:
            at = self._close(stack, pieces, at)
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    @staticmethod
    def _close(stack, pieces, at: float) -> float:
        end, name = stack.pop()
        if at < end:
            pieces.append((at, end, name))
            at = end
        return at

    def at(self, t: float):
        """The innermost span holding ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None

    def split(self, lo: float, hi: float) -> Dict[str, float]:
        """The us of [lo, hi) by innermost span, ``other`` where none."""
        out: Dict[str, float] = defaultdict(float)
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        at = lo
        while i < len(self.pieces) and self.pieces[i][0] < hi:
            s, e, name = self.pieces[i]
            s, e = max(s, lo), min(e, hi)
            if e > s:
                if s > at:
                    out["other"] += s - at
                out[name] += e - s
                at = e
            i += 1
        if hi > at:
            out["other"] += hi - at
        return dict(out)


def collect(events: Sequence, base_ns: int, device_type
            ) -> Tuple[List[Span], List[Kernel]]:
    """The session's program spans and device records (us from
    ``base_ns``), each record with its origin (None where the profiler
    links it to no operator)."""
    spans: List[Span] = []
    ops: Dict[int, Tuple[int, float]] = {}  # correlation id -> (thread, us)
    runtime: Dict[int, float] = {}  # correlation id -> us of the launch
    nodes: Dict[int, List] = defaultdict(list)  # thread -> backward nodes
    forward: Dict[Tuple[int, int], float] = {}  # (thread, seq) -> us
    records = []
    for e in events:
        s = (e.start_ns() - base_ns) * 1e-3
        t = s + e.duration_ns() * 1e-3
        if e.device_type() == device_type:
            if t > s and not e.name().startswith(MIRRORS):
                records.append((e.name(), s, t, e.correlation_id(),
                                e.linked_correlation_id()))
            continue
        corr = e.correlation_id()
        if e.linked_correlation_id():  # a runtime call, linked to its op
            runtime.setdefault(corr, s)
            continue
        th = e.start_thread_id()
        if corr not in ops or s < ops[corr][1]:  # the op, not its inner ones
            ops[corr] = (th, s)
        if e.name().startswith(PREFIX):
            spans.append((e.name()[len(PREFIX):], s, t, th))
        seq = e.sequence_nr()
        if seq >= 0 and e.fwd_thread_id() > 0:
            nodes[th].append(((e.fwd_thread_id(), seq), s, t))
        elif seq >= 0:
            forward[(th, seq)] = min(forward.get((th, seq), s), s)
    in_node = {th: Innermost(x) for th, x in nodes.items()}
    kernels: List[Kernel] = []
    for name, s, t, corr, linked in records:
        origin = None
        if linked in ops:
            th, at = ops[linked][0], runtime.get(corr, ops[linked][1])
            node = in_node[th].at(at) if th in in_node else None
            fwd = forward.get(node) if node is not None else None
            origin = (th, at, None if fwd is None else node[0], fwd)
        kernels.append((name, s, t, origin))
    kernels.sort(key=lambda k: k[1])
    return spans, kernels


def attribute(spans: List[Span], kernels: List[Kernel],
              gaps: List[Tuple[float, float]], main: int) -> Dict:
    """Over a window's program spans, device records and idle ``gaps``
    (``trace.union``): {idle_us: {span: us}, idle_class_us: {class: us},
    device_us: {span: us}, host_us and count: {span: us, n} on the main
    thread, unplaced_us: device us of records with no origin, backward_us:
    device us placed through a forward operator}."""
    by_thread: Dict[int, List] = defaultdict(list)
    for name, s, e, th in spans:
        by_thread[th].append((name, s, e))
    inner = {th: Innermost(x) for th, x in by_thread.items()}
    on_main = inner.get(main) or Innermost(())
    idle: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps:
        for name, us in on_main.split(lo, hi).items():
            idle[name] += us
    classes: Dict[str, float] = defaultdict(float)
    for name, us in idle.items():
        classes[span_class(name)] += us
    device: Dict[str, float] = defaultdict(float)
    unplaced = backward = 0.0
    for _, s, t, origin in kernels:
        if origin is None:
            unplaced += t - s
            continue
        if origin[2] is not None:
            backward += t - s
        th, at = origin[2:] if origin[2] is not None else origin[:2]
        where = inner[th].at(at) if th in inner else None
        device[where or "other"] += t - s
    host: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for name, s, e in by_thread.get(main, ()):
        host[name] += e - s
        count[name] += 1
    return {"idle_us": dict(idle), "idle_class_us": dict(classes),
            "device_us": dict(device), "host_us": dict(host),
            "count": dict(count), "unplaced_us": unplaced,
            "backward_us": backward}


def readings(r: Dict, kind: str, n: int) -> Dict[str, Optional[float]]:
    """The per-layer readings of an attributed window of ``n`` epochs
    (``kind`` "train") or batches ("serve"), in ms (syncs in counts) per
    epoch or batch; None where the window holds no span that a reading
    reads."""
    def per(table: str, names: Sequence[str]) -> Optional[float]:
        if not n or not any(x in r["count"] or x in r[table] for x in names):
            return None
        return sum(r[table].get(x, 0.0) for x in names) * 1e-3 / n

    def idle(cls: str) -> Optional[float]:
        return per("idle_us", [x for x in r["count"]
                               if span_class(x) == cls])

    if kind == "serve":
        return {"idle_data_ms.serve": idle("data"),
                "copy_ms.serve": per("host_us", ["data/copy"])}
    syncs = [r["count"][x] for x in r["count"] if x.startswith("sync/")]
    return {"idle_data_ms.train": idle("data"),
            "idle_dispatch_ms.train": idle("dispatch"),
            "idle_solver_ms.train": idle("solver"),
            "syncs_per_epoch.train": sum(syncs) / n if syncs and n else None,
            "text_tower_ms.train": per("device_us", ["model/text"]),
            "mi_stack_ms.train": per("device_us", ["mi/knn", "mi/estimates"]),
            "optimizer_ms.train": per("device_us", ["optim/step"])}


def session_readings(session, kind: str) -> Dict:
    """A stopped ``trace.Session`` reduced by the program spans: the
    readings per epoch (the window's ``solver/stage2`` spans, one an
    epoch) or per batch (its ``step/predict`` spans), and the split of
    idle and device seconds they come from."""
    import torch

    from benchmark import trace

    cuda = torch.autograd.DeviceType.CUDA
    events = session.prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    window = next(e for e in events if e.device_type() != cuda
                  and e.name() == trace.SPAN_PREFIX + "window")
    lo = (window.start_ns() - base) * 1e-3
    hi = lo + window.duration_ns() * 1e-3
    spans, kernels = collect(events, base, cuda)
    spans = [x for x in spans if x[2] > lo and x[1] < hi]
    kernels = [k for k in kernels if k[2] > lo and k[1] < hi]
    busy, gaps = trace.union([k[:3] for k in kernels], lo, hi)
    r = attribute(spans, kernels, gaps, window.start_thread_id())
    n = r["count"].get("solver/stage2" if kind == "train" else
                       "step/predict", 0)
    return dict(readings(r, kind, n), units=n, window_s=(hi - lo) * 1e-6,
                idle_s=(hi - lo - busy) * 1e-6,
                idle_class_s={k: v * 1e-6 for k, v in
                              r["idle_class_us"].items()},
                device_s={k: v * 1e-6 for k, v in r["device_us"].items()},
                unplaced_s=r["unplaced_us"] * 1e-6,
                backward_s=r["backward_us"] * 1e-6, records=len(kernels),
                counts=r["count"])


def main(argv: Sequence[str]) -> int:
    """Run a cell once, traced, with the program spans reduced beside the
    benchmark's own reduction; their readings are the last line."""
    from benchmark import harness, trace

    argv = list(argv) + ["--trace", "1"]
    kind = harness.load("workloads", harness.parse(argv).workload)["traffic"]
    got: List[Dict] = []
    reduce_window = trace.Session.reduce

    def reduce_both(session):
        got.append(session_readings(session, kind))
        return reduce_window(session)

    trace.Session.reduce = reduce_both
    try:
        rc = harness.main(argv)
    finally:
        trace.Session.reduce = reduce_window
    print(json.dumps({"program_spans": got[0] if got else None}), flush=True)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness as _harness

    _harness.cache_env()
    sys.exit(main(sys.argv[1:]))
