"""The reduction of the program's layer spans (``program_spans.py``) on
synthetic profiler events: the innermost span of each instant, the idle
split at span boundaries with the classes and ``other`` adding up to the
idle time, a backward record credited to its forward operator's span,
readings that are None without their spans; and ``trace.py``'s own
reduction unchanged by the program's spans, which make no device record."""

import pytest
import torch

from benchmark import program_spans as ps
from benchmark import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


class Ev:
    """A profiler event as ``kineto_results.events()`` gives it; times in
    us."""

    def __init__(self, name, s, t, device=CPU, thread=MAIN, corr=0,
                 linked=0, seq=-1, fwd=0):
        self._v = dict(name=name, start_ns=int(s * 1e3),
                       duration_ns=int((t - s) * 1e3), device_type=device,
                       start_thread_id=thread,
                       correlation_id=corr, linked_correlation_id=linked,
                       sequence_nr=seq, fwd_thread_id=fwd)

    def __getattr__(self, key):
        return lambda: self._v[key]


def span(name, s, t, corr, thread=MAIN):
    return Ev(ps.PREFIX + name, s, t, thread=thread, corr=corr)


def kernel(name, s, t, corr, linked):
    return Ev(name, s, t, device=CUDA, corr=corr, linked=linked)


def runtime(s, corr, linked, thread=9999):
    # a CUDA runtime call, linked to its operator; the launch's thread is
    # taken from the operator
    return Ev("cudaLaunchKernel", s, s + 1, thread=thread, corr=corr,
              linked=linked)


def window_events():
    """A window [0, 100) us: solver/stage2 [5, 95) holds step/train [10,
    60), which holds model/text [12, 30) and optim/step [40, 55); data/copy
    [62, 70); a sync [80, 90). The model's forward op (aten::mm, seq 7)
    launches k_fwd; its backward node on the autograd thread launches
    k_bwd; the optimizer launches k_opt."""
    return [
        Ev("bench/window", 0, 100, corr=1),
        span("solver/stage2", 5, 95, 2),
        span("step/train", 10, 60, 3),
        span("model/text", 12, 30, 4),
        Ev("aten::mm", 14, 16, corr=5, seq=7),
        Ev("Activity Buffer Request", 15.5, 15.8, corr=5),  # the op's id
        runtime(15, 1005, 5), kernel("k_fwd", 20, 26, 1005, 5),
        Ev("autograd::engine::evaluate_function: MmBackward0", 32, 38,
           thread=AUTOGRAD, corr=6, seq=7, fwd=MAIN),
        Ev("aten::mm", 33, 36, thread=AUTOGRAD, corr=7),
        runtime(34, 1007, 7), kernel("k_bwd", 36, 44, 1007, 7),
        span("optim/step", 40, 55, 8),
        Ev("aten::add_", 41, 42, corr=9),
        runtime(41.5, 1009, 9), kernel("k_opt", 50, 58, 1009, 9),
        span("data/copy", 62, 70, 10),
        span("sync/stage2_end", 80, 90, 11),
        kernel("k_lost", 90, 92, 1011, 0),
    ]


class Session:
    def __init__(self, events, device="cuda"):
        self.prof = type("P", (), {})()
        self.prof.profiler = type("Q", (), {})()
        self.prof.profiler.kineto_results = type(
            "R", (), {"events": lambda _self: events})()
        self.device = torch.device(device)


def test_innermost_names_each_piece():
    inner = ps.Innermost([("a", 0, 10), ("b", 2, 5), ("c", 3, 4),
                          ("d", 7, 9), ("e", 20, 30)])
    assert inner.pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"),
                            (4, 5, "b"), (5, 7, "a"), (7, 9, "d"),
                            (9, 10, "a"), (20, 30, "e")]
    assert [inner.at(t) for t in (0, 3.5, 5, 9.99, 10, 15, 25)] == [
        "a", "c", "a", "a", None, None, "e"]


def test_idle_splits_at_span_boundaries_and_adds_up():
    events = window_events()
    spans, kernels = ps.collect(events, 0, CUDA)
    busy, gaps = trace.union([k[:3] for k in kernels], 0, 100)
    assert gaps == [(0, 20), (26, 36), (44, 50), (58, 90), (92, 100)]
    r = ps.attribute(spans, kernels, gaps, MAIN)
    # [0, 20): other 5, stage2 5, train 2, text 8; [26, 36): text 4,
    # train 6; [44, 50): optim 6; [58, 90): train 2, stage2 2, copy 8,
    # stage2 10, sync 10; [92, 100): stage2 3, other 5
    assert r["idle_us"] == pytest.approx({
        "other": 5 + 5, "solver/stage2": 5 + 2 + 10 + 3,
        "step/train": 2 + 6 + 2, "model/text": 8 + 4, "optim/step": 6,
        "data/copy": 8, "sync/stage2_end": 10})
    assert r["idle_class_us"] == pytest.approx({
        "other": 10, "solver": 30, "dispatch": 28, "data": 8})
    assert sum(r["idle_class_us"].values()) == pytest.approx(100 - busy)


def test_a_backward_record_goes_to_its_forward_operators_span():
    spans, kernels = ps.collect(window_events(), 0, CUDA)
    origin = {k[0]: k[3] for k in kernels}
    # launched at the runtime call's instant, on the operator's thread
    assert origin["k_fwd"] == (MAIN, 15, None, None)
    assert origin["k_bwd"] == (AUTOGRAD, 34, MAIN, 14)
    assert origin["k_lost"] is None
    r = ps.attribute(spans, kernels, [], MAIN)
    assert r["device_us"] == pytest.approx(
        {"model/text": 6 + 8, "optim/step": 8})
    assert r["unplaced_us"] == pytest.approx(2)
    assert r["count"]["sync/stage2_end"] == 1


def test_readings_per_epoch_and_none_without_their_spans():
    spans, kernels = ps.collect(window_events(), 0, CUDA)
    _, gaps = trace.union([k[:3] for k in kernels], 0, 100)
    got = ps.readings(ps.attribute(spans, kernels, gaps, MAIN), "train", 2)
    assert got == pytest.approx({
        "idle_data_ms.train": 8e-3 / 2, "idle_dispatch_ms.train": 28e-3 / 2,
        "idle_solver_ms.train": 30e-3 / 2, "syncs_per_epoch.train": 0.5,
        "text_tower_ms.train": 14e-3 / 2, "mi_stack_ms.train": None,
        "optimizer_ms.train": 8e-3 / 2})
    empty = ps.attribute([], [], [(0, 100)], MAIN)
    for kind in ("train", "serve"):
        assert set(ps.readings(empty, kind, 3).values()) == {None}
    serve = ps.readings(ps.attribute(spans, kernels, gaps, MAIN), "serve", 1)
    assert serve == pytest.approx({"idle_data_ms.serve": 8e-3,
                                   "copy_ms.serve": 8e-3})


def test_the_program_spans_leave_the_benchmarks_reduction_as_it_was():
    events = window_events()
    program = [e for e in events if e.name().startswith(ps.PREFIX)]
    bare = [e for e in events if e not in program]
    a, b = (trace.Session.reduce(Session(x)) for x in (events, bare))
    assert a == b
    assert [k[0] for k in a["kernels"]] == ["k_fwd", "k_bwd", "k_opt",
                                            "k_lost"]


def test_session_readings_over_a_synthetic_window():
    got = ps.session_readings(Session(window_events()), "train")
    assert got["units"] == 1 and got["records"] == 4
    assert sum(got["idle_class_s"].values()) == pytest.approx(got["idle_s"])
    assert got["idle_s"] == pytest.approx(76e-6)
    assert got["idle_solver_ms.train"] == pytest.approx(30e-3)
