"""Layer spans on the profiler's own clock.

``span(name)`` marks a stretch of host work as ``mimrl/<name>``. With no
profiler running it returns a shared null context, and its one cost is a
check of ``torch.autograd._profiler_enabled()``. Under a profiler
(``torch.profiler.profile``, ``--profile_dir``) it is a record function of
the profiler's session: the span lands in the same trace as the device's
records, on the same clock, and nesting on the calling thread gives each
span its parent. Tracing is on exactly when a profiler runs, on the
thread that started it and the autograd threads it reaches.

The span is a plain (function-scope) record function, not a user
annotation: a user annotation also gets a mirror on the device's timeline
(``gpu_user_annotation``), which a trace reader would count as a device
operation, while a span here leaves the device's records as they are. The
kernels launched inside a span are linked to it, or to the operator under
it, by the profiler's correlation ids.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "mimrl/"
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the span ``mimrl/<name>``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(PREFIX + name)
