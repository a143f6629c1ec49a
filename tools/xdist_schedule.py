"""Predict the wall time of the tier-1 test run from how it is scheduled.

The tier-1 command (ROADMAP.md) runs pytest-xdist with ``-n 6 --dist
load``. Its scheduler (``xdist/scheduler/load.py``, pytest-xdist 3.8)
first hands each worker one chunk of ``(N // 6) // 4`` consecutive tests in
collection order, then tops a worker up from the front of what is left
when it runs low, and never moves a test off a worker. Collection order is
file order, so a chunk that holds most of the slowest tests runs them one
after another while the other workers go idle: the six tests of
``tests/test_epoch_group.py`` take about 1160 s together on an 8-core CPU,
against the command's 1470 s limit. Which chunk they fall in depends on N
alone.

This script collects the tests as the tier-1 command does, takes each
test's duration from the JUnit report of an earlier run, replays the
scheduler and prints N, the chunk size, the range of N with that chunk
size, the slowest chunks and the predicted wall time. ``--extra K`` asks
what K more fast tests (at the end of the order) would do.

    python tools/xdist_schedule.py --durations report.xml [--extra K]

A test the report lacks counts 0.05 s. The prediction leaves out worker
start-up (about 20 s) and workers that crash and are replaced.
"""

from __future__ import annotations

import argparse
import heapq
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

WORKERS = 6
COLLECT = [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow",
           "--collect-only", "-p", "no:cacheprovider", "-p", "no:randomly"]


def collected() -> list:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(COLLECT, capture_output=True, text=True, env=env).stdout
    return [line.strip() for line in out.splitlines()
            if line.startswith("tests/") and "::" in line]


def durations(report: str) -> dict:
    found = {}
    for case in ET.parse(report).getroot().iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        found[f"{path}::{case.get('name')}"] = float(case.get("time"))
    return found


def chunk_size(n: int) -> int:
    return max((n // WORKERS) // 4, 2)


def replay(times: list) -> list:
    """Each worker's finishing time under LoadScheduling."""
    pending = list(range(len(times)))
    queues = {w: [] for w in range(WORKERS)}

    def send(worker, count):
        queues[worker].extend(pending[:count])
        del pending[:count]

    for w in range(WORKERS):
        send(w, chunk_size(len(times)))
    events = [(times[q[0]], w) for w, q in queues.items() if q]
    heapq.heapify(events)
    ends = [0.0] * WORKERS
    while events:
        now, w = heapq.heappop(events)
        took = times[queues[w].pop(0)]
        ends[w] = now
        low = max(2, len(pending) // WORKERS // 4)
        high = max(2, len(pending) // WORKERS // 2)
        if pending and len(queues[w]) < low and not (
                took >= 0.1 and len(queues[w]) >= 2):
            send(w, high - len(queues[w]))
        if queues[w]:
            heapq.heappush(events, (now + times[queues[w][0]], w))
    return ends


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--durations", required=True,
                    help="JUnit XML report of an earlier tier-1 run")
    ap.add_argument("--extra", type=int, default=0,
                    help="fast tests to add at the end of the order")
    args = ap.parse_args()
    names = collected()
    known = durations(args.durations)
    times = [known.get(n, 0.05) for n in names] + [0.05] * args.extra
    n, size = len(times), chunk_size(len(times))
    lo = next(m for m in range(n, 0, -1) if chunk_size(m - 1) != size)
    hi = next(m for m in range(n, 10 * n) if chunk_size(m + 1) != size)
    print(f"tests {n}, first chunk {size} tests (the same for N {lo}..{hi})")
    chunks = [(sum(times[i:i + size]), i) for i in range(0, WORKERS * size, size)]
    for total, start in sorted(chunks, reverse=True)[:2]:
        print(f"  chunk at {start}: {total:.0f} s, from {names[start]}")
    ends = replay(times)
    print(f"predicted wall time {max(ends):.0f} s; workers end at "
          + ", ".join(f"{e:.0f}" for e in sorted(ends)))


if __name__ == "__main__":
    main()
