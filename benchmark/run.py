"""Run one benchmark cell once and print its result as the last line:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``harness.py`` for where a cell's files live and ``PERF.md`` for the
cells, metrics and limits.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_env()
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
