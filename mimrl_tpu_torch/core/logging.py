"""Run log and scalar telemetry (the port's copy of
``mimrl_tpu.core.logging``).

- ``set_logger`` / ``log_message``: file + stdout logging
  (ref: Utils.py:52-67) on the dedicated 'mimrl_torch' logger.
- ``ScalarWriter``: the per-epoch scalar channels (ref: Solver.py:467-507)
  as one JSON object per line in ``scalars.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

_LOGGER = "mimrl_torch"


def set_logger(log_path: Optional[str]) -> None:
    """Attach this run's file and stream handlers. Handlers of an earlier
    run are replaced, and foreign handlers (pytest's) are left alone.
    ``None`` (a mesh rank that writes no log) attaches none."""
    logger = logging.getLogger(_LOGGER)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        if getattr(h, "_mimrl_handler", False):
            logger.removeHandler(h)
            h.close()
    if log_path is None:
        return
    file_handler = logging.FileHandler(log_path)
    file_handler.setFormatter(
        logging.Formatter("%(asctime)s:%(levelname)s: %(message)s"))
    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter("%(message)s"))
    for h in (file_handler, stream_handler):
        h._mimrl_handler = True
        logger.addHandler(h)


def log_message(message: str) -> None:
    logging.getLogger(_LOGGER).log(msg=message, level=logging.DEBUG)


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
