"""String DSL parsers for the CLI flag surface.

The reference CLI (ref: Parameters.py:4-74) uses small string DSLs for
structured flags; these parsers reproduce that exact surface
(ref: Utils.py:226-248):

- ``"50-3-128=10-3-128"`` -> ``[[50, 3, 128], [10, 3, 128]]``  (CubeMLP dims)
- ``"0-1-1"``             -> ``[False, True, True]``            (bool triples)
- ``"0.1-0.1-0.1"``       -> ``[0.1, 0.1, 0.1]``                (float lists)
"""

from __future__ import annotations

import argparse


def str2listoffints(v: str) -> list[list[int]]:
    """``"a-b-c=d-e-f"`` -> ``[[a,b,c],[d,e,f]]``."""
    return [list(map(int, t.split("-"))) for t in v.split("=")]


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected: " + str(v))


def str2bools(v: str) -> list[bool]:
    return list(map(str2bool, v.split("-")))


def str2floats(v: str) -> list[float]:
    return list(map(float, v.split("-")))
