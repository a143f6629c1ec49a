"""Command-line entry point (PyTorch port of ``mimrl_tpu.cli.main``;
ref: Main.py).

    python -m mimrl_tpu_torch.cli.main --flags ...

with the reference's flag surface plus ``--device``. The run is on the
CUDA device unless ``--device cpu`` (or ``main(argv, device="cpu")``) asks
for the CPU. Seeding covers python, numpy and, in the Solver, torch's
generators (ref: Main.py:13-24).

SIGTERM or SIGINT stops the run after the current epoch with its
``latest`` slot written; ``--resume <task_dir>/<task_name>`` continues it.
``--bert_weights`` starts BERT from pretrained weights.
"""

from __future__ import annotations

import faulthandler
import random

import numpy as np

from mimrl_tpu_torch.core.config import MimrlConfig, parse_args


def set_random_seed(opt: MimrlConfig) -> None:
    random.seed(opt.seed)
    np.random.seed(opt.seed)


def main(argv=None, device=None, graphs: bool = True):
    """Parse the flags, train, and return the best scores
    [valid, test, test at best valid]. ``graphs=False`` runs the
    ``--epoch_scan`` steps eagerly on the card (see ``Solver``)."""
    faulthandler.enable()
    opt = parse_args(argv)
    set_random_seed(opt)
    from mimrl_tpu_torch.train.solver import Solver

    return Solver(opt, device=device, graphs=graphs).solve()


if __name__ == "__main__":
    main()
