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

Mesh runs (``parallel/mesh.py``; ref: ``mimrl_tpu/cli/main.py:39-45``):

- without ``--distributed``, a mesh request (``--mesh_data``, whose
  default -1 means every visible card, ``--mesh_model``, ``--mesh_dcn``)
  on a host with more than one visible CUDA device starts one rank per
  card of the mesh, as JAX's one process drives every local chip: rank r
  runs on ``cuda:r``, the ranks join an NCCL group on a free local port,
  and the call returns rank 0's scores. With one visible device (or
  ``--device cpu``) the Solver logs JAX's warning and runs unsharded;
- ``--distributed`` joins the group that torchrun's environment describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), in place of ``jax.distributed.initialize()``: NCCL for
  CUDA ranks (rank on ``cuda:LOCAL_RANK``), gloo for CPU ranks
  (``--device cpu``). Every rank returns the same scores.
"""

from __future__ import annotations

import faulthandler
import json
import os
import random
import socket
import tempfile

import numpy as np

from mimrl_tpu_torch.core.config import MimrlConfig, parse_args

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def set_random_seed(opt: MimrlConfig) -> None:
    random.seed(opt.seed)
    np.random.seed(opt.seed)


def _train(opt: MimrlConfig, device, graphs: bool):
    from mimrl_tpu_torch.train.solver import Solver

    set_random_seed(opt)
    return Solver(opt, device=device, graphs=graphs).solve()


def free_port() -> int:
    """A free TCP port on this host (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_rank(rank: int, opt: MimrlConfig, port: int, world: int,
                graphs: bool, result: str) -> None:
    """One rank of a single-host mesh run, on ``cuda:rank``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        scores = _train(opt, f"cuda:{rank}", graphs)
        if rank == 0:
            with open(result, "w") as f:
                json.dump(scores, f)
    finally:
        dist.destroy_process_group()


def _spawn_local(opt: MimrlConfig, n_devices: int, graphs: bool):
    """A mesh run over this host's cards: one process per rank of the
    mesh; returns rank 0's scores."""
    import torch.multiprocessing as mp

    from mimrl_tpu_torch.parallel.mesh import make_mesh

    world = make_mesh(opt.mesh_data, opt.mesh_model, opt.mesh_pipe,
                      opt.mesh_dcn, n_ranks=n_devices).n_ranks
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "scores.json")
        mp.start_processes(_local_rank, args=(opt, free_port(), world, graphs,
                                              result),
                           nprocs=world, join=True, start_method="spawn")
        with open(result) as f:
            return json.load(f)


def _run_distributed(opt: MimrlConfig, device, graphs: bool):
    """This process as one rank of torchrun's group."""
    import torch
    import torch.distributed as dist

    from mimrl_tpu_torch.train.solver import wants_mesh

    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {', '.join(missing)} not set "
                           "(start the ranks with torchrun)")
    world = int(os.environ["WORLD_SIZE"])
    if world > 1 and not wants_mesh(opt):
        raise ValueError(f"--distributed with {world} ranks and no mesh "
                         "request (--mesh_data 1, --mesh_model 1): each "
                         "rank would train alone")
    if device is not None and str(device).startswith("cpu"):
        backend = "gloo"
    else:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local}"
        torch.cuda.set_device(local)
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    try:
        return _train(opt, device, graphs)
    finally:
        dist.destroy_process_group()


def main(argv=None, device=None, graphs: bool = True):
    """Parse the flags, train, and return the best scores
    [valid, test, test at best valid]. ``graphs=False`` runs the
    ``--epoch_scan`` steps eagerly on the card (see ``Solver``)."""
    faulthandler.enable()
    opt = parse_args(argv)
    device = device if device is not None else opt.device
    if opt.distributed:
        return _run_distributed(opt, device, graphs)
    from mimrl_tpu_torch.train.solver import wants_mesh

    if wants_mesh(opt) and not str(device or "cuda").startswith("cpu"):
        import torch

        n_devices = torch.cuda.device_count()
        if n_devices > 1:
            return _spawn_local(opt, n_devices, graphs)
    return _train(opt, device, graphs)


if __name__ == "__main__":
    main()
