"""Checkpoint slots and the run config.

A slot (``best_valid``, ``best_test``, ``latest``) is one file,
``{slot}_model.pt``, written with ``torch.save`` to a temporary file and
moved into place with ``os.replace``, and read with
``torch.load(weights_only=True)``, so it holds only tensors and plain
Python containers. All three slots have one schema, the whole training
state at the end of an epoch (``train/solver.py::Solver._snapshot``)::

    {"format": SLOT_FORMAT, "epoch": int,
     "model": the model's state_dict (the estimator bank included),
     "opt_main", "opt_vmi": ChainOptimizer.state_dict() (count, mu, nu),
     "bank": FeatureBank.state_dict(), "have_bank": bool,
     "lr_schedule": LRScheduler.state_dict(),
     "loader_passes": the train loader's passes,
     "rng": {"solver": the Solver generator's state, "cpu": torch's CPU
             default state, and on a CUDA run "cuda": the CUDA default
             state}}

``Solver._resume`` continues a run from ``latest``; ``restore_model``
gives the model's state_dict for serving, from this schema or from a bare
state_dict (the slots of earlier versions of this package).

``mimrl_tpu``'s msgpack slots (``{slot}_model.msgpack``) are read by
``restore_jax`` through ``core/flax_msgpack.py``, with no flax or msgpack
installed; ``models/convert.py::state_dict_from_jax_slot`` turns one into
the model's state_dict. Orbax slots (``{slot}_model.orbax/``, what
``mimrl_tpu`` writes under ``--ckpt_backend orbax``) are not read: reading
them needs orbax and tensorstore, so ``refuse_orbax`` names such a slot
instead of passing it by as a missing one.

``config.json`` is the ``MimrlConfig`` as JSON, the same file the JAX
package writes.

A mesh run (``parallel/mesh.py``) writes from rank 0 alone
(``CheckpointManager(write=False)`` on the others), and its slots hold
whole tensors: ``whole_slot`` gathers the model-sharded parameters and
rebuilds each optimizer's flat moments in the whole parameters' layout,
so a mesh run's slot serves and resumes unsharded; ``local_slot`` takes a
rank's blocks back, so any slot resumes on a mesh.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from mimrl_tpu_torch.core import flax_msgpack
from mimrl_tpu_torch.parallel.mesh import gather_blocks, shard_dim, take_block

SLOT_FORMAT = "mimrl_tpu_torch.slot/1"


def is_full_slot(state: Dict) -> bool:
    """True for a slot of the full schema, False for a bare state_dict."""
    return state.get("format") == SLOT_FORMAT


def _convert(slot: Dict, model, optimizers: Dict, mesh, to_whole: bool
             ) -> Dict:
    """``slot`` with each model-sharded parameter, and its segment of the
    optimizers' flat moments, gathered whole (``to_whole``) or cut to this
    rank's block."""
    dims = {name: shard_dim(p) for name, p in model.named_parameters()}

    def fn(t, d):
        return gather_blocks(t, mesh, d) if to_whole else take_block(t, mesh, d)

    out = dict(slot)
    out["model"] = {k: (fn(v, dims[k]) if dims.get(k) is not None else v)
                    for k, v in slot["model"].items()}
    n_model = mesh.shape["model"]
    for name, opt in optimizers.items():
        state = dict(slot[name])
        pdims = [shard_dim(p) for p in opt.params]
        local = [torch.Size(p.shape) for p in opt.params]
        whole = [s if d is None else
                 torch.Size(n_model * n if i == d else n
                            for i, n in enumerate(s))
                 for s, d in zip(local, pdims)]
        src, dst = (local, whole) if to_whole else (whole, local)
        for key in ("mu", "nu"):
            if state[key].numel() == 0:
                continue
            parts = state[key].split([s.numel() for s in src])
            state[key] = torch.cat([
                part if d is None else fn(part.view(shape), d).reshape(-1)
                for part, d, shape in zip(parts, pdims, src)])
        state["sizes"] = [s.numel() for s in dst]
        out[name] = state
    return out


def whole_slot(mesh, model, optimizers: Dict, slot: Dict) -> Dict:
    """A mesh rank's slot (``Solver._snapshot``) with whole tensors: the
    model-sharded parameters gathered over ``model`` and the optimizers'
    (``{"opt_main": ..., "opt_vmi": ...}``) flat moments and sizes in the
    whole parameters' layout. Collective: every rank calls it."""
    return _convert(slot, model, optimizers, mesh, True)


def local_slot(mesh, model, optimizers: Dict, slot: Dict) -> Dict:
    """The inverse of ``whole_slot``: this rank's blocks of a slot of
    whole tensors (a mesh run's or an unsharded run's)."""
    return _convert(slot, model, optimizers, mesh, False)


class WholeShapes:
    """The model as ``models/convert.py`` reads it (``state_dict()`` for
    names and shapes, ``named_parameters()`` for the parameters), with
    the model-sharded parameters at their whole shapes: a ``mimrl_tpu``
    slot converts to a slot of whole tensors, which ``local_slot`` cuts."""

    def __init__(self, mesh, model) -> None:
        self.model, self.n = model, mesh.shape["model"]

    def named_parameters(self):
        return self.model.named_parameters()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        dims = {k: shard_dim(p) for k, p in self.model.named_parameters()}
        out = {}
        for k, v in self.model.state_dict().items():
            shape = list(v.shape)
            if dims.get(k) is not None:
                shape[dims[k]] *= self.n
            out[k] = torch.empty(shape, device="meta")
        return out


class CheckpointManager:
    """The slots and config of one run directory; ``write=False`` (a mesh
    rank other than 0) reads and writes nothing."""

    def __init__(self, task_path: str, write: bool = True):
        self.task_path = task_path
        self.write = write

    def _path(self, slot: str) -> str:
        return os.path.join(self.task_path, f"{slot}_model.pt")

    def jax_path(self, slot: str) -> str:
        """Where ``mimrl_tpu`` writes the slot (flax msgpack)."""
        return os.path.join(self.task_path, f"{slot}_model.msgpack")

    def orbax_path(self, slot: str) -> str:
        """Where ``mimrl_tpu`` writes the slot under ``--ckpt_backend
        orbax`` (a directory)."""
        return os.path.join(self.task_path, f"{slot}_model.orbax")

    def refuse_orbax(self, slot: str) -> None:
        """Raise when ``mimrl_tpu`` wrote the slot as an orbax directory,
        which this package cannot read (call it when no ``.pt`` slot and
        no msgpack slot was found)."""
        if os.path.isdir(self.orbax_path(slot)):
            raise NotImplementedError(
                f"{self.orbax_path(slot)} is a mimrl_tpu orbax slot: reading "
                "orbax slots is not ported to mimrl_tpu_torch (ROADMAP.md, "
                "section 3); rerun mimrl_tpu with --ckpt_backend msgpack")

    def save(self, slot: str, state: Dict[str, Any]) -> None:
        if not self.write:
            return
        os.makedirs(self.task_path, exist_ok=True)
        tmp = self._path(slot) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(slot))

    def restore(self, slot: str, map_location=None) -> Optional[Dict[str, Any]]:
        """The slot as it was written, or None when it was never written."""
        path = self._path(slot)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore_model(self, slot: str, map_location=None
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state_dict from the slot, of either schema; None
        when the slot was never written."""
        state = self.restore(slot, map_location)
        if state is not None and is_full_slot(state):
            return state["model"]
        return state

    def restore_jax(self, slot: str) -> Optional[Dict[str, Any]]:
        """``mimrl_tpu``'s msgpack slot as nested dicts of arrays, or None
        when there is none."""
        path = self.jax_path(slot)
        if not os.path.exists(path):
            return None
        return flax_msgpack.read(path)

    def save_config(self, cfg_json: str) -> None:
        if not self.write:
            return
        os.makedirs(self.task_path, exist_ok=True)
        with open(os.path.join(self.task_path, "config.json"), "w") as f:
            f.write(cfg_json)

    def load_config(self) -> Optional[dict]:
        p = os.path.join(self.task_path, "config.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)
