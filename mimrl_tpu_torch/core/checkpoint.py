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
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from mimrl_tpu_torch.core import flax_msgpack

SLOT_FORMAT = "mimrl_tpu_torch.slot/1"


def is_full_slot(state: Dict) -> bool:
    """True for a slot of the full schema, False for a bare state_dict."""
    return state.get("format") == SLOT_FORMAT


class CheckpointManager:
    def __init__(self, task_path: str):
        self.task_path = task_path

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
        os.makedirs(self.task_path, exist_ok=True)
        with open(os.path.join(self.task_path, "config.json"), "w") as f:
            f.write(cfg_json)

    def load_config(self) -> Optional[dict]:
        p = os.path.join(self.task_path, "config.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)
