"""Checkpoint slots and the run config.

A slot (``best_valid``, ``best_test``, ``latest``) is one file,
``{slot}_model.pt``, holding the model's ``state_dict`` written with
``torch.save`` and read with ``torch.load(weights_only=True)``.
``config.json`` is the ``MimrlConfig`` as JSON, the same file the JAX
package writes.

Reading the JAX package's msgpack or orbax slots is not supported:
both formats need flax or msgpack. Convert such weights with
``mimrl_tpu_torch.models.convert.state_dict_from_jax`` where JAX is
installed and save them here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, task_path: str):
        self.task_path = task_path

    def _path(self, slot: str) -> str:
        return os.path.join(self.task_path, f"{slot}_model.pt")

    def save(self, slot: str, state_dict: Dict[str, torch.Tensor]) -> None:
        os.makedirs(self.task_path, exist_ok=True)
        tmp = self._path(slot) + ".tmp"
        torch.save(state_dict, tmp)
        os.replace(tmp, self._path(slot))

    def restore(self, slot: str, map_location=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """The slot's state_dict, or None when the slot was never written."""
        path = self._path(slot)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)

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
