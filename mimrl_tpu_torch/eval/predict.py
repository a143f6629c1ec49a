"""Serving path (PyTorch port of ``mimrl_tpu.eval.predict``).

``Predictor`` restores a run directory (``config.json`` plus a
checkpoint slot), builds the tokenizer, the data loaders and the model
itself, and serves batched predictions with the training-time static
shapes: ``model(..., return_features=False)`` in eval mode under
``torch.inference_mode()``, one call per batch, fed BERT's inputs or,
for a dense-text run, the text features. Labels and metrics follow the
run's dataset family.

The slot is this package's ``{slot}_model.pt`` or, in a run directory of
``mimrl_tpu``, its ``{slot}_model.msgpack`` or ``{slot}_model.orbax/``,
read without flax, orbax or tensorstore (``core/flax_msgpack.py``,
``core/orbax_slot.py``) and converted by
``models/convert.py::state_dict_from_jax_slot``; ``config.json`` is the
same file in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mimrl_tpu_torch.core.checkpoint import CheckpointManager
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.data.tokenizer import build_tokenizer
from mimrl_tpu_torch.data.universal import (get_data_loader,
                                            get_label_from_datas,
                                            uses_raw_text)
from mimrl_tpu_torch.device import resolve_device
from mimrl_tpu_torch.eval.metrics import get_score_from_result
from mimrl_tpu_torch.models.convert import state_dict_from_jax_slot
from mimrl_tpu_torch.models.model import (MODEL_INPUTS, build_model,
                                          forward_batch)


class Predictor:
    """Loads a run directory (config + checkpoint slot) and serves
    batched predictions. Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, task_dir: str, slot: str = "best_valid",
                 config_overrides: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        mgr = CheckpointManager(task_dir)
        cfg_dict = mgr.load_config()
        if cfg_dict is None:
            raise FileNotFoundError(f"no config.json in {task_dir}")
        if config_overrides:
            cfg_dict.update(config_overrides)
        self.cfg = MimrlConfig.from_dict(cfg_dict)

        # the slot, else latest; of each, this package's file, else
        # mimrl_tpu's msgpack file or orbax directory
        state = jax_slot = None
        for name in dict.fromkeys((slot, "latest")):
            state = mgr.restore_model(name, map_location=self.device)
            if state is None:
                jax_slot = mgr.restore_jax(name)
            if state is not None or jax_slot is not None:
                break
        else:
            raise FileNotFoundError(f"no checkpoint in {task_dir}")

        tokenizer = build_tokenizer(self.cfg.bert_vocab)
        (self.train_loader, self.valid_loader, self.test_loader,
         d_t, d_a, d_v) = get_data_loader(self.cfg, tokenizer)
        self.model = build_model(self.cfg, tokenizer.vocab_size, d_a, d_v,
                                 self.device, d_t=d_t,
                                 raw_text=uses_raw_text(self.cfg))
        if state is None:
            state = state_dict_from_jax_slot(jax_slot, self.model)
        self.model.load_state_dict(state, strict=True)
        self.model.eval()

    def forward(self, batch: Dict) -> torch.Tensor:
        """The model's output [bs, num_class] for one host batch."""
        with span("data/copy"):
            inputs = {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                      for k in MODEL_INPUTS if k in batch}
        with span("step/predict"), torch.inference_mode():
            return forward_batch(self.model, inputs, return_features=False)[0]

    def predict_loader(self, loader) -> Tuple[np.ndarray, np.ndarray]:
        """Predictions + targets for a BatchPipeline (mask-filtered)."""
        preds, targets = [], []
        for batch in loader:
            labels = np.asarray(get_label_from_datas(self.cfg, batch))
            out = self.forward(batch).float().cpu().numpy()
            mask = batch["sample_mask"] > 0.5
            preds.append(out[mask])
            targets.append(labels[mask])
        return np.concatenate(preds), np.concatenate(targets)

    def evaluate_split(self, split: str = "test") -> Dict[str, float]:
        loader = {"train": self.train_loader, "valid": self.valid_loader,
                  "test": self.test_loader}[split]
        preds, targets = self.predict_loader(loader)
        return get_score_from_result(preds, targets, self.cfg.dataset,
                                     self.cfg.task, self.cfg.num_class)
