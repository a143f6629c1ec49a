"""Activation registry (ref: Utils.py:70-97), matching
``mimrl_tpu.utils.activations``.

- ``gelu`` is the exact (erf) form.
- ``prelu`` is the fixed 0.25-slope leaky form, as in the JAX package.
- ``rrelu`` uses the deterministic eval-mode slope (lower+upper)/2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "hardshrink": lambda x: F.hardshrink(x, 0.5),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "prelu": lambda x: F.leaky_relu(x, 0.25),
    "relu": F.relu,
    "rrelu": lambda x: F.leaky_relu(x, (1 / 8 + 1 / 3) / 2),
    "tanh": torch.tanh,
}


def get_activation_fn(name: str):
    return _ACTIVATIONS[name]
