"""The user loss hook, ``--custom_loss module.path:factory`` (PyTorch port
of ``mimrl_tpu.train.custom``; the reference's dead placeholder is
Customization.py:40-41).

The factory receives the run's ``MimrlConfig`` once, when the Solver is
built, and returns a function

    fn(out, labels, feats) -> scalar tensor

- ``out``    the classifier output, ``[bs, num_class]``;
- ``labels`` the routed labels of the task (``[bs]`` or ``[bs, k]``);
- ``feats``  ``(F, T, A, V)``, the fused and per-modality features
  ``[bs, d]``;

whose value is added to stage 2's training objective and to the eval
loss. The ``--epoch_scan`` rung captures the steps in CUDA graphs, so the
function must be capture-safe: tensor ops on the device only, no value
read back to the host (``.item()``, ``float()``, printing) and no Python
branch on a tensor's value.

A spec that names a module of the JAX package is refused with the name of
this package's counterpart, so that a flag never imports JAX here.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

import torch


def load_custom_loss(spec: Optional[str], cfg) -> Optional[Callable]:
    """Resolve ``--custom_loss module.path:factory`` -> fn(out, labels,
    feats). Returns None when the flag is unset. Raises ValueError with the
    spec for a malformed spec, an import failure, a missing attribute, a
    factory that returns no callable, and a module of ``mimrl_tpu``."""
    if not spec:
        return None
    if ":" not in spec:
        raise ValueError(
            f"--custom_loss {spec!r}: expected 'module.path:factory'")
    mod_name, _, attr = spec.partition(":")
    if mod_name.split(".")[0] == "mimrl_tpu":
        port = "mimrl_tpu_torch" + mod_name[len("mimrl_tpu"):]
        raise ValueError(
            f"--custom_loss {spec!r}: {mod_name!r} is a module of the JAX "
            f"package; this package's counterpart is '{port}:{attr}'")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ValueError(f"--custom_loss {spec!r}: cannot import "
                         f"{mod_name!r} ({e})") from e
    try:
        factory = getattr(mod, attr)
    except AttributeError as e:
        raise ValueError(f"--custom_loss {spec!r}: module {mod_name!r} "
                         f"has no attribute {attr!r}") from e
    fn = factory(cfg)
    if not callable(fn):
        raise ValueError(f"--custom_loss {spec!r}: factory returned "
                         f"non-callable {type(fn).__name__}")
    return fn


# ---------------------------------------------------------------------------
# Example factories, usable as
#   --custom_loss mimrl_tpu_torch.train.custom:l2_output
#   --custom_loss mimrl_tpu_torch.train.custom:feature_decorrelation
# and templates for a user's own.
# ---------------------------------------------------------------------------

def l2_output(cfg):
    """A small L2 penalty on the classifier output."""
    del cfg

    def fn(out, labels, feats):
        del labels, feats
        return 1e-3 * torch.mean(torch.square(out))

    return fn


def feature_decorrelation(cfg):
    """A penalty on the cross-correlation of the fused features with each
    modality's features (a hook that reads the feats tuple)."""
    del cfg

    def fn(out, labels, feats):
        del out, labels
        F, T, A, V = feats
        Fc = F - F.mean(dim=0, keepdim=True)
        pen = 0.0
        for X in (T, A, V):
            Xc = X - X.mean(dim=0, keepdim=True)
            pen = pen + torch.mean(torch.square(Fc.T @ Xc / Fc.shape[0]))
        return 1e-2 * pen

    return fn
