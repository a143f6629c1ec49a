"""Task losses (PyTorch port of ``mimrl_tpu.train.losses``; ref:
Solver.py:172-192, Utils.py:22-49, :270-279, :447-468, :638-649).

All are mask-aware: each takes an optional ``sample_mask`` so that
cycle-padded batch rows contribute nothing. With a full mask they are the
reference's math.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _masked_mean(x: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return x.mean()
    mask = mask.reshape(x.shape[0], *([1] * (x.dim() - 1)))
    return (x * mask).sum() / (mask.sum() * (x.numel() / x.shape[0]))


def mae_loss(pred, target, mask=None):
    return _masked_mean((pred - target).abs(), mask)


def mse_loss(pred, target, mask=None):
    return _masked_mean((pred - target).square(), mask)


def rmse_loss(pred, target, mask=None):
    """(ref: Utils.py:270-275)"""
    return torch.sqrt(mse_loss(pred, target, mask))


def simse_loss(pred, target, mask=None):
    """Scale-invariant MSE: (sum of diffs)^2 / n^2 (ref: Utils.py:459-468)."""
    diffs = target - pred
    if mask is not None:
        diffs = diffs * mask.reshape(-1)
        n = mask.sum()
    else:
        n = diffs.numel()
    return diffs.sum().square() / (n * n)


def ccc_loss(pred, target, mask=None):
    """1 - concordance correlation coefficient (ref: Utils.py:22-34)."""
    pred, target = pred.reshape(-1), target.reshape(-1)
    m = torch.ones_like(pred) if mask is None else mask.reshape(-1)
    n = m.sum()
    pm = (pred * m).sum() / n
    tm = (target * m).sum() / n
    cov = ((pred - pm) * (target - tm) * m).sum() / n
    pv = ((pred - pm).square() * m).sum() / n
    tv = ((target - tm).square() * m).sum() / n
    return 1.0 - 2.0 * cov / (tv + pv + (tm - pm).square() + 1e-10)


def cross_entropy_loss(logits, labels, mask=None):
    """torch CrossEntropyLoss (logits [n, C], int labels [n])."""
    nll = F.cross_entropy(logits, labels.reshape(-1).long(), reduction="none")
    if mask is not None:
        return (nll * mask).sum() / mask.sum()
    return nll.mean()


def focal_loss(logits, labels, mask=None, gamma: float = 2.0):
    """Focal loss as the reference computes it: the mean CE re-weighted by
    (1 - exp(-CE))^gamma (ref: Utils.py:638-649)."""
    logp = cross_entropy_loss(logits, labels, mask)
    return (1.0 - torch.exp(-logp)) ** gamma * logp


def bce_with_logits_loss(logits, targets, mask=None):
    per = (torch.clamp_min(logits, 0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return _masked_mean(per, mask)


def compute_task_loss(loss_name: str, num_class: int, predictions: Tensor,
                      labels: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Loss dispatch with the reference's reshape conventions
    (ref: Solver.py:317-342)."""
    if loss_name in ("Focal", "CE"):
        logits = predictions.reshape(-1, num_class)
        fn = focal_loss if loss_name == "Focal" else cross_entropy_loss
        return fn(logits, labels.reshape(-1).long(), mask)
    if loss_name == "BCE" and num_class == 2:
        logits = predictions.reshape(-1, num_class)
        one_hot = F.one_hot(labels.reshape(-1).long(), num_class).to(logits.dtype)
        return bce_with_logits_loss(logits, one_hot, mask)
    if loss_name == "BCE":
        return bce_with_logits_loss(predictions.reshape(-1),
                                    labels.reshape(-1).float(), mask)
    reg = {"RMSE": rmse_loss, "MAE": mae_loss, "MSE": mse_loss,
           "SIMSE": simse_loss, "CCC": ccc_loss}
    if loss_name in reg:
        return reg[loss_name](predictions.reshape(-1), labels.reshape(-1), mask)
    raise NotImplementedError(loss_name)
