"""Variational mutual-information bounds (PyTorch port of
``mimrl_tpu.mi.bounds``).

Plain functions mapping a critic score matrix ``scores[i, j] = f(x_j, y_i)``
(``[bs, bs]``, diagonal = joint samples, off-diagonal = product of
marginals) to a scalar MI lower bound (ref: VMI.py:113-250), plus CLUB's
upper bound. Where the reference detaches a term, so does the port.

Every score bound also takes a stack of matrices ``[E, bs, bs]`` (and a
log-baseline ``[E, bs, 1]``) and returns one value per matrix, ``[E]``:
the batched estimator bank (``models/model.py``) runs the same math for
several estimators in one pass.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


_LAST2 = (-2, -1)


def _eye(scores: Tensor) -> Tensor:
    return torch.eye(scores.shape[-1], dtype=torch.bool, device=scores.device)


def _diag(scores: Tensor) -> Tensor:
    """The diagonal of each matrix, [..., bs]."""
    return torch.diagonal(scores, dim1=-2, dim2=-1)


def logmeanexp_diag(scores: Tensor) -> Tensor:
    """logmeanexp over the diagonal (ref: VMI.py:113-118)."""
    n = scores.shape[-1]
    return torch.logsumexp(_diag(scores), dim=-1) - math.log(n)


def logmeanexp_nodiag(scores: Tensor) -> Tensor:
    """logmeanexp over off-diagonal elements (ref: VMI.py:121-126); the
    diagonal is excluded with a where-mask."""
    n = scores.shape[-1]
    masked = scores.masked_fill(_eye(scores), -math.inf)
    lse = torch.logsumexp(masked.flatten(-2), dim=-1)
    return lse - math.log(n * (n - 1.0))


def exp_nodiag(scores: Tensor) -> Tensor:
    """exp with the diagonal zeroed (ref: VMI.py:129-133)."""
    return torch.exp(scores.masked_fill(_eye(scores), -math.inf))


def dv_lower_bound(scores: Tensor) -> Tensor:
    """Donsker-Varadhan (ref: VMI.py:136-139)."""
    return _diag(scores).mean(dim=-1) - logmeanexp_nodiag(scores)


def mine_lower_bound_parts(scores: Tensor):
    """MINE: (mi, t, et) with t the diagonal scores and et the exp of the
    off-diagonal scores, for the caller's EMA bias correction
    (ref: VMI.py:142-145)."""
    return dv_lower_bound(scores), _diag(scores), exp_nodiag(scores)


def tuba_lower_bound(scores: Tensor,
                     log_baseline: Optional[Tensor] = None) -> Tensor:
    """TUBA; the log-baseline a(y) is subtracted row-wise
    (ref: VMI.py:148-154)."""
    if log_baseline is not None:
        scores = scores - log_baseline
    joint_term = _diag(scores).mean(dim=-1)
    marg_term = torch.exp(logmeanexp_nodiag(scores))
    return 1.0 + joint_term - marg_term


def nwj_lower_bound(scores: Tensor) -> Tensor:
    """NWJ = TUBA with log-baseline 1 (ref: VMI.py:157-159)."""
    return tuba_lower_bound(scores - 1.0)


def infonce_lower_bound(scores: Tensor) -> Tensor:
    """InfoNCE (ref: VMI.py:162-166)."""
    n = scores.shape[-1]
    nll = (_diag(scores) - torch.logsumexp(scores, dim=-1)).mean(dim=-1)
    return math.log(n) + nll


def js_fgan_lower_bound(scores: Tensor) -> Tensor:
    """Jensen-Shannon f-GAN (ref: VMI.py:169-174)."""
    n = scores.shape[-1]
    f_diag = _diag(scores)
    first_term = (-F.softplus(-f_diag)).mean(dim=-1)
    second_term = (F.softplus(scores).sum(dim=_LAST2)
                   - F.softplus(f_diag).sum(dim=-1)) / (n * (n - 1.0))
    return first_term - second_term


def js_lower_bound(scores: Tensor) -> Tensor:
    """NWJ value with JS gradients (ref: VMI.py:177-182)."""
    nwj = nwj_lower_bound(scores)
    js = js_fgan_lower_bound(scores)
    return js + (nwj - js).detach()


def smile_lower_bound(scores: Tensor, clip: float = 1.0) -> Tensor:
    """SMILE with clip = 1 (ref: VMI.py:185-198)."""
    z = logmeanexp_nodiag(torch.clamp(scores, -clip, clip))
    dv = _diag(scores).mean(dim=-1) - z
    js = js_fgan_lower_bound(scores)
    return js + (dv - js).detach()


def log_interpolate(log_a: Tensor, log_b: Tensor, alpha_logit: float) -> Tensor:
    """Numerically stable log(alpha * a + (1 - alpha) * b)
    (ref: VMI.py:201-210)."""
    alpha_logit = torch.full((), alpha_logit, dtype=torch.float32,
                             device=log_a.device)
    log_alpha = -F.softplus(-alpha_logit)
    log_1_minus_alpha = -F.softplus(alpha_logit)
    return torch.logsumexp(
        torch.stack([log_alpha + log_a, log_1_minus_alpha + log_b]), dim=0)


def compute_log_loomean(scores: Tensor) -> Tensor:
    """Log leave-one-out mean of exponentiated scores
    (ref: VMI.py:213-226)."""
    max_scores = scores.amax(dim=-1, keepdim=True)
    lse_minus_max = torch.logsumexp(scores - max_scores, dim=-1, keepdim=True)
    d = lse_minus_max + (max_scores - scores)
    safe_d = torch.where(d != 0.0, d, torch.ones_like(d))
    loo_lse = scores + safe_d + torch.log(-torch.expm1(-safe_d))
    return loo_lse - math.log(scores.shape[-1] - 1.0)


def interp_lower_bound(scores: Tensor, baseline: Tensor,
                       alpha_logit: float) -> Tensor:
    """Interpolated bound of Poole et al. (ref: VMI.py:229-250);
    ``baseline`` is the learned log-baseline a(y), [bs, 1]. The reference's
    ``torch.diag`` of a matrix is the diagonal vector, which broadcasts
    across rows."""
    n = scores.shape[-1]
    nce_baseline = compute_log_loomean(scores)
    interpolated_baseline = log_interpolate(
        nce_baseline, baseline.expand(*baseline.shape[:-1], n), alpha_logit)
    critic_marg = scores - _diag(interpolated_baseline)[..., None, :]
    marg_term = torch.exp(logmeanexp_nodiag(critic_marg))
    critic_joint = _diag(scores)[..., None, :] - interpolated_baseline
    joint_term = (critic_joint.sum(dim=_LAST2)
                  - _diag(critic_joint).sum(dim=-1)) / (n * (n - 1.0))
    return 1.0 + joint_term - marg_term


# score-matrix bounds (critic -> [bs, bs] scores); CLUB is separate
SCORE_BOUND_NAMES = ("dv", "mine", "tuba", "nwj", "infonce", "js", "js_fgan",
                     "smile", "interpolate")
BOUND_NAMES = SCORE_BOUND_NAMES + ("club",)


def club_bound_and_nll(mu: Tensor, logvar: Tensor, y: Tensor):
    """CLUB (Cheng et al. 2020): I(X;Y) <= E_joint[log q(y|x)] -
    E_prod[log q(y|x)] with a variational conditional q. Returns
    (mi_upper_bound, nll); nll trains the critic."""
    inv_var = torch.exp(-logvar)
    pos = -0.5 * ((y - mu).square() * inv_var + logvar).sum(dim=-1)
    diff = y[None, :, :] - mu[:, None, :]  # [bs_x, bs_y, d]
    neg_all = -0.5 * (diff.square() * inv_var[:, None, :]
                      + logvar[:, None, :]).sum(dim=-1)
    return pos.mean() - neg_all.mean(), -pos.mean()


def mi_and_loss(bound_type: str, scores: Tensor,
                log_baseline: Optional[Tensor] = None,
                alpha_logit: float = 0.01, ma_rate: float = 0.01):
    """(mi, mi_loss) as the in-model estimator computes them
    (ref: Model.py:115-148). MINE's EMA accumulator restarts from 1 on
    every call, and its in-model loss is not negated, as in the reference."""
    if bound_type == "mine":
        mi, t, et = mine_lower_bound_parts(scores)
        et_mean = et.mean(dim=_LAST2)
        ma_et = (1.0 - ma_rate) * 1.0 + ma_rate * et_mean
        mi_loss = t.mean(dim=-1) - (1.0 / ma_et).detach() * et_mean
        return mi, mi_loss
    if bound_type == "dv":
        mi = dv_lower_bound(scores)
    elif bound_type == "tuba":
        mi = tuba_lower_bound(scores, log_baseline)
    elif bound_type == "nwj":
        mi = nwj_lower_bound(scores)
    elif bound_type == "infonce":
        mi = infonce_lower_bound(scores)
    elif bound_type == "js":
        mi = js_lower_bound(scores)
    elif bound_type == "js_fgan":
        mi = js_fgan_lower_bound(scores)
    elif bound_type == "smile":
        mi = smile_lower_bound(scores)
    elif bound_type == "interpolate":
        if log_baseline is None:
            raise ValueError("the interpolate bound needs a log-baseline")
        mi = interp_lower_bound(scores, log_baseline, alpha_logit)
    else:
        raise NotImplementedError(bound_type)
    return mi, -mi
