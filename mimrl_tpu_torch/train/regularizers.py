"""Spare losses and regularizers of the reference toolkit (PyTorch port of
``mimrl_tpu.train.regularizers``; SURVEY.md §2.7): CMD, DiffLoss,
gradient reversal, uni- and multivariate Gaussian KLD, the temporal
summaries and the masked mean. A library module: the training loop calls
none of them, and a ``--custom_loss`` factory may.
"""

from __future__ import annotations

import torch


def cmd(x1: torch.Tensor, x2: torch.Tensor, n_moments: int = 5
        ) -> torch.Tensor:
    """Central Moment Discrepancy (ref: Utils.py:374-403)."""
    mx1, mx2 = x1.mean(dim=0), x2.mean(dim=0)
    sx1, sx2 = x1 - mx1, x2 - mx2

    def matchnorm(a, b):
        return torch.sqrt(torch.sum(torch.square(a - b)))

    scms = matchnorm(mx1, mx2)
    for k in range(2, n_moments + 1):
        scms = scms + matchnorm(torch.pow(sx1, k).mean(dim=0),
                                torch.pow(sx2, k).mean(dim=0))
    return scms


def diff_loss(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """Orthogonality penalty between two feature spaces
    (ref: Utils.py:406-430); the row norms are constants of the
    gradient."""
    bs = input1.shape[0]
    x1 = input1.reshape(bs, -1)
    x2 = input2.reshape(bs, -1)
    x1 = x1 - x1.mean(dim=0, keepdim=True)
    x2 = x2 - x2.mean(dim=0, keepdim=True)
    n1 = torch.linalg.norm(x1, dim=1, keepdim=True).detach()
    n2 = torch.linalg.norm(x2, dim=1, keepdim=True).detach()
    x1 = x1 / (n1 + 1e-6)
    x2 = x2 / (n2 + 1e-6)
    return torch.mean(torch.square(x1.T @ x2))


class _ReverseGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g * ctx.p, None


def reverse_gradient(x: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """Gradient reversal layer (ref: Utils.py:433-444): the identity
    forward, the gradient times ``-p`` backward."""
    return _ReverseGradient.apply(x, p)


def _reduce(kl: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return kl.mean()
    if reduction == "sum":
        return kl.sum()
    raise NotImplementedError(reduction)


def univariate_kld(mu1, mu2, var_1, var_2, reduction: str = "mean"
                   ) -> torch.Tensor:
    """KL(N(mu1, var_1) || N(mu2, var_2)) elementwise
    (ref: Utils.py:557-586)."""
    term_1 = torch.log(torch.sqrt(var_2) / torch.sqrt(var_1))
    term_2 = (var_1 + torch.square(mu1 - mu2)) / (2 * var_2)
    return _reduce(term_1 + term_2 - 0.5, reduction)


def multivariate_kld(mu1, mu2, sigma_1, sigma_2, reduction: str = "mean"
                     ) -> torch.Tensor:
    """Diagonal-covariance multivariate KLD (ref: Utils.py:589-635);
    sigma_* are the per-dimension (diagonal) entries [bs, n]."""
    n = mu1.shape[1]
    term_1 = torch.log(torch.prod(sigma_2, dim=-1)
                       / torch.prod(sigma_1, dim=-1))
    term_2 = torch.sum(sigma_1 / sigma_2, dim=-1)
    term_3 = torch.sum(torch.square(mu2 - mu1) / sigma_2, dim=-1)
    return _reduce(0.5 * (term_1 - n + term_2 + term_3), reduction)


def aug_temporal(data: torch.Tensor, aug_dim: int = 1) -> torch.Tensor:
    """[mean, std, min, max] summary over a temporal axis
    (ref: Utils.py:541-549); the std with one degree of freedom less."""
    return torch.cat([data.mean(dim=aug_dim),
                      data.std(dim=aug_dim, correction=1),
                      data.amin(dim=aug_dim), data.amax(dim=aug_dim)], dim=-1)


def mean_temporal(data: torch.Tensor, aug_dim: int = 1) -> torch.Tensor:
    return data.mean(dim=aug_dim)


def masked_mean(tensor: torch.Tensor, mask: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """(ref: Utils.py:339-342)"""
    return (tensor * mask).sum(dim=dim) / mask.sum(dim=dim)
