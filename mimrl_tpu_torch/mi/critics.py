"""Critic and baseline networks for variational MI estimation (PyTorch
port of ``mimrl_tpu.mi.critics``; ref: VMI.py:25-110).

Sub-module names are the reference torch model's (``MLP_g``, ``MLP_h``,
``MLP_f``, ``MLP``), so an estimator's keys read
``vmi_estimator_f_t.critic_model.MLP_g.fc_in.weight``.

``batched_scores`` and ``batched_log_baseline`` run E critics or baselines
of one parameter shape in one pass (``[E, bs, ...]`` inputs): their
``nn.Linear`` weights are stacked on every call, so gradients flow back to
each module's own parameters, and each layer is one ``baddbmm``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

from mimrl_tpu_torch.utils.activations import get_activation_fn


class MLPStack(nn.Module):
    """[Linear + act] x (layers + 1), then a final Linear
    (ref: VMI.py:13-22)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 layers: int, activation: str = "relu", device=None):
        super().__init__()
        self.act = get_activation_fn(activation)
        self.n_hidden = layers
        self.fc_in = nn.Linear(in_dim, hidden_dim, device=device)
        for i in range(layers):
            setattr(self, f"fc_{i}",
                    nn.Linear(hidden_dim, hidden_dim, device=device))
        self.fc_out = nn.Linear(hidden_dim, output_dim, device=device)

    def linears(self) -> List[nn.Linear]:
        return ([self.fc_in]
                + [getattr(self, f"fc_{i}") for i in range(self.n_hidden)]
                + [self.fc_out])

    def forward(self, x):
        *hidden, out = self.linears()
        for layer in hidden:
            x = self.act(layer(x))
        return out(x)


def stack_linears(modules: Sequence[nn.Module]
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer, the weights [E, out, in] and biases [E, out] of E modules
    of one shape (each has ``linears()``), stacked on this call."""
    return [(torch.stack([lin.weight for lin in layer]),
             torch.stack([lin.bias for lin in layer]))
            for layer in zip(*(m.linears() for m in modules))]


def batched_chain(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  x: torch.Tensor, act: Callable) -> torch.Tensor:
    """x [E, rows, in] through stacked layers, ``act`` after every layer
    but the last: E ``nn.Linear`` chains as one ``baddbmm`` per layer."""
    for i, (w, b) in enumerate(layers):
        x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
        if i < len(layers) - 1:
            x = act(x)
    return x


def batched_mlp(stacks: Sequence[MLPStack], x: torch.Tensor) -> torch.Tensor:
    """E ``MLPStack``s of one shape on x [E, rows, in]."""
    return batched_chain(stack_linears(stacks), x, stacks[0].act)


class CriticModel(nn.Module):
    """Pair-score critic f(x, y) -> scores [bs, bs] (ref: VMI.py:25-69).

    - separate: ``scores[i, j] = h(y_i) . g(x_j)``         (VMI.py:57)
    - concat:   ``scores[i, j] = MLP_f(concat(x_i, y_j))``  (VMI.py:59-65)
    The diagonal holds joint samples either way.
    """

    def __init__(self, critic_type: str, x_dim: int, y_dim: int,
                 hidden_dim: int = 256, embed_dim: int = 128, layers: int = 2,
                 activation: str = "relu", device=None):
        super().__init__()
        self.critic_type = critic_type
        if critic_type == "separate":
            self.MLP_g = MLPStack(x_dim, hidden_dim, embed_dim, layers,
                                  activation, device)
            self.MLP_h = MLPStack(y_dim, hidden_dim, embed_dim, layers,
                                  activation, device)
        elif critic_type == "concat":
            self.MLP_f = MLPStack(x_dim + y_dim, hidden_dim, 1, layers,
                                  activation, device)
        else:
            raise NotImplementedError(critic_type)

    def forward(self, x, y):
        if self.critic_type == "separate":
            return torch.matmul(self.MLP_h(y), self.MLP_g(x).t())
        bs = x.shape[0]
        xx = x[None, :, :].expand(bs, bs, x.shape[-1])  # [a, b] = x_b
        yy = y[:, None, :].expand(bs, bs, y.shape[-1])  # [a, b] = y_a
        raw = self.MLP_f(torch.cat([xx, yy], dim=-1))[..., 0]
        return raw.t()  # scores[i, j] = f(x_i, y_j), VMI.py:65's .t()


def batched_scores(critics: Sequence[CriticModel], x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """E critics of one type and shape on x [E, bs, x_dim], y [E, bs,
    y_dim] -> scores [E, bs, bs], each as ``CriticModel.forward``."""
    if critics[0].critic_type == "separate":
        g = batched_mlp([c.MLP_g for c in critics], x)
        h = batched_mlp([c.MLP_h for c in critics], y)
        return torch.bmm(h, g.transpose(1, 2))
    E, bs = x.shape[:2]
    xx = x[:, None, :, :].expand(E, bs, bs, x.shape[-1])  # [e, a, b] = x_b
    yy = y[:, :, None, :].expand(E, bs, bs, y.shape[-1])  # [e, a, b] = y_a
    pairs = torch.cat([xx, yy], dim=-1).reshape(E, bs * bs, -1)
    raw = batched_mlp([c.MLP_f for c in critics], pairs).reshape(E, bs, bs)
    return raw.transpose(1, 2)


class ClubCritic(nn.Module):
    """Variational conditional net q(y|x) = N(mu(x), exp(logvar(x))) for
    the CLUB upper bound (Cheng et al., ICML 2020)."""

    def __init__(self, x_dim: int, y_dim: int, hidden_dim: int = 256,
                 layers: int = 2, activation: str = "relu", device=None):
        super().__init__()
        self.mu = MLPStack(x_dim, hidden_dim, y_dim, layers, activation, device)
        self.logvar = MLPStack(x_dim, hidden_dim, y_dim, layers, activation,
                               device)

    def forward(self, x):
        return self.mu(x), torch.tanh(self.logvar(x)) * 5.0


class BaselineModel(nn.Module):
    """Log-baseline a(y) -> [bs, 1] (ref: VMI.py:72-110). 'gaussain' [sic]
    is the flag's spelling (ref: Parameters.py:42): the sum of
    Normal(mu, rho) log-probabilities."""

    def __init__(self, baseline_type: str, y_dim: int, hidden_dim: int = 256,
                 layers: int = 2, activation: str = "relu", mu: float = 0.0,
                 rho: float = 1.0, device=None):
        super().__init__()
        self.baseline_type = baseline_type
        self.mu, self.rho = mu, rho
        if baseline_type == "unnormalized":
            self.MLP = MLPStack(y_dim, hidden_dim, 1, layers, activation,
                                device)
        elif baseline_type not in ("constant", "gaussain"):
            raise NotImplementedError(baseline_type)

    def forward(self, y):
        bs = y.shape[0]
        if self.baseline_type == "unnormalized":
            return self.MLP(y).reshape(bs, 1)
        if self.baseline_type == "constant":
            return torch.zeros((bs, 1), dtype=y.dtype, device=y.device)
        return self.gaussian_log_prob(y).reshape(bs, 1)

    def gaussian_log_prob(self, y):
        log_prob = (-0.5 * math.log(2.0 * math.pi) - math.log(self.rho)
                    - 0.5 * ((y - self.mu) / self.rho).square())
        return log_prob.sum(dim=-1)


def batched_log_baseline(baselines: Sequence[BaselineModel],
                         y: torch.Tensor) -> torch.Tensor:
    """E baselines of one type and shape on y [E, bs, y_dim] -> [E, bs, 1],
    each as ``BaselineModel.forward``."""
    kind = baselines[0].baseline_type
    if kind == "unnormalized":
        return batched_mlp([b.MLP for b in baselines], y)
    if kind == "constant":
        return y.new_zeros(y.shape[:2] + (1,))
    return baselines[0].gaussian_log_prob(y)[..., None]
