"""Sharpness-Aware Minimization (PyTorch port of ``mimrl_tpu.train.sam``;
library parity with the reference's Utils.py:471-538).

The reference ships a SAM optimizer class that its solver never wires up
(``--optm SAM`` raises, ref: Solver.py:150-151), and so does this package
(``train/optim.py``). Here SAM is a two-step update usable with any torch
optimizer:

    loss = sam_step(loss_fn, model, opt, rho)

``loss_fn()`` computes the loss from the parameters' current values; the
gradient at ``w + e(w)`` updates ``w``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch
from torch import nn


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares."""
    return torch.sqrt(sum(g.square().sum() for g in grads))


def sam_ascent(grads: Sequence[torch.Tensor], rho: float = 0.05
               ) -> List[torch.Tensor]:
    """e(w) = rho * g / ||g|| (ref: Utils.py:482-495)."""
    scale = rho / (global_grad_norm(grads) + 1e-12)
    return [g * scale for g in grads]


def sam_step(loss_fn: Callable[[], torch.Tensor],
             params: Union[nn.Module, Sequence[torch.Tensor]],
             opt: torch.optim.Optimizer, rho: float = 0.05) -> torch.Tensor:
    """A full SAM step (ref: Utils.py:497-521): the gradient at w, the
    ascent to w + e(w), the gradient there, then ``opt`` steps from w with
    that gradient. ``params``: a module (its parameters that require a
    gradient) or a list of leaf tensors, the ones ``opt`` updates. Returns
    the loss at w."""
    if isinstance(params, nn.Module):
        params = [p for p in params.parameters() if p.requires_grad]
    params = list(params)
    loss = loss_fn()
    e_w = sam_ascent(torch.autograd.grad(loss, params), rho)
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        torch._foreach_add_(params, e_w)
    grads = torch.autograd.grad(loss_fn(), params)
    with torch.no_grad():
        torch._foreach_copy_(params, saved)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    return loss.detach()
