"""CubeMLP axis-mixing fusion encoder (PyTorch port of
``mimrl_tpu.models.cubemlp``, einsum route).

Each block mixes the L (time), K (modality) and D (channel) axes of a
``[bs, l, k, d]`` tensor in turn with a 2-layer MLP that contracts the
target axis in place, with residuals, per-axis dropout and a LayerNorm
over that axis, in pre- (``ln_first``) or post- order
(ref: MLPProcess.py:25-122). Weights are ``nn.Linear`` modules named as
the reference's (``mlp_l.fc1``, ``ln_l``, ``res_projection_l``, ...).

The Pallas CubeMLP kernel of the JAX package (``--use_pallas``) is not
ported yet, so ``use_pallas=True`` raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mimrl_tpu_torch.utils.activations import get_activation_fn

# axis of [bs, l, k, d] -> einsum contracting it with a Linear weight [out, in]
_AXIS_EQNS = {
    1: "blkd,hl->bhkd",
    2: "blkd,hk->blhd",
    3: "blkd,hd->blkh",
}
_AXES = (1, 2, 3)
_NAMES = "lkd"


def _axis_bias(b: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1, 1]
    shape[axis] = b.shape[0]
    return b.reshape(shape)


def _axis_linear(x: torch.Tensor, layer: nn.Linear, axis: int) -> torch.Tensor:
    y = torch.einsum(_AXIS_EQNS[axis], x, layer.weight)
    if layer.bias is not None:
        y = y + _axis_bias(layer.bias, axis)
    return y


class AxisMLP(nn.Module):
    """2-layer MLP over one axis (ref: MLPProcess.py:9-21)."""

    def __init__(self, axis: int, d_in: int, d_hidden: int, d_out: int,
                 activate: str, use_bias: bool, device=None):
        super().__init__()
        self.axis = axis
        self.act = get_activation_fn(activate)
        self.fc1 = nn.Linear(d_in, d_hidden, bias=use_bias, device=device)
        self.fc2 = nn.Linear(d_hidden, d_out, bias=use_bias, device=device)

    def forward(self, x):
        h = self.act(_axis_linear(x, self.fc1, self.axis))
        return _axis_linear(h, self.fc2, self.axis)


class AxisResProject(nn.Linear):
    """Bias-free linear residual projection along one axis
    (ref: MLPProcess.py:50-52)."""

    def __init__(self, axis: int, d_in: int, d_out: int, device=None):
        super().__init__(d_in, d_out, bias=False, device=device)
        self.axis = axis

    def forward(self, x):
        return _axis_linear(x, self, self.axis)


class AxisLayerNorm(nn.Module):
    """LayerNorm over one axis of [bs, l, k, d] (ref: MLPProcess.py:34-41)."""

    def __init__(self, axis: int, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.axis = axis
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        mean = x.mean(dim=self.axis, keepdim=True)
        var = (x - mean).square().mean(dim=self.axis, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * _axis_bias(self.weight, self.axis) + _axis_bias(
            self.bias, self.axis)


class MLPsBlock(nn.Module):
    """One CubeMLP block: L, K, D mixing in turn
    (ref: MLPProcess.py:25-122)."""

    def __init__(self, activate: str, d_ins: Sequence[int],
                 d_hiddens: Sequence[int], d_outs: Sequence[int],
                 dropouts: Sequence[float], use_bias: bool,
                 ln_first: bool = False, res_project: bool = False,
                 device=None):
        super().__init__()
        if not res_project and tuple(d_ins) != tuple(d_outs):
            raise ValueError("without a residual projection d_in must equal "
                             "d_out (ref: MLPProcess.py:46-48)")
        self.ln_first = ln_first
        self.res_project = res_project
        ln_dims = d_ins if ln_first else d_outs
        for i, (axis, n) in enumerate(zip(_AXES, _NAMES)):
            self.add_module(f"mlp_{n}", AxisMLP(
                axis, d_ins[i], d_hiddens[i], d_outs[i], activate, use_bias,
                device))
            self.add_module(f"ln_{n}", AxisLayerNorm(axis, ln_dims[i],
                                                     device=device))
            if res_project:
                self.add_module(f"res_projection_{n}", AxisResProject(
                    axis, d_ins[i], d_outs[i], device))
            self.add_module(f"dropout_{n}", nn.Dropout(dropouts[i]))

    def forward(self, x):
        for n in _NAMES:
            residual = (getattr(self, f"res_projection_{n}")(x)
                        if self.res_project else x)
            mlp, ln = getattr(self, f"mlp_{n}"), getattr(self, f"ln_{n}")
            drop = getattr(self, f"dropout_{n}")
            if self.ln_first:
                x = drop(mlp(ln(x))) + residual
            else:
                x = ln(drop(mlp(x)) + residual)
        return x


class MLPEncoder(nn.Module):
    """Stack of MLPsBlocks (ref: MLPProcess.py:126-137)."""

    def __init__(self, activate: str, d_in: Sequence[int],
                 d_hiddens: Sequence[Sequence[int]],
                 d_outs: Sequence[Sequence[int]], dropouts: Sequence[float],
                 use_bias: bool, ln_first: bool = False,
                 res_project: Sequence[bool] = (False, False, True),
                 use_pallas: bool = False, device=None):
        super().__init__()
        if use_pallas:
            raise NotImplementedError(
                "use_pallas: the fused CubeMLP kernel is not ported yet "
                "(ROADMAP.md kernel 3)")
        if not len(d_hiddens) == len(d_outs) == len(res_project):
            raise ValueError("d_hiddens, d_outs and res_project must have "
                             "the same depth")
        self.layers_stack = nn.ModuleList([
            MLPsBlock(activate, d_in if i == 0 else d_outs[i - 1],
                      d_hiddens[i], d_outs[i], dropouts, use_bias, ln_first,
                      res_project[i], device)
            for i in range(len(d_hiddens))
        ])

    def forward(self, x):
        for layer in self.layers_stack:
            x = layer(x)
        return x
