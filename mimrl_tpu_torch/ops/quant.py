"""Dynamic int8 quantised matmul for BERT's dense layers (PyTorch port of
``mimrl_tpu.ops.quant``).

Recipe (SwitchBack-style dynamic quantisation, no calibration state):

- forward: ``y = (q(x) @ q(w)) * sx * sw`` with per-row scales for ``x``
  (amax over the contraction axis) and per-column scales for ``w``.
- backward, straight-through with respect to the quantisation:
  ``dx = g @ w.T`` in full precision (mode ``int8``) and ``dw = x.T @ g``
  in int8; mode ``int8_all`` also runs ``dx`` in int8; mode ``int8_fwd``
  keeps the whole backward in full precision.

Every int8 product goes through ``ops/int8_matmul.py::int8_matmul``: the
hand-written kernel on a CUDA tensor, its plain version on a CPU tensor.
There is no environment switch and no shape gate in front of it (the JAX
package routes to its kernel only under ``MIMRL_INT8_PALLAS=1`` and only
for shapes its tiling supports; the port has one route). Per
``int8_dot`` the kernel is launched once in the forward, once more in the
backward of modes ``int8`` and ``int8_all`` (dw), and a third time in
``int8_all`` (dx).

``quant_linear`` applies an ``nn.Linear``'s parameters this way: names and
shapes do not change with the mode, so checkpoints and the name-based
optimizer split are the same for every mode. The quantisation itself
(amax, scale, round, clip) is plain tensor ops, as the JAX package leaves
it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mimrl_tpu_torch.ops.int8_matmul import int8_matmul

MODES = ("none", "int8_fwd", "int8", "int8_all")


def _quantize(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with a dynamic scale over ``axis`` (the
    contraction axis). Returns (q int8, scale float32) with
    ``x ~= q * scale``. As quant.py:55-61: amax and ``max(amax, 1e-8) / 127``
    in x's own type (so a bfloat16 input has a bfloat16-rounded scale), the
    division ``x / scale`` in float32, round half to even, clip to +-127."""
    # five passes over the operand: the inf-norm is |x|'s max in one
    # reduction, the mixed-type divide promotes x to float32 on the fly, and
    # round and clip work in place on its result
    amax = torch.linalg.vector_norm(x, ord=float("inf"), dim=axis, keepdim=True)
    floor = torch.full((), 1e-8, dtype=x.dtype, device=x.device)
    scale = (torch.maximum(amax, floor) / 127.0).float()
    q = torch.div(x, scale).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def _int8_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ w [K, N] through the int8 kernel: per-row scales for x,
    per-column scales for w (quant.py:70-91, without its gate)."""
    qx, sx = _quantize(x, -1)   # sx [..., 1]
    qw, sw = _quantize(w, 0)    # sw [1, N]
    lead = qx.shape[:-1]
    k, n = qw.shape
    out = int8_matmul(qx.reshape(-1, k), qw, sx.reshape(-1, 1),
                      sw.reshape(1, n), out_dtype)
    return out.reshape(*lead, n)


class _Int8Dot(torch.autograd.Function):
    """Quantised x @ w with straight-through gradients; residuals x, w
    (quant.py:94-124)."""

    @staticmethod
    def forward(ctx, x, w, mode, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        return _int8_matmul(x, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mode = ctx.mode
        gd = g.to(x.dtype)
        if mode == "int8_all":
            # dx = g @ w.T, both quantised (contraction axis: N)
            dx = _int8_matmul(gd, w.t(), x.dtype)
        else:
            dx = torch.matmul(gd, w.t().to(gd.dtype)).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = gd.reshape(-1, gd.shape[-1])
        if mode in ("int8", "int8_all"):
            # dw = x.T @ g, both quantised (contraction axis: batch rows)
            dw = _int8_matmul(x2.t(), g2, w.dtype)
        else:  # int8_fwd: full-precision backward
            dw = torch.matmul(x2.t(), g2).to(w.dtype)
        return dx, dw, None, None


def int8_dot(x: torch.Tensor, w: torch.Tensor, mode: str = "int8",
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantised ``x [..., K] @ w [K, N]`` in ``out_dtype``, differentiable
    in x and w by the mode's backward (see the module's note)."""
    if mode not in MODES[1:]:
        raise ValueError(f"int8_dot: mode {mode!r} not in {MODES[1:]}")
    return _Int8Dot.apply(x, w, mode, out_dtype)


def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], mode: str,
                 dtype: torch.dtype) -> torch.Tensor:
    """An ``nn.Linear``'s ``weight [out, in]`` and ``bias`` applied to
    ``x [..., in]`` with an int8 product: ``QuantDense`` (quant.py:127-147)
    on torch's weight layout. The weight enters as the view ``weight.t()``
    in float32, is quantised per output column, and the bias is added
    after, in the compute type."""
    y = int8_dot(x, weight.t(), mode, dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y
