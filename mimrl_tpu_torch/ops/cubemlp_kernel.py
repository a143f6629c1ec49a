"""Fused CubeMLP axis-MLP: the CUDA kernel ``csrc/cubemlp_axis_mlp.cu``,
its wrapper, its plain PyTorch version and the ``torch.autograd.Function``
around them.

Replaces ``mimrl_tpu/ops/pallas/cubemlp_kernel.py::_run_fused`` (kernel
``_kernel``), reached through ``fused_axis_mlp``:

    y = act(x x_axis w1 + b1) x_axis w2 + b2

over one axis (1 = L, 2 = K, 3 = D) of ``x [bs, L, K, D]``: two chained
contractions of that axis whose hidden tensor never reaches device memory.
``w1 [d_in, d_hidden]`` and ``w2 [d_hidden, d_out]`` are in the JAX
package's layout and may be views (an ``nn.Linear`` weight transposed): the
kernel takes their strides. ``b1``, ``b2`` are both given or both None.
Everything is float32, as the encoder's input is under either compute type
(BERT returns float32, ``W_t`` and the GRUs run in float32); the output has
``x``'s type.

One kernel serves the three axes. The TPU module sends only the D mix to
its kernel, because Mosaic cannot tile the L and K mixes; that limit is not
this card's, so here every axis goes through the kernel. The activation is
the registry's own (``utils/activations.py``: exact erf gelu), where the TPU
kernel had to use tanh-gelu, so the kernel route and the einsum route agree
to float32 rounding.

The gradient is as ``_fused_bwd`` (cubemlp_kernel.py:189-213): the forward
saves x, w1, w2, b1; the backward recomputes the hidden pre-activation and
is plain einsums (the JAX package has no backward kernel either).

``fused_axis_mlp`` takes the plain version only for tensors on the CPU. A
CUDA tensor launches the kernel or raises. ``fused_axis_mlp.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mimrl_tpu_torch.ops import _build
from mimrl_tpu_torch.utils.activations import get_activation_fn

SOURCE = "cubemlp_axis_mlp.cu"
# the kernel's activation codes: the index in this tuple
ACTIVATIONS = ("elu", "gelu", "hardshrink", "hardtanh", "leakyrelu", "prelu",
               "relu", "rrelu", "tanh")
MAX_SMEM_BYTES = 232448  # what one block can use on an H100

_AXIS_EQNS_FWD = {1: "blkd,lh->bhkd", 2: "blkd,kh->blhd", 3: "blkd,dh->blkh"}
_AXIS_EQNS_GRADW = {1: "blkd,bhkd->lh", 2: "blkd,blhd->kh", 3: "blkd,blkh->dh"}
_AXIS_SUM_DIMS = {1: (0, 2, 3), 2: (0, 1, 3), 3: (0, 1, 2)}


def check_activation(name: str) -> None:
    """Raise for an activation the kernel does not have."""
    if name not in ACTIVATIONS:
        raise ValueError(f"fused_axis_mlp: activation {name!r} is not in the "
                         f"kernel ({ACTIVATIONS})")


def _mix(t, w, axis):
    return torch.einsum(_AXIS_EQNS_FWD[axis], t, w)


def _axis_bias(b, axis):
    shape = [1, 1, 1, 1]
    shape[axis] = b.shape[0]
    return b.reshape(shape)


def _hidden_pre(x, w1, b1, axis):
    h = _mix(x, w1, axis)
    return h if b1 is None else h + _axis_bias(b1, axis)


def fused_axis_mlp_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         b1: Optional[torch.Tensor],
                         b2: Optional[torch.Tensor], axis: int,
                         activate: str) -> torch.Tensor:
    """The kernel's math in PyTorch ops (and the CPU route)."""
    act = get_activation_fn(activate)
    y = _mix(act(_hidden_pre(x, w1, b1, axis)), w2, axis)
    return y if b2 is None else y + _axis_bias(b2, axis)


def _check(x, w1, w2, b1, b2, axis, activate):
    check_activation(activate)
    if axis not in (1, 2, 3):
        raise ValueError(f"fused_axis_mlp: axis {axis} not in (1, 2, 3)")
    if x.dim() != 4:
        raise ValueError(f"fused_axis_mlp: x must be [bs, L, K, D], got "
                         f"{tuple(x.shape)}")
    if (w1.dim() != 2 or w2.dim() != 2 or w1.shape[0] != x.shape[axis]
            or w2.shape[0] != w1.shape[1]):
        raise ValueError(
            f"fused_axis_mlp: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
            f"do not chain over axis {axis} of x {tuple(x.shape)}")
    if (b1 is None) != (b2 is None):
        raise ValueError("fused_axis_mlp: give both biases or neither")
    tensors = [("x", x), ("w1", w1), ("w2", w2)]
    if b1 is not None:
        if b1.shape != (w1.shape[1],) or b2.shape != (w2.shape[1],):
            raise ValueError(f"fused_axis_mlp: biases {tuple(b1.shape)}, "
                             f"{tuple(b2.shape)} do not fit the weights")
        tensors += [("b1", b1), ("b2", b2)]
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_axis_mlp: {name} is {t.dtype}; the "
                            "kernel is float32")
        if t.device != x.device:
            raise ValueError(f"fused_axis_mlp: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.numel() == 0:
        raise ValueError(f"fused_axis_mlp: empty x {tuple(x.shape)}")


_entry = None


def _kernel_entry():
    """(launch, shared-memory size) C entry points, built and configured at
    first use, then kept."""
    global _entry
    if _entry is None:
        lib = _build.load(SOURCE, "float32")
        fn = lib.mimrl_cubemlp_axis_mlp
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.mimrl_cubemlp_axis_mlp_smem
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_longlong
        _entry = (fn, smem)
    return _entry


def _forward(x, w1, w2, b1, b2, axis, activate):
    _check(x, w1, w2, b1, b2, axis, activate)
    if x.device.type == "cpu":
        return fused_axis_mlp_plain(x, w1, w2, b1, b2, axis, activate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_axis_mlp: unsupported device {x.device}")
    x = x.contiguous()
    n_in, n_hidden = w1.shape
    n_out = w2.shape[1]
    outer = 1
    for d in x.shape[:axis]:
        outer *= d
    inner = 1
    for d in x.shape[axis + 1:]:
        inner *= d
    fn, smem = _kernel_entry()
    need = smem(n_in, n_hidden, n_out)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_axis_mlp: sizes {n_in} -> {n_hidden} -> {n_out} need "
            f"{need} bytes of shared memory, a block has {MAX_SMEM_BYTES}")
    shape = list(x.shape)
    shape[axis] = n_out
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if b1 is not None:
        b1, b2 = b1.contiguous(), b2.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                None if b1 is None else b1.data_ptr(),
                None if b2 is None else b2.data_ptr(), y.data_ptr(), outer,
                n_in, n_hidden, n_out, inner, w1.stride(0), w1.stride(1),
                w2.stride(0), w2.stride(1), ACTIVATIONS.index(activate),
                stream)
    if rc != 0:
        raise RuntimeError(f"cubemlp_axis_mlp launch failed: CUDA error {rc}")
    fused_axis_mlp.launches += 1
    return y


class _FusedAxisMLP(torch.autograd.Function):
    """Kernel forward, einsum backward; residuals x, w1, w2, b1."""

    @staticmethod
    def forward(ctx, x, w1, w2, b1, b2, axis, activate):
        y = _forward(x, w1, w2, b1, b2, axis, activate)
        ctx.save_for_backward(x, w1, w2, b1)
        ctx.axis, ctx.activate = axis, activate
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, b1 = ctx.saved_tensors
        axis = ctx.axis
        with torch.enable_grad():
            h_pre = _hidden_pre(x, w1, b1, axis).detach().requires_grad_()
            h = get_activation_fn(ctx.activate)(h_pre)
        dh = _mix(dy, w2.t(), axis)
        dw2 = torch.einsum(_AXIS_EQNS_GRADW[axis], h.detach(), dy)
        (dh_pre,) = torch.autograd.grad(h, h_pre, dh)
        dw1 = torch.einsum(_AXIS_EQNS_GRADW[axis], x, dh_pre)
        dx = _mix(dh_pre, w1.t(), axis)
        db1 = db2 = None
        if b1 is not None:
            db1 = dh_pre.sum(dim=_AXIS_SUM_DIMS[axis])
            db2 = dy.sum(dim=_AXIS_SUM_DIMS[axis])
        return dx, dw1, dw2, db1, db2, None, None


def fused_axis_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   b1: Optional[torch.Tensor], b2: Optional[torch.Tensor],
                   axis: int, activate: str) -> torch.Tensor:
    """The fused axis MLP, differentiable in x, w1, w2, b1 and b2. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    return _FusedAxisMLP.apply(x, w1, w2, b1, b2, axis, activate)


fused_axis_mlp.launches = 0
