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

The TPU module sends only the D mix to its kernel, because Mosaic cannot
tile the L and K mixes; that limit is not this card's, so here every axis
goes through a kernel. The activation is the registry's own
(``utils/activations.py``: exact erf gelu), where the TPU kernel had to use
tanh-gelu, so the kernel route and the einsum route agree to float32
rounding.

``plan`` picks one of three instances from the shape alone (the source's
note gives their designs and bounds):

- ``kmix``: at most ``KMIX_MAX`` units on each side, a trailing extent
  ``inner`` that is a multiple of 4 and a 16-byte aligned x (the K mix,
  3 -> 3 -> 3): one thread per float4 of the trailing axis, on the FP32
  pipes, bound by bytes.
- ``tf32x3_rows`` (``inner == 1``, the D mix) and ``tf32x3_cols``
  (``inner > 1``, the L mix and every other shape): both contractions on
  the tensor cores in 3xTF32, weights resident in shared memory, a
  persistent grid over tiles of ``TILE`` positions. Sizes are padded with
  zeros to the MMA tile, so any size whose weights fit in a block's shared
  memory is taken; a larger one raises.

The gradient is as ``_fused_bwd`` (cubemlp_kernel.py:189-213): the forward
saves x, w1, w2, b1; the backward recomputes the hidden pre-activation and
is plain einsums (the JAX package has no backward kernel either).

``fused_axis_mlp`` takes the plain version only for tensors on the CPU. A
CUDA tensor launches the planned instance or raises; no instance stands in
for another. ``fused_axis_mlp.launches`` counts kernel launches and
``fused_axis_mlp.instance_launches`` each instance's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from mimrl_tpu_torch.ops import _build
from mimrl_tpu_torch.utils.activations import get_activation_fn

SOURCE = "cubemlp_axis_mlp.cu"
# the kernel's activation codes: the index in this tuple
ACTIVATIONS = ("elu", "gelu", "hardshrink", "hardtanh", "leakyrelu", "prelu",
               "relu", "rrelu", "tanh")
_ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
# the kernel's instance codes: the index in this tuple
INSTANCES = ("kmix", "tf32x3_rows", "tf32x3_cols")
_INSTANCE_CODES = {name: i for i, name in enumerate(INSTANCES)}
MAX_SMEM_BYTES = 232448  # what one block can use on an H100
SM_SMEM_BYTES = 233472   # an SM's shared memory; each block reserves 1 KB
THREADS = 256
TILE = 64                # tf32x3: positions per tile
BLOCKS_PER_SM = 2        # tf32x3: its __launch_bounds__
KMIX_MAX = 8             # kmix: most units on each side
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    instance: str             # one of INSTANCES
    vec: int                  # floats per load of x (kmix: and store of y)
    grid: Tuple[int, int]     # blocks
    block: Tuple[int, int]    # threads per block
    tiles: int                # tf32x3: tiles of TILE positions
    smem: int                 # dynamic shared memory, bytes


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tf32x3_smem_bytes(rows: bool, n_in: int, n_hidden: int,
                      n_out: int) -> int:
    """The tf32x3 kernel's shared memory (its ``TcLayout``): both weights
    and biases padded to the MMA tile (a weight's region fits either of its
    orientations), the x tile and the hidden tile."""
    def weight(kp, mp):
        return max(kp * (_round_up(mp, 32) + 8), mp * (_round_up(kp, 32) + 4))

    wm = 2 if rows else 1
    kp1 = _round_up(n_in, 8)
    hp, op = _round_up(n_hidden, 16 * wm), _round_up(n_out, 16 * wm)
    xs = TILE * (_round_up(kp1, 32) + 4) if rows else kp1 * (TILE + 8)
    floats = weight(kp1, hp) + weight(hp, op) + xs + hp * (TILE + 8) + hp + op
    return 4 * floats


@functools.lru_cache(maxsize=None)
def plan(outer: int, n_in: int, n_hidden: int, n_out: int, inner: int,
         sms: int, aligned: bool = True) -> Plan:
    """The instance and grid for x viewed as ``[outer, n_in, inner]`` on a
    card of ``sms`` SMs (``aligned``: x's base is 16-byte aligned).

    ``kmix`` where every unit count is at most KMIX_MAX, ``inner % 4 == 0``
    and x is aligned: blocks of (tx, 256 / tx) threads, tx the power of two
    at or above inner / 4 (at most 256), over (inner / 4, outer); past
    MAX_GRID_Y rows of blocks, each thread walks the outer indices with the
    grid's height as stride. Else ``tf32x3_rows`` where ``inner == 1`` and
    ``tf32x3_cols`` where not: tiles of TILE positions (rows: consecutive
    rows of x; cols: consecutive inner indices of one outer index), walked
    by a persistent grid of at most as many blocks as fit on the card at
    once, block b taking tiles b, b + grid, ...; 16-byte loads of x
    (``vec`` 4) where x is aligned and its rows (rows: n_in) or its
    trailing axis (cols: inner) hold whole float4. Raises where the weights
    do not fit in a block's shared memory."""
    if (max(n_in, n_hidden, n_out) <= KMIX_MAX and inner % 4 == 0
            and aligned):
        inner4 = inner // 4
        tx = min(1 << (inner4 - 1).bit_length(), THREADS)
        ty = THREADS // tx
        grid = (-(-inner4 // tx), min(-(-outer // ty), MAX_GRID_Y))
        return Plan("kmix", 4, grid, (tx, ty), 0, 0)
    rows = inner == 1
    smem = tf32x3_smem_bytes(rows, n_in, n_hidden, n_out)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_axis_mlp: sizes {n_in} -> {n_hidden} -> {n_out} need "
            f"{smem} bytes of shared memory, a block has {MAX_SMEM_BYTES}")
    if rows:
        tiles = -(-outer // TILE)
        vec = 4 if aligned and n_in % 4 == 0 else 1
    else:
        tiles = outer * -(-inner // TILE)
        vec = 4 if aligned and inner % 4 == 0 else 1
    per_sm = min(BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + 1024))
    return Plan("tf32x3_rows" if rows else "tf32x3_cols", vec,
                (min(tiles, sms * per_sm), 1), (THREADS, 1), tiles, smem)


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
_sms = {}


def _kernel_entry():
    """The C entry point, built and configured at first use, then kept."""
    global _entry
    if _entry is None:
        fn = _build.load(SOURCE, "float32").mimrl_cubemlp_axis_mlp
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def _forward(x, w1, w2, b1, b2, axis, activate):
    _check(x, w1, w2, b1, b2, axis, activate)
    if x.device.type == "cpu":
        return fused_axis_mlp_plain(x, w1, w2, b1, b2, axis, activate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_axis_mlp: unsupported device {x.device}")
    x = x.contiguous()
    n_in, n_hidden = w1.shape
    n_out = w2.shape[1]
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    p = plan(outer, n_in, n_hidden, n_out, inner, _sm_count(x.device),
             aligned=x.data_ptr() % 16 == 0)
    shape = list(x.shape)
    shape[axis] = n_out
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if b1 is not None:
        b1, b2 = b1.contiguous(), b2.contiguous()
    args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            None if b1 is None else b1.data_ptr(),
            None if b2 is None else b2.data_ptr(), y.data_ptr(), outer,
            n_in, n_hidden, n_out, inner, w1.stride(0), w1.stride(1),
            w2.stride(0), w2.stride(1), _ACT_CODES[activate],
            _INSTANCE_CODES[p.instance], p.vec, *p.grid, p.block[0], p.smem)
    fn = _kernel_entry()
    # the raw handle: a Stream object per call costs ~8 us of host time
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"cubemlp_axis_mlp ({p.instance}) launch failed: "
                           f"CUDA error {rc}")
    fused_axis_mlp.launches += 1
    fused_axis_mlp.instance_launches[p.instance] += 1
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
    raise). Where no gradient is wanted (serving), the autograd Function's
    host time (~20 us a call) is skipped."""
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w1, w2, b1, b2))):
        return _forward(x, w1, w2, b1, b2, axis, activate)
    return _FusedAxisMLP.apply(x, w1, w2, b1, b2, axis, activate)


fused_axis_mlp.launches = 0
fused_axis_mlp.instance_launches = {name: 0 for name in INSTANCES}
