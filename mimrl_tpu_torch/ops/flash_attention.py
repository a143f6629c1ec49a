"""Fused attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``, their wrappers, their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Replaces ``mimrl_tpu/ops/pallas/flash_attention.py``: ``_fwd_call`` (the
forward) and ``_bwd_call`` (the backward of its ``custom_vjp``). The three
TPU tilings (row, batched, bh) are one function, and one Hopper kernel
each computes it; ``MIMRL_FA_VARIANT`` / ``MIMRL_FA_ROWS`` have no
counterpart.

    out = dropout(softmax(q . k^T * hd^-0.5 + bias)) . v

q, k, v: [bs, nh, T, hd] in float32 or bfloat16; bias: [bs, 1, 1, T]
float32 additive key bias (0 valid, -1e9 padded). Scores and softmax in
float32; P is rounded to the input dtype before P . V, which accumulates
in float32; the output has q's dtype.

Dropout is inverted dropout on P from a Philox4x32-10 mask that is a pure
function of (seed, batch row, head, query, key) (``ops/philox.py``,
``csrc/philox.cuh``): the backward regenerates it, so nothing but q, k, v,
bias and the seed is saved for it. ``seed`` is one int64 on the inputs'
device, read by the kernels; drawing it does not synchronise the host.
``row0`` is the global batch row of q's row 0: a data-parallel rank
(``parallel/mesh.py``) draws the mask of its rows of the whole batch. The
kernels take it as a scalar argument.

Each source holds two instances of its kernel, and ``_instance`` picks one
from the dtype, T and hd alone:

- ``tensor_core`` (the main path, both input types): ``mma.sync`` for every
  product, bf16 for bfloat16, and for float32 tf32 in 3xTF32 (each operand
  split into a rounded hi and lo, three products, chunks of 16 terms added
  in float32: ``csrc/tf32x3.cuh``), so float32 stays float32 within its
  2e-5 tolerances. One Philox call per four (query, key) pairs. The forward
  walks 64-key tiles with an online softmax, so any T; the backward stages
  a whole head in shared memory, so T up to ``max_t_tensor_core_bwd(hd,
  dtype)`` (352 at hd 64 in bf16, 192 in float32); no scratch, no atomics.
- ``simt`` (the backward past that T): the FP32-pipe kernel of the first
  port, with its float32 ``dq_acc`` for bfloat16, up to ``MAX_T_BWD``. The
  SIMT forward has no shape left; its C entry point stays for timing.

Bounds on the H100 at [128, 12, 100, 64]: in bf16 the forward moves 78.6
MB (23.5 us at 3.35 TB/s) for 3.9 GFLOP (4 us at 989 TFLOP/s), the
backward 137.6 MB (41 us) for 9.8 GFLOP (10 us); in float32 twice the
bytes (47 and 82 us) for three TF32 products each (24 and 60 us at 495
TFLOP/s). All are bound by bytes; the kernels' design notes and their
measured gaps are in the sources and in PERF.md.

``flash_attention`` and ``flash_attention_bwd`` take the plain versions
only for tensors on the CPU. A CUDA tensor launches one of the kernels or
raises: no instance falls back to another. ``flash_attention.launches``
and ``flash_attention_bwd.launches`` count kernel launches, of either
instance; their ``instance_launches`` count each instance's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mimrl_tpu_torch.device import widen
from mimrl_tpu_torch.ops import _build
from mimrl_tpu_torch.ops.philox import dropout_keep_mask, dropout_threshold

SOURCE = "flash_attention_fwd.cu"
SOURCE_BWD = "flash_attention_bwd.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_T_BWD = 4096  # the backward keeps its softmax statistics in shared memory
# shared memory a block may use on the H100 (227 KB), which bounds the T of
# the tensor-core backward: it stages the whole head
SMEM_LIMIT = 232448
_DTYPE_CODES = {torch.float32: _build.VARIANTS["float32"],
                torch.bfloat16: _build.VARIANTS["bfloat16"]}


def _probabilities(q, k, bias):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(widen(q), widen(k).transpose(-1, -2)) * scale + bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _keep_mask(q, seed, dropout_p, row0, head0=0):
    bs, nh, t, _ = q.shape
    return dropout_keep_mask(seed, bs, nh, t, t, dropout_p, row0, head0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          seed: Optional[torch.Tensor] = None,
                          dropout_p: float = 0.0, row0: int = 0,
                          head0: int = 0) -> torch.Tensor:
    """The forward kernel's math in PyTorch ops (and the CPU route);
    ``head0``: the global head of q's head 0 (``--seq_shard``)."""
    p = _probabilities(q, k, bias)
    if dropout_p > 0.0:
        p = torch.where(_keep_mask(q, seed, dropout_p, row0, head0),
                        p * (1.0 / (1.0 - dropout_p)), 0.0)
    return torch.matmul(widen(p.to(q.dtype)), widen(v)).to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              seed: Optional[torch.Tensor],
                              d_out: torch.Tensor, dropout_p: float = 0.0,
                              row0: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math in PyTorch ops (and the CPU route): the
    algebra of ``_bwd_kernel`` (flash_attention.py:302-355) written out,
    with its roundings. Returns (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    do = d_out.to(dt).float()
    p = _probabilities(q, k, bias)
    if dropout_p > 0.0:
        keep = _keep_mask(q, seed, dropout_p, row0)
        inv = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, p * inv, 0.0)
    else:
        pd = p
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    if dropout_p > 0.0:
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def max_t_tensor_core_bwd(hd: int, dtype: torch.dtype) -> int:
    """The longest T the tensor-core backward takes at head dim ``hd`` for
    input type ``dtype``: q, k, v and dO as rows of max(hd, 16) + 8 bf16
    elements (bfloat16) or hd + 4 floats (float32), bias and three softmax
    statistics as float32, and the dropout mask as one bit per (query,
    key), all for T rounded up to 16, within ``SMEM_LIMIT``. The same sum
    as ``TcBwdSmem::max_t`` and ``F32BwdSmem::max_t`` in
    ``csrc/flash_attention_bwd.cu``."""
    row = (max(hd, 16) + 8) * 2 if dtype == torch.bfloat16 else (hd + 4) * 4

    def nbytes(t_pad):
        return 4 * t_pad * row + 4 * t_pad * 4 + t_pad * (t_pad // 8)

    t = 16
    while nbytes(t + 16) <= SMEM_LIMIT:
        t += 16
    return t


INSTANCES = ("tensor_core", "simt")


def _instance(dtype: torch.dtype, t: int, hd: int, backward: bool) -> str:
    """Which kernel instance a CUDA call launches: 'tensor_core' (the
    backward only up to ``max_t_tensor_core_bwd(hd, dtype)``), 'simt'
    otherwise."""
    if not backward or t <= max_t_tensor_core_bwd(hd, dtype):
        return "tensor_core"
    return "simt"


def _check_aligned(*tensors):
    """The tensor-core instances stage rows by 16-byte copies."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("flash_attention: the tensor-core kernels need "
                             "16-byte aligned q, k, v and d_out")


def _check(q, k, v, bias, seed=None, dropout_p: float = 0.0, d_out=None):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [bs, nh, T, hd], "
                         f"got {tuple(q.shape)}")
    bs, nh, t, hd = q.shape
    same = [("k", k), ("v", v)] + ([("d_out", d_out)] if d_out is not None else [])
    for name, x in same:
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, q is {q.dtype} {tuple(q.shape)}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (bs, 1, 1, t):
        raise ValueError(f"flash_attention: bias must be float32 "
                         f"[{bs}, 1, 1, {t}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if bs > 65535 or nh > 65535:
        raise ValueError("flash_attention: bs and nh must be <= 65535")
    if d_out is not None and t > MAX_T_BWD:
        raise ValueError(f"flash_attention backward: T {t} > {MAX_T_BWD}")
    tensors = [("q", q), ("bias", bias)] + same
    if dropout_p > 0.0:
        if (seed is None or seed.dtype != torch.int64 or seed.numel() != 1):
            raise ValueError("flash_attention: dropout needs a seed tensor "
                             "of one int64 on the inputs' device")
        tensors.append(("seed", seed))
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _dropout_args(seed, dropout_p, row0=0):
    """(seed pointer, dropout flag, threshold, 1 / (1 - p), the global batch
    row of row 0) for the C entry points."""
    if dropout_p > 0.0:
        return (seed.data_ptr(), 1, dropout_threshold(dropout_p),
                1.0 / (1.0 - dropout_p), int(row0))
    return None, 0, 0, 1.0, 0


_TAIL_ARGTYPES = [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

_entries = {}  # (source, name, dtype) -> the configured C entry point


def _entry(source: str, name: str, n_pointers: int, dtype: torch.dtype):
    """The C entry point ``name`` of a kernel for one input type (built and
    configured at first use, then kept): n_pointers device pointers, then
    bs, nh, T, hd, the dtype code (the SIMT instances only), scale,
    dropout flag, threshold, 1 / (1 - p), the global batch row of row 0,
    stream."""
    fn = _entries.get((source, name, dtype))
    if fn is None:
        variant = str(dtype).replace("torch.", "")
        fn = getattr(_build.load(source, variant), name)
        n_ints = 4 if name.endswith("_tc") else 5
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + _TAIL_ARGTYPES)
        fn.restype = ctypes.c_int
        _entries[(source, name, dtype)] = fn
    return fn


def _forward(q, k, v, bias, seed, dropout_p, row0=0):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, seed, dropout_p, row0)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, bias, seed, dropout_p)
    bs, nh, t, hd = q.shape
    out = torch.empty_like(q)
    seed_ptr, drop, threshold, inv_keep, batch0 = _dropout_args(
        seed, dropout_p, row0)
    instance = _instance(q.dtype, t, hd, backward=False)
    _check_aligned(q, k, v)
    fn = _entry(SOURCE, "mimrl_flash_attention_fwd_tc", 6, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), seed_ptr, bs, nh, t, hd, 1.0 / (hd ** 0.5),
                drop, threshold, inv_keep, batch0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.instance_launches[instance] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, seed: Optional[torch.Tensor],
                        d_out: torch.Tensor, dropout_p: float = 0.0,
                        row0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` for the output gradient
    ``d_out``. CPU tensors take the plain version; CUDA tensors launch the
    backward kernel (or raise)."""
    dropout_threshold(dropout_p)  # raises outside [0, 1)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, seed, d_out, dropout_p,
                                         row0)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, bias, seed, dropout_p, d_out)
    bs, nh, t, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    seed_ptr, drop, threshold, inv_keep, batch0 = _dropout_args(
        seed, dropout_p, row0)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              d_out.data_ptr(), seed_ptr)
    instance = _instance(q.dtype, t, hd, backward=True)
    if instance == "tensor_core":
        _check_aligned(q, k, v, d_out)
        fn = _entry(SOURCE_BWD, "mimrl_flash_attention_bwd_tc", 9, q.dtype)
        args = inputs + (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         bs, nh, t, hd)
    else:
        # the sum of dq over key tiles is kept in float32
        dq_acc = dq if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
        fn = _entry(SOURCE_BWD, "mimrl_flash_attention_bwd", 10, q.dtype)
        args = inputs + (dq.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), bs, nh, t, hd, _DTYPE_CODES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, 1.0 / (hd ** 0.5), drop, threshold, inv_keep, batch0,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.instance_launches[instance] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.instance_launches = dict.fromkeys(INSTANCES, 0)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, backward kernel; residuals q, k, v, bias, seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, dropout_p, row0):
        out = _forward(q, k, v, bias, seed, dropout_p, row0)
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.dropout_p, ctx.row0 = dropout_p, row0
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, seed = ctx.saved_tensors
        # dO is rounded to the input dtype (flash_attention.py:556)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, bias, seed, d_out.to(q.dtype).contiguous(), ctx.dropout_p,
            ctx.row0)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seed: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, row0: int = 0) -> torch.Tensor:
    """Fused attention, differentiable in q, k and v. CPU tensors take the
    plain versions; CUDA tensors launch the kernels (or raise). ``seed``
    (one int64 on the inputs' device) and ``row0`` (the global batch row of
    q's row 0) are read only when ``dropout_p > 0``."""
    dropout_threshold(dropout_p)  # raises outside [0, 1)
    if dropout_p > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_p > 0 needs a seed")
    return _FlashAttention.apply(q, k, v, bias, seed, dropout_p, row0)


flash_attention.launches = 0
flash_attention.instance_launches = dict.fromkeys(INSTANCES, 0)
