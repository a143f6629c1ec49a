"""Fused attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``,
its wrapper, and its plain PyTorch version.

Replaces ``mimrl_tpu/ops/pallas/flash_attention.py::_fwd_call`` (the
forward of ``flash_attention``, with ``dropout_p = 0``): the three TPU
tilings (row, batched, bh) are one function, and one Hopper kernel
computes it; ``MIMRL_FA_VARIANT`` / ``MIMRL_FA_ROWS`` have no
counterpart.

    out = softmax(q . k^T * hd^-0.5 + bias) . v

q, k, v: [bs, nh, T, hd] in float32 or bfloat16; bias: [bs, 1, 1, T]
float32 additive key bias (0 valid, -1e9 padded). Scores and softmax in
float32; P is rounded to the input dtype before P . V, which accumulates
in float32; the output has q's dtype.

Bound on the H100 at the serving shape [128, 12, 100, 64] bf16: 78.6 MB
of q, k, v and out at 3.35 TB/s is 23.5 us; 3.9 GFLOP at 989 TFLOP/s is
4 us. The function is bound by bytes; the kernel's design note and its
measured gap to the bound are in the source and in PERF.md.

``flash_attention`` takes the plain version only for tensors on the CPU.
A CUDA tensor launches the kernel or raises; dropout (the training
slice, with a Philox mask regenerated in the backward) raises on CUDA.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mimrl_tpu_torch.ops import _build

SOURCE = "flash_attention_fwd.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """The kernel's math in PyTorch ops (and the CPU route)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def _check(q, k, v, bias):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [bs, nh, T, hd], "
                         f"got {tuple(q.shape)}")
    bs, nh, t, hd = q.shape
    for name, x in (("k", k), ("v", v)):
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
    for name, x in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.mimrl_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, dropout_p: float = 0.0) -> torch.Tensor:
    """Fused attention forward. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout belongs to the training "
            "slice (flash backward kernel + Philox dropout, ROADMAP.md); "
            "serve with the model in eval mode")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, bias)
    bs, nh, t, hd = q.shape
    out = torch.empty_like(q)
    fn = _library().mimrl_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), bs, nh, t, hd, _DTYPE_CODES[q.dtype],
                1.0 / (hd ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
