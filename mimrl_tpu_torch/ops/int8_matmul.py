"""int8 GEMM with a dequantisation epilogue: the CUDA kernel
``csrc/int8_matmul.cu``, its wrapper and its plain PyTorch version.

Replaces ``mimrl_tpu/ops/pallas/int8_matmul.py::int8_matmul`` (kernel
``_matmul_kernel``):

    out = (a_s8 [M, K] @ b_s8 [K, N]) * sa [M, 1] * sb [1, N]

with the products accumulated in int32 (exact) and the epilogue
``(float(acc) * sa) * sb`` in float32, rounded once to ``out_dtype``
(float32 or bfloat16). Integer accumulation has no rounding, so the kernel
equals the plain version bit for bit with float32 output, and after the one
bf16 rounding with bfloat16 output.

The kernel reads both operands contiguous along the contraction: ``a`` as
``[M, K]`` row-major and ``b`` as its transpose ``[N, K]`` row-major. A
quantised activation ``[rows, features]`` and a quantised ``nn.Linear``
weight ``[out, in]`` (passed as the view ``weight.t()``) have these layouts
already, so the forward products copy nothing. An operand in another
layout is copied into the kernel's layout as int8 first (one byte per
element read and written): the weight-gradient product ``x.T @ g`` pays
this for both operands, 2 x 39 MB for the widest ``x`` of the canonical
path, ``[12800, 3072]``, which the card's memory moves in about 24 us. No
float tensor is transposed.

There is no shape gate: every ``M``, ``N``, ``K`` goes to the kernel, which
guards its edges. ``int8_matmul`` takes the plain version only for tensors
on the CPU. A CUDA tensor launches the kernel or raises.
``int8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mimrl_tpu_torch.ops import _build

SOURCE = "int8_matmul.cu"
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version sums int8 products in float64 chunks of this many terms:
# 4096 * 127 * 127 < 2^53, so every chunk is exact
_PLAIN_CHUNK = 4096


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                      sb: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's math in PyTorch ops (and the CPU route): the int8
    products summed exactly (in float64, whose 53 bits hold any sum of
    4096 products; chunks are added as int64), then the float32 epilogue."""
    m, k = a.shape
    acc = torch.zeros(m, b.shape[1], dtype=torch.int64, device=a.device)
    for k0 in range(0, k, _PLAIN_CHUNK):
        part = torch.matmul(a[:, k0:k0 + _PLAIN_CHUNK].double(),
                            b[k0:k0 + _PLAIN_CHUNK].double())
        acc += part.to(torch.int64)
    out = acc.to(torch.float32) * sa.reshape(m, 1).float()
    return (out * sb.reshape(1, -1).float()).to(out_dtype)


def _check(a, b, sa, sb, out_dtype):
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} not supported "
                        "(float32 or bfloat16)")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not form a product")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"int8_matmul: empty product {m} x {k} x {n}")
    # an int32 sum of k products of magnitude <= 127 * 127 must not wrap
    if k > (2 ** 31 - 1) // (127 * 127):
        raise ValueError(f"int8_matmul: K {k} overflows the int32 sum")
    for name, s, size in (("sa", sa, m), ("sb", sb, n)):
        if s.dtype != torch.float32 or s.numel() != size:
            raise ValueError(f"int8_matmul: {name} must be float32 with "
                             f"{size} elements, got {s.dtype} "
                             f"{tuple(s.shape)}")
    for name, x in (("b", b), ("sa", sa), ("sb", sb)):
        if x.device != a.device:
            raise ValueError(f"int8_matmul: {name} on {x.device}, a on "
                             f"{a.device}")


_entry = None


def _kernel_entry():
    """The C entry point (built and configured at first use, then kept)."""
    global _entry
    if _entry is None:
        fn = _build.load(SOURCE, "int8").mimrl_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def int8_matmul(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                sb: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(a [M, K] @ b [K, N]) * sa [M, 1] * sb [1, N]`` -> ``[M, N]`` in
    ``out_dtype``; a, b int8, sa, sb float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise). ``b`` is best given
    as a view whose transpose is contiguous (see the module's note on
    layouts)."""
    _check(a, b, sa, sb, out_dtype)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b, sa, sb, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    a = a.contiguous()            # [M, K], K contiguous
    bt = b.t().contiguous()       # [N, K], K contiguous
    sa = sa.reshape(m).contiguous()
    sb = sb.reshape(n).contiguous()
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    fn = _kernel_entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), bt.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                out.data_ptr(), m, n, k, _OUT_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
