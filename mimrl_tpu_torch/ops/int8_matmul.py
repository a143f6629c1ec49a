"""int8 GEMM with a dequantisation epilogue: two CUDA kernels
(``csrc/int8_matmul_wgmma.cu`` and ``csrc/int8_matmul.cu``), their wrapper
and their plain PyTorch version.

Replaces ``mimrl_tpu/ops/pallas/int8_matmul.py::int8_matmul`` (kernel
``_matmul_kernel``):

    out = (a_s8 [M, K] @ b_s8 [K, N]) * sa [M, 1] * sb [1, N]

with the products accumulated in int32 (exact) and the epilogue
``(float(acc) * sa) * sb`` in float32, rounded once to ``out_dtype``
(float32 or bfloat16). Integer accumulation has no rounding, so either
kernel equals the plain version bit for bit with float32 output, and after
the one bf16 rounding with bfloat16 output.

The kernels read both operands contiguous along the contraction: ``a`` as
``[M, K]`` row-major and ``b`` as its transpose ``[N, K]`` row-major (the
only layout ``wgmma`` takes for 8-bit operands). A quantised activation
``[rows, features]`` and a quantised ``nn.Linear`` weight ``[out, in]``
(passed as the view ``weight.t()``) have these layouts already, so the
forward products copy nothing. An operand in another layout is copied into
the kernels' layout as int8 first (one byte per element read and written):
the weight-gradient product ``x.T @ g`` pays this for both operands, 2 x
39 MB for the widest ``x`` of the canonical path, ``[12800, 3072]``. No
float tensor is transposed.

``plan`` picks the instance, and for ``wgmma`` its grid, from
``(M, N, K)``, the operands' alignment and the card's SM count:

- ``wgmma`` (every K that is a multiple of 16, with 16-byte aligned bases:
  what TMA needs; every shape of the canonical path): TMA, ``mbarrier``s,
  ``wgmma`` s8 on 128 x 256 tiles, a persistent grid of at most one block
  per SM that walks the segments ``schedule`` deals it. Where the tiles
  alone leave SMs idle (the weight-gradient shapes), the tiles' 128-byte
  K blocks are dealt out in equal runs (stream-K), and a second kernel
  sums the int32 partial tiles of the tiles so cut.
- ``mma_sync`` (ragged K or misaligned bases): the first kernel,
  ``mma.sync`` s8 with ``cp.async``, one block per 128 x 128 tile.

``int8_matmul`` takes the plain version only for tensors on the CPU. A
CUDA tensor launches one of the two kernels or raises; no instance falls
back to another. ``int8_matmul.launches`` counts kernel launches, of
either instance, and ``int8_matmul.instance_launches`` each instance's.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import NamedTuple

import torch

from mimrl_tpu_torch.ops import _build

SOURCE = "int8_matmul.cu"
SOURCE_WGMMA = "int8_matmul_wgmma.cu"
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version sums int8 products in float64 chunks of this many terms:
# 4096 * 127 * 127 < 2^53, so every chunk is exact
_PLAIN_CHUNK = 4096
# the wgmma instance's output tile and K block (csrc/int8_matmul_wgmma.cu)
TILE_M, TILE_N, BLOCK_K = 128, 256, 128
# stream-K cuts a tile's K blocks into at most this many pieces
MAX_PIECES = 16


class Plan(NamedTuple):
    instance: str    # 'wgmma' or 'mma_sync'
    tiles: int       # output tiles of TILE_M x TILE_N (wgmma)
    k_blocks: int    # BLOCK_K-byte blocks of K (wgmma)
    grid: int        # persistent blocks (wgmma)
    stream_k: bool   # blocks share tiles along K (wgmma)


def plan(m: int, n: int, k: int, sms: int, aligned: bool = True) -> Plan:
    """The instance, and for ``wgmma`` its grid, for an ``[M, K] x [K, N]``
    product on a card of ``sms`` SMs. ``wgmma`` takes K % 16 == 0 with
    16-byte aligned operand bases; ``mma_sync`` the rest. Where there are
    at least as many tiles as SMs, each block takes whole tiles; where the
    tiles alone would leave SMs idle (the weight-gradient shapes), each
    block takes an equal run of the tiles' K blocks (stream-K), so a tile's
    K may be cut into pieces on several blocks."""
    if k % 16 or not aligned:
        return Plan("mma_sync", 0, 0, 0, False)
    tiles = math.ceil(m / TILE_M) * math.ceil(n / TILE_N)
    k_blocks = math.ceil(k / BLOCK_K)
    if tiles >= sms:
        return Plan("wgmma", tiles, k_blocks, sms, False)
    grid = min(sms, tiles * min(k_blocks, MAX_PIECES))
    return Plan("wgmma", tiles, k_blocks, grid, True)


def schedule(p: Plan):
    """The work of each block of a ``wgmma`` plan, as the kernel reads it:
    (per block, its segments [tile, first K block, end K block, slot]; per
    split tile, (tile, first slot, pieces); the number of slots). Blocks
    take whole tiles in turn (block b: tiles b, b + grid, ...), or under
    stream-K equal runs (to one K block) of the tiles' K blocks. A segment
    that is a whole tile has slot -1 and ends in the kernel's epilogue; the
    pieces of a split tile hold consecutive slots, in which they leave
    their int32 partial tiles for the reduce kernel."""
    units = p.tiles * p.k_blocks
    blocks = []
    for b in range(p.grid):
        if not p.stream_k:
            # strided, so that the tiles in flight at once are neighbours
            # and share their rows of a and bt in L2
            blocks.append([[t, 0, p.k_blocks]
                           for t in range(b, p.tiles, p.grid)])
            continue
        lo, hi = b * units // p.grid, (b + 1) * units // p.grid
        segments = []
        while lo < hi:
            t, k0 = divmod(lo, p.k_blocks)
            k1 = min(p.k_blocks, k0 + hi - lo)
            segments.append([t, k0, k1])
            lo += k1 - k0
        blocks.append(segments)
    pieces = Counter(seg[0] for segments in blocks for seg in segments)
    fixes, first, slots = [], {}, 0
    for t in sorted(pieces):
        if pieces[t] > 1:
            first[t] = slots
            fixes.append((t, slots, pieces[t]))
            slots += pieces[t]
    taken = Counter()
    for segments in blocks:
        for seg in segments:
            t = seg[0]
            seg.append(first[t] + taken[t] if t in first else -1)
            taken[t] += t in first
    return blocks, fixes, slots


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


# C entry point -> (source, number of device pointers, number of ints)
_ENTRY_POINTS = {"mimrl_int8_matmul": (SOURCE, 5, 4),
                 "mimrl_int8_matmul_wgmma": (SOURCE_WGMMA, 8, 6)}
_entries = {}
_sms = {}
_schedules = {}


def _entry(name: str):
    """A C entry point (built and configured at first use, then kept):
    device pointers, ints (M, N, K, out_dtype, and for wgmma the grid and
    the number of split tiles), stream."""
    fn = _entries.get(name)
    if fn is None:
        source, n_pointers, n_ints = _ENTRY_POINTS[name]
        fn = getattr(_build.load(source, "int8"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _tables(p: Plan, device: torch.device):
    """``schedule(p)`` as the kernel reads it, on the device (built once
    per plan and device, then kept): (sched: grid + 1 segment offsets, then
    4 ints per segment; fix: 3 ints per split tile; split tiles; slots)."""
    key = (p, device)
    if key not in _schedules:
        blocks, fixes, slots = schedule(p)
        offsets = [0]
        for segments in blocks:
            offsets.append(offsets[-1] + len(segments))
        sched = offsets + [x for segments in blocks for seg in segments
                           for x in seg]
        fix = [x for f in fixes for x in f] or [0]
        _schedules[key] = (
            torch.tensor(sched, dtype=torch.int32, device=device),
            torch.tensor(fix, dtype=torch.int32, device=device),
            len(fixes), slots)
    return _schedules[key]


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def int8_matmul(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                sb: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(a [M, K] @ b [K, N]) * sa [M, 1] * sb [1, N]`` -> ``[M, N]`` in
    ``out_dtype``; a, b int8, sa, sb float32. CPU tensors take the plain
    version; CUDA tensors launch one of the two kernels (or raise). ``b`` is
    best given as a view whose transpose is contiguous (see the module's
    note on layouts)."""
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
    p = plan(m, n, k, _sm_count(a.device),
             aligned=a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0)
    args = (a.data_ptr(), bt.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            out.data_ptr())
    if p.instance == "wgmma":
        sched, fix, n_fix, n_slots = _tables(p, a.device)
        # the int32 partial tiles of the split tiles
        ws = torch.empty(n_slots * TILE_M * TILE_N, dtype=torch.int32,
                         device=a.device) if n_slots else None
        fn = _entry("mimrl_int8_matmul_wgmma")
        args += (ws.data_ptr() if ws is not None else None, sched.data_ptr(),
                 fix.data_ptr(), m, n, k, _OUT_CODES[out_dtype], p.grid,
                 n_fix)
    else:
        fn = _entry("mimrl_int8_matmul")
        args += (m, n, k, _OUT_CODES[out_dtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul ({p.instance}) launch failed: CUDA "
                           f"error {rc}")
    int8_matmul.launches += 1
    int8_matmul.instance_launches[p.instance] += 1
    return out


int8_matmul.launches = 0
int8_matmul.instance_launches = {"wgmma": 0, "mma_sync": 0}
