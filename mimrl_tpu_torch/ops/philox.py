"""Philox4x32-10 in integer tensor ops: the dropout mask of the attention
kernels (``csrc/philox.cuh``) for their plain PyTorch versions.

Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11).
The mask is a pure function of the seed and the position:

    key     = (low word of the seed, high word of the seed)
    counter = (key index // 4, query row, head, batch row)
    bits[b, h, q, k] = word (k mod 4) of philox4x32_10(counter, key)
    keep = bits > threshold,  threshold = int(p * 2^32)

the threshold rule of ``mimrl_tpu/ops/pallas/flash_attention.py:156-159``.
Words are held in int64 tensors with values in [0, 2^32); the 32 x 32 ->
64-bit products are built from 16-bit halves, since int64 would overflow.
Everything runs on the seed's device and nothing is read back.
"""

from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * b, a a 32-bit constant, b an int64
    tensor of 32-bit words."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    mid = a_lo * b_hi + a_hi * b_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = a_hi * b_hi + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    """Four output words for a counter (c0, c1, c2, c3) and a key (k0, k1),
    all int64 tensors (broadcastable) of 32-bit words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + W0) & _MASK32
            k1 = (k1 + W1) & _MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(dropout_p: float) -> int:
    """uint32(p * 2^32): a probability is kept where its bits exceed it."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    return int(dropout_p * 4294967296.0)


def dropout_bits(seed: torch.Tensor, bs: int, nh: int, t_q: int,
                 t_k: int, row0: int = 0, head0: int = 0) -> torch.Tensor:
    """The 32-bit word of every (batch row, head, query, key), as int64
    [bs, nh, t_q, t_k] on the seed's device. ``seed``: one int64.
    ``row0``: the global batch row of row 0 (a data-parallel rank's rows
    draw the bits of their rows of the whole batch); ``head0``: likewise
    the global head of head 0 (a rank's heads under ``--seq_shard``)."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    n4 = (t_k + 3) // 4

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=dev).reshape(shape)

    zero = torch.zeros((bs, nh, t_q, n4), dtype=torch.int64, device=dev)
    counter = (axis(n4, 3) + zero, axis(t_q, 2) + zero,
               axis(nh, 1) + head0 + zero, axis(bs, 0) + row0 + zero)
    words = torch.stack(philox4x32_10(counter, key), dim=-1)
    return words.reshape(bs, nh, t_q, n4 * 4)[..., :t_k]


def dropout_keep_mask(seed: torch.Tensor, bs: int, nh: int, t_q: int, t_k: int,
                      dropout_p: float, row0: int = 0, head0: int = 0
                      ) -> torch.Tensor:
    """bool [bs, nh, t_q, t_k]: True where the probability is kept."""
    return (dropout_bits(seed, bs, nh, t_q, t_k, row0, head0)
            > dropout_threshold(dropout_p))
