"""The random draws of a training step, replayed in the system's order.

The system under test draws from two generators, both seeded from the run's
seed: torch's default generator of the device, which ``nn.Dropout`` draws
from, and a generator of its own on the device, which draws one seed per
BERT layer for the attention dropout and six kNN anchor sets per loss. The
reference makes the same calls on generators in the same state, so it draws
the same masks and anchors without reading anything the system made:

- a hidden dropout mask is the mask ``torch.native_dropout`` (``F.dropout``'s
  kernel on the card) draws for a tensor of the same shape and dtype; on
  the CPU ``F.dropout``'s ``bernoulli_`` noise of that shape and dtype. The
  draw depends on the element count, dtype and layout, not on the values;
- the attention mask is Philox4x32-10 of the layer's seed and the position
  (Salmon et al., SC'11), keeping a probability where its 32-bit word
  exceeds ``p * 2^32``: counter (key index // 4, query row, head, batch
  row), key (low word of the seed, high word);
- anchors are ``torch.multinomial`` without replacement over the valid rows.
"""

from __future__ import annotations

from typing import Optional

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) words of a * b, for 32-bit words held in int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    mid = a_lo * b_hi + a_hi * b_lo + (ll >> 16)
    return a_hi * b_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attention_keep(seed: torch.Tensor, bs: int, nh: int, t: int,
                   p: float) -> torch.Tensor:
    """bool [bs, nh, t, t]: True where the attention probability is kept."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key = (s & MASK32, (s >> 32) & MASK32)
    n4 = (t + 3) // 4

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=dev).reshape(shape)

    zero = torch.zeros((bs, nh, t, n4), dtype=torch.int64, device=dev)
    counter = (axis(n4, 3) + zero, axis(t, 2) + zero, axis(nh, 1) + zero,
               axis(bs, 0) + zero)
    words = torch.stack(philox(counter, key), dim=-1).reshape(
        bs, nh, t, n4 * 4)[..., :t]
    return words > int(p * 4294967296.0)


class Draws:
    """The two generators of a run on ``device``, seeded from ``seed`` as
    the system seeds them, or set to saved states."""

    def __init__(self, device, seed: Optional[int] = None,
                 default_state: Optional[torch.Tensor] = None,
                 own_state: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        if seed is not None:
            if self.device.type == "cuda":
                torch.cuda.manual_seed(seed)
            else:
                torch.manual_seed(seed)
            self.gen.manual_seed(seed)
        else:
            if self.device.type == "cuda":
                torch.cuda.set_rng_state(default_state, self.device)
            else:
                torch.set_rng_state(default_state)
            self.gen.set_state(own_state)

    def dropout(self, x: torch.Tensor, p: float, dtype) -> torch.Tensor:
        """Inverted dropout of ``x`` with the mask drawn for a tensor of
        ``x``'s shape in ``dtype``; p 0 draws nothing."""
        if p == 0.0:
            return x
        scratch = torch.empty(x.shape, dtype=dtype, device=x.device)
        if x.device.type == "cuda":
            keep = torch.native_dropout(scratch, p, True)[1]
        else:
            keep = scratch.bernoulli_(1.0 - p)
        return x * keep.to(x.dtype) * (1.0 / (1.0 - p))

    def attention_keep(self, bs: int, nh: int, t: int, p: float):
        seed = torch.randint(0, 2 ** 31 - 1, (1,), device=self.device,
                             generator=self.gen)
        return attention_keep(seed, bs, nh, t, p)

    def anchors(self, valid: torch.Tensor, m: int) -> torch.Tensor:
        return torch.multinomial(valid.float(), m, replacement=False,
                                 generator=self.gen)
