"""The dropout mask generator of the attention kernels' plain versions
(``ops/philox.py``): Philox4x32-10 in integer tensor ops against the
published known-answer vectors (Random123's ``kat_vectors``), and the
mask built from it. ``chip_smoke.py`` compares the kernels' masks with
this one on the card, which pins ``csrc/philox.cuh`` to the same vectors.
"""

import numpy as np
import pytest
import torch

from mimrl_tpu_torch.ops.philox import (dropout_bits, dropout_keep_mask,
                                        dropout_threshold, philox4x32_10)

torch.set_num_threads(1)

KNOWN_ANSWERS = [
    ([0, 0, 0, 0], [0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    # the digits of pi
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
     [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def _t(x):
    return torch.tensor(x, dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_known_answer_vectors(counter, key, want):
    got = philox4x32_10(tuple(_t(c) for c in counter), tuple(_t(k) for k in key))
    assert [int(w) for w in got] == want


def test_broadcasts_over_tensors():
    """A tensor of counters gives each its own answer."""
    counters = np.array([k[0] for k in KNOWN_ANSWERS[::2]], np.int64).T
    key = (_t([0, 0x24]), _t([0, 0]))  # second key differs from the vector's
    got = philox4x32_10(tuple(_t(c) for c in counters), key)
    assert [int(w[0]) for w in got] == KNOWN_ANSWERS[0][2]
    assert [int(w[1]) for w in got] != KNOWN_ANSWERS[2][2]


def test_bits_follow_the_counter_layout():
    """bits[b, h, q, k] is word k % 4 of the block with counter
    (k // 4, q, h, b) and key (seed low, seed high)."""
    seed = torch.tensor([(7 << 32) | 5])
    bits = dropout_bits(seed, 2, 3, 5, 10)
    assert bits.shape == (2, 3, 5, 10) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    b, h, q, k = 1, 2, 4, 9
    words = philox4x32_10((_t(k // 4), _t(q), _t(h), _t(b)), (_t(5), _t(7)))
    assert int(bits[b, h, q, k]) == int(words[k % 4])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_mask_keep_rate(p):
    """200k draws: three standard deviations of the keep rate are below
    0.004."""
    keep = dropout_keep_mask(torch.tensor([3]), 4, 5, 100, 100, p)
    assert keep.dtype == torch.bool and keep.shape == (4, 5, 100, 100)
    assert abs(keep.float().mean().item() - (1.0 - p)) < 0.004
    # no structure along any axis
    for dim in range(4):
        other = [d for d in range(4) if d != dim]
        means = keep.float().mean(dim=other)
        assert (means - (1.0 - p)).abs().max().item() < 0.05


def test_same_seed_same_mask():
    a = dropout_keep_mask(torch.tensor([11]), 2, 2, 16, 16, 0.3)
    b = dropout_keep_mask(torch.tensor([11]), 2, 2, 16, 16, 0.3)
    c = dropout_keep_mask(torch.tensor([12]), 2, 2, 16, 16, 0.3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a prefix of the keys is a prefix of the mask (ragged T)
    d = dropout_keep_mask(torch.tensor([11]), 2, 2, 16, 13, 0.3)
    assert torch.equal(a[..., :13], d)


@pytest.mark.parametrize("p", [-0.01, 1.0, 2.0])
def test_threshold_refuses_rates_outside_unit_interval(p):
    with pytest.raises(ValueError, match="dropout_p"):
        dropout_threshold(p)


def test_threshold_is_the_reference_rule():
    assert dropout_threshold(0.0) == 0
    assert dropout_threshold(0.5) == 2 ** 31
    assert dropout_threshold(0.1) == int(np.uint32(0.1 * 4294967296.0))
