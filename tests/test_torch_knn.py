"""The port's kNN conditional-product sampler against the JAX package's.

JAX and torch draw different anchors from the same seed, so the
deterministic part is compared with the JAX anchors injected
(``anchor_idx``): the same neighbour index sets and the same triples. With
its own anchors the port's sample is checked for what must hold: anchors
distinct and valid, neighbours valid, never an anchor, and nearest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.mi.knn import prod_knn_sample as jax_knn
from mimrl_tpu_torch.mi.knn import prod_knn_sample

torch.set_num_threads(1)

N, BS = 40, 12


def _banks(seed=0, dx=8, dy=1, dz=8):
    rng = np.random.default_rng(seed)
    X, Y, Z = (rng.normal(size=(N, d)).astype(np.float32) for d in (dx, dy, dz))
    valid = np.arange(N) < 33  # the tail of the bank is cycle padding
    return X, Y, Z, valid


def _jax_anchors(key, valid, m):
    """The anchors jax's sampler draws for this key (knn.py:73-74)."""
    probs = jnp.asarray(valid, jnp.float32)
    return np.asarray(jax.random.choice(
        key, N, shape=(m,), replace=False, p=probs / probs.sum()))


@pytest.mark.parametrize("k,dims", [(2, (8, 1, 8)), (3, (8, 8, 1)), (5, (4, 8, 8))])
def test_injected_anchors_give_jax_triples(k, dims):
    X, Y, Z, valid = _banks(k, *dims)
    key = jax.random.PRNGKey(k)
    want = jax_knn(key, *map(jnp.asarray, (X, Y, Z)), batch_size=BS,
                   k_neighbor=k, valid=jnp.asarray(valid))
    anchors = _jax_anchors(key, valid, BS // k)
    got = prod_knn_sample(
        None, *map(torch.from_numpy, (X, Y, Z)), batch_size=BS, k_neighbor=k,
        valid=torch.from_numpy(valid),
        anchor_idx=torch.from_numpy(anchors.astype(np.int64)))
    m = BS // k
    for g, w in zip(got, want):
        assert g.shape == (m * k, 8)
        # the k neighbours of an anchor may come in another order where
        # distances tie in float32: compare them as sets of rows
        g3 = np.sort(g.numpy().reshape(m, k, 8), axis=1)
        w3 = np.sort(np.asarray(w).reshape(m, k, 8), axis=1)
        np.testing.assert_allclose(g3, w3, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [2, 5])
def test_own_anchors_are_distinct_valid_and_never_neighbours(k):
    X, Y, Z, valid = _banks(7)
    X[:, 0] = np.arange(N)  # rows are recognisable by their first channel
    Z[:, 0] = np.arange(N) * 10.0
    gen = torch.Generator().manual_seed(3)
    x, y, z = prod_knn_sample(gen, *map(torch.from_numpy, (X, Y, Z)),
                              batch_size=BS, k_neighbor=k,
                              valid=torch.from_numpy(valid))
    m = BS // k
    anchors = (z[::k, 0] / 10.0).round().long().numpy()
    neighbours = x[:, 0].round().long().numpy().reshape(m, k)
    assert len(set(anchors)) == m and valid[anchors].all()
    assert valid[neighbours].all()
    assert not set(neighbours.ravel()) & set(anchors)
    # (y, z) are the anchor's, repeated k times; y (width 1) is tiled to 8
    assert torch.equal(z.reshape(m, k, -1)[:, 0], z.reshape(m, k, -1)[:, -1])
    assert y.shape == (m * k, 8) and torch.equal(y[:, 0], y[:, 7])
    # the neighbours are the k nearest candidates in Z-space
    pool = np.array([i for i in range(N) if valid[i] and i not in set(anchors)])
    for a, nb in zip(anchors, neighbours):
        d = ((Z[pool] - Z[a]) ** 2).sum(axis=1)
        assert set(nb) == set(pool[np.argsort(d)[:k]])
    # another draw of the same generator gives other anchors
    z2 = prod_knn_sample(gen, *map(torch.from_numpy, (X, Y, Z)), batch_size=BS,
                         k_neighbor=k, valid=torch.from_numpy(valid))[2]
    assert not torch.equal(z, z2)


def test_refuses_untileable_widths():
    X, Y, Z, valid = _banks(1, 8, 3, 8)
    with pytest.raises(ValueError, match="tile"):
        prod_knn_sample(torch.Generator().manual_seed(0),
                        *map(torch.from_numpy, (X, Y, Z)), batch_size=BS,
                        k_neighbor=2)
