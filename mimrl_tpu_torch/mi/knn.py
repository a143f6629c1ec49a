"""kNN conditional-product sampling on the device (PyTorch port of
``mimrl_tpu.mi.knn``).

The reference builds conditional-product negatives by taking the epoch's
feature bank to the host and running scikit-learn's NearestNeighbors six
times per batch per stage (ref: Model.py:75-106). Here it is a few tensor
ops that stay on the device, with no host round trip:

  1. sample m = bs // k anchor rows, without replacement, valid rows only
  2. the [m, N] squared-euclidean distance matrix (one matmul)
  3. anchors and invalid rows masked to +inf, ``topk`` of the k nearest
  4. x gathered from the neighbours, (y, z) tiled from the anchors

- ``radius`` is accepted and unused, as in the reference: scikit-learn's
  ``kneighbors`` does not read it.
- The reference removes anchor rows before fitting (Model.py:83-85);
  masking them to +inf selects the same rows.
- Dimensions are harmonised by tiling channels to the largest
  (Model.py:98-104).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _tile_to(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``tensor.repeat(1, dim // d)`` (ref: Model.py:100-104)."""
    d = x.shape[1]
    if d != dim:
        if dim % d != 0:
            raise ValueError(f"cannot tile dim {d} to {dim}")
        x = x.repeat(1, dim // d)
    return x


def prod_knn_sample(generator: Optional[torch.Generator], X: torch.Tensor,
                    Y: torch.Tensor, Z: torch.Tensor, batch_size: int,
                    k_neighbor: int, radius: float = 1.0,
                    valid: Optional[torch.Tensor] = None,
                    anchor_idx: Optional[torch.Tensor] = None):
    """Conditional-product triples from the epoch's feature banks.

    X, Y, Z: ``[N, d_*]`` banks (epoch-stale, no gradient). m =
    batch_size // k_neighbor anchors are drawn from ``generator`` (on the
    banks' device) among the rows that ``valid`` ([N] bool) marks, unless
    ``anchor_idx`` ([m] int64) gives them. Returns (x, y, z), each
    ``[m * k_neighbor, max_dim]``: x from the anchors' nearest neighbours
    in Z-space, (y, z) tiled from the anchors (ref: Model.py:88-97).
    """
    del radius
    N = X.shape[0]
    m = batch_size // k_neighbor
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=X.device)
    valid = valid.to(torch.bool)

    # 1. anchors without replacement among valid rows (ref: Model.py:81)
    if anchor_idx is None:
        anchor_idx = torch.multinomial(valid.float(), m, replacement=False,
                                       generator=generator)

    # 2. [m, N] squared distances in Z-space; squaring keeps the order
    Zf = Z.float()
    Zq = Zf[anchor_idx]
    d2 = ((Zq * Zq).sum(dim=1, keepdim=True) - 2.0 * torch.matmul(Zq, Zf.t())
          + (Zf * Zf).sum(dim=1)[None, :])

    # 3. anchors and invalid rows leave the candidate pool
    excluded = ~valid
    excluded = excluded.index_fill(0, anchor_idx, True)
    d2 = d2.masked_fill(excluded[None, :], math.inf)
    nbr_idx = torch.topk(d2, k_neighbor, dim=1, largest=False).indices

    # 4. gather / tile (ref: Model.py:88-97)
    index_x = nbr_idx.reshape(-1)
    index_yz = anchor_idx.repeat_interleave(k_neighbor)
    batch_x, batch_y, batch_z = X[index_x], Y[index_yz], Z[index_yz]
    max_dim = max(batch_x.shape[1], batch_y.shape[1], batch_z.shape[1])
    return (_tile_to(batch_x, max_dim), _tile_to(batch_y, max_dim),
            _tile_to(batch_z, max_dim))
