"""Audio/video sequence encoders (PyTorch port of
``mimrl_tpu.models.encoders``).

``BiRnnEncoder`` is a stacked bidirectional ``torch.nn.GRU`` over packed
sequences (ref: Model.py:437-461): inner layers feed the concat of both
directions forward, and the last layer's two directions are summed.
torch's GRU has the gate order (r, z, n) and the
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))`` form of
``encoders.py:94-105``; its parameter names (``weight_ih_l0``,
``weight_hh_l0_reverse``, ...) are the reference's, so the module
subclasses ``nn.GRU`` and adds no wrapper level. The JAX package left
the recurrence to XLA (no Pallas kernel), so the port leaves it to
cuDNN.

Packing reproduces the JAX masking: the forward direction stops after
``length`` steps, the backward direction starts at ``length - 1``, and
outputs at padded positions are 0. ``pack_padded_sequence`` needs the
lengths on the host, so each call copies them from the device (one
synchronisation per encoder call).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiRnnEncoder(nn.GRU):
    """Stacked bidirectional GRU; returns the last layer's forward and
    backward outputs summed, [bs, T, hidden]."""

    def __init__(self, cell: str, d_in: int, hidden: int, num_layers: int,
                 device=None):
        if cell != "gru":
            raise NotImplementedError(
                f"encoder cell {cell!r}: only the GRU is ported; LSTM and "
                "Conv encoders are ROADMAP.md item 'Encoders and dataset "
                "families'")
        super().__init__(d_in, hidden, num_layers=num_layers,
                         batch_first=True, bidirectional=True, device=device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x: [bs, T, d_in]; lengths: [bs] valid prefix lengths (>= 1)."""
        T = x.shape[1]
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
        fwd, bwd = out.chunk(2, dim=-1)
        return fwd + bwd


def lengths_from_sequence(x: torch.Tensor) -> torch.Tensor:
    """COUNT of non-all-zero timesteps, clamped to >= 1 (not the index of
    the last such row; ref: Utils.py:297-298 + Model.py:429-432)."""
    valid = (x.abs().sum(dim=-1) != 0).to(torch.int64)  # [bs, T]
    return valid.sum(dim=1).clamp(min=1)


def prefix_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[bs, T] float mask with 1 for t < length."""
    pos = torch.arange(T, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()
