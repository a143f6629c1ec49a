"""Audio/video sequence encoders (PyTorch port of
``mimrl_tpu.models.encoders``).

``BiRnnEncoder`` is a stacked bidirectional GRU or LSTM (ref:
Model.py:437-461): inner layers feed the concat of both directions
forward, and the last layer's two directions are summed. torch's GRU has
the gate order (r, z, n) and the ``n = tanh(W_in x + b_in + r * (W_hn h +
b_hn))`` form of ``encoders.py:94-105``; its LSTM the gate order (i, f,
g, o) of ``encoders.py:116-122``. The parameter names (``weight_ih_l0``,
``weight_hh_l0_reverse``, ...) are the reference's, so the module is an
``nn.RNNBase`` and adds no wrapper level. The JAX package left the
recurrence to XLA (no Pallas kernel), so the port leaves it to cuDNN, one
unidirectional ``torch.gru`` / ``torch.lstm`` call per direction and
layer.

The lengths stay on the device, so a forward makes no host copy and can
be captured in a CUDA graph. The JAX scan holds the state under a prefix
mask (``encoders.py:145-180``); here:

- the forward direction runs over the whole padded sequence: padding
  comes after the valid prefix, so the prefix's outputs do not depend on
  it, and outputs at ``t >= length`` are set to 0;
- the backward direction reverses each sample's valid prefix with a
  device gather (``index = length - 1 - t`` for ``t < length``, padded
  positions stay in place), runs the reverse weights as a forward RNN
  from a zero state, masks the output and gathers it back.

``run_pair`` runs the audio and video towers side by side: on CUDA on two
streams forked from the current one (the JAX package chains both towers'
recurrences into one scan per layer because scans serialize on the TPU
core, ``run_bidir_pair``, encoders.py:182-250).

``ConvEncoder`` is the reference's ``Conv1d(d_in, d_common, 3, padding=1)``
over time (Model.py:248-249; flax's ``SAME`` padding at kernel 3),
applied to the padded sequence as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


class BiRnnEncoder(nn.RNNBase):
    """Stacked bidirectional GRU (``cell='gru'``) or LSTM (``'lstm'``);
    returns the last layer's forward and backward outputs summed,
    [bs, T, hidden]."""

    def __init__(self, cell: str, d_in: int, hidden: int, num_layers: int,
                 device=None):
        modes = {"gru": "GRU", "lstm": "LSTM"}
        if cell not in modes:
            raise ValueError(f"recurrent cell {cell!r}: one of {sorted(modes)}")
        super().__init__(modes[cell], d_in, hidden, num_layers=num_layers,
                         batch_first=True, bidirectional=True, device=device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x: [bs, T, d_in]; lengths: [bs] valid prefix lengths (>= 1), on
        x's device."""
        bs, T, _ = x.shape
        mask = prefix_mask(lengths, T).to(x.dtype)[..., None]  # [bs, T, 1]
        pos = torch.arange(T, device=x.device)[None, :]
        reverse = torch.where(pos < lengths[:, None],
                              lengths[:, None] - 1 - pos, pos)  # [bs, T]
        h0 = x.new_zeros(1, bs, self.hidden_size)
        for layer in range(self.num_layers):
            fwd = self._direction(x, h0, f"l{layer}") * mask
            bwd = _take_time(self._direction(
                _take_time(x, reverse), h0, f"l{layer}_reverse"), reverse) * mask
            x = (fwd + bwd if layer == self.num_layers - 1
                 else torch.cat([fwd, bwd], dim=-1))
        return x

    def _direction(self, x, h0, suffix: str) -> torch.Tensor:
        """One direction of one layer as a forward RNN over x."""
        weights = [getattr(self, f"{name}_{suffix}") for name in
                   ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        if self.mode == "LSTM":
            return torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                              self.training, False, True)[0]
        return torch.gru(x, h0, weights, True, 1, 0.0, self.training, False,
                         True)[0]


_PAIR_STREAMS: Dict[torch.device, Tuple[torch.cuda.Stream, ...]] = {}


def run_pair(enc_a: nn.Module, x_a: torch.Tensor, lengths_a: torch.Tensor,
             enc_b: nn.Module, x_b: torch.Tensor, lengths_b: torch.Tensor):
    """``(enc_a(x_a, lengths_a), enc_b(x_b, lengths_b))``. On CUDA each
    runs on its own stream, forked from the current stream and joined back
    into it before the return, so the two recurrences overlap; autograd
    runs each backward op on its forward op's stream and joins the streams
    of the gradients it returns, so the backward overlaps too. The join is
    also what CUDA graph capture needs. Tensors that cross streams are
    recorded on the stream that uses them, so the allocator reuses none
    early. The kernels and their inputs are those of the two calls, so the
    results equal them bit for bit. On the CPU: the two calls in turn."""
    if x_a.device.type != "cuda":
        return enc_a(x_a, lengths_a), enc_b(x_b, lengths_b)
    device = x_a.device
    if device not in _PAIR_STREAMS:
        _PAIR_STREAMS[device] = (torch.cuda.Stream(device),
                                 torch.cuda.Stream(device))
    current = torch.cuda.current_stream(device)
    outs = []
    for stream, enc, x, lengths in zip(_PAIR_STREAMS[device],
                                       (enc_a, enc_b), (x_a, x_b),
                                       (lengths_a, lengths_b)):
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            outs.append(enc(x, lengths))
        x.record_stream(stream)
        lengths.record_stream(stream)
    for stream, out in zip(_PAIR_STREAMS[device], outs):
        current.wait_stream(stream)
        out.record_stream(current)
    return tuple(outs)


class ConvEncoder(nn.Conv1d):
    """Conv1d over time, kernel 3, stride 1, padding 1; [bs, T, d_in] ->
    [bs, T, d_out]."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__(d_in, d_out, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def _take_time(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[b, index[b, t]] for x [bs, T, d] and index [bs, T]."""
    return torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))


def lengths_from_sequence(x: torch.Tensor) -> torch.Tensor:
    """COUNT of non-all-zero timesteps, clamped to >= 1 (not the index of
    the last such row; ref: Utils.py:297-298 + Model.py:429-432)."""
    valid = (x.abs().sum(dim=-1) != 0).to(torch.int64)  # [bs, T]
    return valid.sum(dim=1).clamp(min=1)


def prefix_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[bs, T] float mask with 1 for t < length."""
    pos = torch.arange(T, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()
