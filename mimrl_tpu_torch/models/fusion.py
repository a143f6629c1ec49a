"""The other fusion encoders (PyTorch port of ``mimrl_tpu.models.fusion``).
Each maps the stacked modalities ``[bs, T, K, d]`` to ``[bs, T, K, d]``, so
the composition, the classifier and the MI estimator bank do not change:

- ``TransformerFusion`` (fusion.py:55): a pre-LN transformer over the
  ``T * K`` token grid, with learned time and modality embeddings;
- ``TFNFusion`` (:83): low-rank tensor fusion, a rank-R factor per
  modality, their product summed over the rank, broadcast back over K;
- ``MoEFusion`` (:162): attention blocks, each followed by a top-k routed
  mixture of expert MLPs in dense dispatch (every expert sees every token,
  the gates zero the unrouted pairs). On a mesh with a ``model`` axis the
  experts are split over it (``parallel/mesh.py::shard_params``): a rank
  runs its experts' ``[E/M, bs, S, h]`` and the gated sum is completed over
  ``model``; the router and its top-k run whole on every rank.

Parameter names mirror the flax tree, so the converter is mechanical:
``pos_time`` [time_len, 1, d], ``pos_modality`` [1, K, d],
``block_{i}.{ln1,attn.{query,key,value,out},ln2,fc1,fc2}``, ``ln_out``,
``factor_{k}``, ``attn_ln_{i}``, ``attn_{i}`` and
``moe_{i}.{ln,router,w1,b1,w2,b2}`` (w1 [E, d, 2d], w2 [E, 2d, d] in the
flax layout).

Flax's conventions, kept here:

- every LayerNorm has epsilon 1e-6 (flax's default; torch's is 1e-5);
- the attention is ``nn.MultiHeadDotProductAttention``'s, written as plain
  ops: the query scaled by ``1/sqrt(d/H)`` before its product with the
  keys, a softmax, and dropout on the attention weights with ONE keep mask
  of ``[S, S]`` shared by every batch row and head
  (``broadcast_dropout=True``), scaled by 1/keep. It is drawn from the
  device's default generator, as ``nn.Dropout`` draws, which CUDA graph
  capture registers itself. There is no padding mask: JAX calls the
  fusion with ``mask=None``, so every token of the grid is attended;
- the transformer block's MLP uses exact erf gelu, the experts tanh gelu;
- the router's softmax is float32, and its top-k takes the lower expert
  index first on tied probabilities, as ``jax.lax.top_k`` does (a stable
  descending sort).

The fusions run in float32 under either compute dtype: BERT's output
reaches them through ``W_t`` in float32, in JAX too (its float32 ``W_t``
kernel promotes a bf16 input).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.device import widen
from mimrl_tpu_torch.parallel import mesh as pmesh
from mimrl_tpu_torch.parallel.mesh import Dropout

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention(h, h)``:
    ``query``/``key``/``value``/``out`` projections with biases, the
    flax kernels ``[d, H, hd]`` / ``[H, hd, d]`` flattened into
    ``nn.Linear`` weights ``[d, d]``, and dropout of the attention weights
    by one ``[S, S]`` mask."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(d_model, d_model, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, S, d = x.shape
        H = self.num_heads
        q, k, v = (getattr(self, n)(x).reshape(bs, S, H, d // H).transpose(1, 2)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(d // H)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # [bs, H, S, S]
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.empty((S, S), dtype=w.dtype,
                               device=w.device).bernoulli_(keep)
            w = w * (mask / keep)
        ctx = (w @ v).transpose(1, 2).reshape(bs, S, d)
        return self.out(ctx)


class _PositionTables(nn.Module):
    """Learned time and modality embeddings added to the token grid."""

    def __init__(self, d_model: int, time_len: int, n_modalities: int,
                 device=None):
        super().__init__()
        self.pos_time = nn.Parameter(
            torch.empty(time_len, 1, d_model, device=device))
        self.pos_modality = nn.Parameter(
            torch.empty(1, n_modalities, d_model, device=device))

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[bs, T, K, d] -> the [bs, T * K, d] tokens with the tables
        added."""
        bs, T, K, d = x.shape
        pos = (self.pos_time[:T] + self.pos_modality).reshape(1, T * K, d)
        return x.reshape(bs, T * K, d) + pos


class FusionBlock(nn.Module):
    """Pre-LN block: attention, then an exact-gelu MLP of width 4d
    (fusion.py:36-52)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads, dropout, device)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(d_model, 4 * d_model, device=device)
        self.fc2 = nn.Linear(4 * d_model, d_model, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop(self.attn(self.ln1(x)))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))
        return x + self.drop(h)


class TransformerFusion(_PositionTables):
    """Pre-LN transformer over the T * K token grid (fusion.py:55-80)."""

    def __init__(self, d_model: int, time_len: int, n_modalities: int = 3,
                 num_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.1, device=None):
        super().__init__(d_model, time_len, n_modalities, device)
        for i in range(num_layers):
            setattr(self, f"block_{i}",
                    FusionBlock(d_model, num_heads, dropout, device))
        self.num_layers = num_layers
        self.ln_out = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.tokens(x)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens)
        return self.ln_out(tokens).reshape(x.shape)


class TFNFusion(nn.Module):
    """Low-rank tensor fusion (fusion.py:83-111): per modality a Dense to
    ``rank`` factors of width d (its bias is classic TFN's constant-1
    channel), their elementwise product over the modalities summed over
    the rank, dropout, LayerNorm, broadcast over K."""

    def __init__(self, d_model: int, n_modalities: int = 3, rank: int = 8,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.rank = rank
        for k in range(n_modalities):
            setattr(self, f"factor_{k}",
                    nn.Linear(d_model, rank * d_model, device=device))
        self.drop = Dropout(dropout)
        self.ln_out = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, T, K, d = x.shape
        fused = None
        for k in range(K):
            f = getattr(self, f"factor_{k}")(x[:, :, k, :])
            f = f.reshape(bs, T, self.rank, d)
            fused = f if fused is None else fused * f
        fused = self.ln_out(self.drop(fused.sum(dim=2)))
        return fused[:, :, None, :].expand(bs, T, K, d)


class MoEBlock(nn.Module):
    """Pre-LN mixture-of-experts MLP block (fusion.py:114-159): a float32
    softmax router, the top-k experts' gates renormalised (+1e-9), tanh-gelu
    experts of width 2d in dense dispatch."""

    def __init__(self, d_model: int, num_experts: int, top_k: int,
                 dropout: float, device=None):
        super().__init__()
        E, d, h = num_experts, d_model, 2 * d_model
        self.top_k = top_k
        self.ln = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.router = nn.Linear(d, E, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(E, d, h, device=device))
        self.b1 = nn.Parameter(torch.empty(E, h, device=device))
        self.w2 = nn.Parameter(torch.empty(E, h, d, device=device))
        self.b2 = nn.Parameter(torch.empty(E, d, device=device))
        self.drop = Dropout(dropout)

    def gates(self, h: torch.Tensor) -> torch.Tensor:
        """[bs, S, E] gates: the router's probabilities on the top-k
        experts (lower index first on ties), renormalised; 0 elsewhere."""
        probs = torch.softmax(widen(self.router(h)), dim=-1)
        E = probs.shape[-1]
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        sel = F.one_hot(top[..., :self.top_k], E).to(probs.dtype).sum(dim=-2)
        gates = probs * sel
        return gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln(x)  # [bs, S, d]
        gates = self.gates(h)
        # expert parallelism (parallel/mesh.py): this rank holds E / M
        # experts; its gated sum is completed over `model`
        mesh = pmesh.mesh_of(self) if pmesh.shard_dim(self.w1) is not None else None
        axes = (pmesh.MODEL_AXIS,)
        if mesh is not None:
            gates = pmesh.split(gates, mesh, axes, gates.dim() - 1)
            h = pmesh.copy_to(h, mesh, axes)
        he = torch.einsum("bsd,edh->ebsh", h, self.w1) + self.b1[:, None, None]
        he = F.gelu(he, approximate="tanh")
        oe = torch.einsum("ebsh,ehd->ebsd", he, self.w2) + self.b2[:, None, None]
        out = torch.einsum("ebsd,bse->bsd", oe, gates.to(oe.dtype))
        if mesh is not None:
            out = pmesh.reduce_from(out, mesh, axes)
        return x + self.drop(out)


class MoEFusion(_PositionTables):
    """Attention for token mixing, then an MoE block, per layer, over the
    T * K token grid (fusion.py:162-198)."""

    def __init__(self, d_model: int, time_len: int, n_modalities: int = 3,
                 num_layers: int = 2, num_heads: int = 4,
                 num_experts: int = 4, top_k: int = 2, dropout: float = 0.1,
                 device=None):
        super().__init__(d_model, time_len, n_modalities, device)
        for i in range(num_layers):
            setattr(self, f"attn_ln_{i}",
                    nn.LayerNorm(d_model, eps=LN_EPS, device=device))
            setattr(self, f"attn_{i}",
                    MultiHeadAttention(d_model, num_heads, dropout, device))
            setattr(self, f"moe_{i}", MoEBlock(d_model, num_experts, top_k,
                                               dropout, device))
        self.num_layers = num_layers
        self.drop = Dropout(dropout)
        self.ln_out = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.tokens(x)
        for i in range(self.num_layers):
            h = getattr(self, f"attn_{i}")(getattr(self, f"attn_ln_{i}")(tokens))
            tokens = getattr(self, f"moe_{i}")(tokens + self.drop(h))
        return self.ln_out(tokens).reshape(x.shape)
