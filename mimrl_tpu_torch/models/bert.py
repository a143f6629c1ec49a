"""BERT text tower (PyTorch port of ``mimrl_tpu.models.bert``).

Parameter names are HuggingFace's ``BertModel`` names
(``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ...), so a HF
state_dict loads as it is. The forward computes the three attention
projections as one fused QKV matmul over the concatenated weights, as
``bert.py:156-157`` does.

Dtype policy (``BertConfig.dtype``): parameters stay float32; embedding
lookups and the inputs of every matmul are cast to the compute dtype;
LayerNorm and softmax run in float32; the tower returns float32.

Attention has two routes, chosen by ``resolve_flash``: on a CUDA tensor
``flash_attn`` 'on' or 'auto' launches the hand-written kernel
(``ops/flash_attention.py``); otherwise the plain version runs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # matmul compute dtype; params stay float32, LayerNorm/softmax float32
    dtype: torch.dtype = torch.float32
    # only 'none' is ported: the int8 GEMM kernel waits (ROADMAP.md)
    quant: str = "none"
    # 'on' | 'off' | 'auto' (= on for CUDA tensors, off on the CPU)
    flash_attn: str = "auto"

    @classmethod
    def tiny(cls) -> "BertConfig":
        """Small config for tests."""
        return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=64)


def resolve_flash(c: BertConfig, device: torch.device) -> bool:
    """Whether attention launches the CUDA kernel (bert.py:122-140)."""
    if c.flash_attn not in ("auto", "on", "off"):
        raise ValueError(
            f"BertConfig.flash_attn={c.flash_attn!r} (want auto|on|off)")
    return c.flash_attn != "off" and device.type == "cuda"


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """LayerNorm in float32, result cast back to the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.config = c
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids):
        dt = self.config.dtype
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos_ids)[None].to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        return self.dropout(_layer_norm(self.LayerNorm, x, dt))


class BertSelfAttention(nn.Module):
    """HF's ``attention.self``: query, key, value projections."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        H = c.hidden_size
        self.query = nn.Linear(H, H, device=device)
        self.key = nn.Linear(H, H, device=device)
        self.value = nn.Linear(H, H, device=device)


class BertSelfOutput(nn.Module):
    """HF's ``attention.output`` / ``output``: dense + LayerNorm."""

    def __init__(self, d_in: int, c: BertConfig, device=None):
        super().__init__()
        self.dense = nn.Linear(d_in, c.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, h, residual, dtype):
        h = self.dropout(_linear(self.dense, h, dtype))
        return _layer_norm(self.LayerNorm, h + residual, dtype)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.config = c
        self.self = BertSelfAttention(c, device)
        self.output = BertSelfOutput(c.hidden_size, c, device)

    def forward(self, x, attn_bias):
        c = self.config
        bs, T, H = x.shape
        nh = c.num_attention_heads
        hd = H // nh
        s = self.self
        # fused QKV projection: one [H, 3H] matmul instead of three
        w = torch.cat([s.query.weight, s.key.weight, s.value.weight])
        b = torch.cat([s.query.bias, s.key.bias, s.value.bias])
        qkv = F.linear(x.to(c.dtype), w.to(c.dtype), b.to(c.dtype))
        q, k, v = (y.reshape(bs, T, nh, hd).transpose(1, 2).contiguous()
                   for y in qkv.split(H, dim=-1))
        if self.training and c.attention_probs_dropout_prob > 0.0:
            raise NotImplementedError(
                "BERT attention dropout in training mode belongs to the "
                "training slice (ROADMAP.md); call model.eval() to serve")
        if resolve_flash(c, x.device):
            ctx = flash_attention(q, k, v, attn_bias)
        else:
            ctx = flash_attention_plain(q, k, v, attn_bias)
        ctx = ctx.transpose(1, 2).reshape(bs, T, H).to(c.dtype)
        return self.output(ctx, x, c.dtype)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size,
                               device=device)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.config = c
        self.attention = BertAttention(c, device)
        self.intermediate = BertIntermediate(c, device)
        self.output = BertSelfOutput(c.intermediate_size, c, device)

    def forward(self, x, attn_bias):
        dt = self.config.dtype
        x = self.attention(x, attn_bias)
        h = F.gelu(_linear(self.intermediate.dense, x, dt), approximate="none")
        return self.output(h, x, dt)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            [BertLayer(c, device) for _ in range(c.num_hidden_layers)])


class BertModel(nn.Module):
    """Returns last_hidden_state [bs, T, hidden] in float32."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        if c.quant != "none":
            raise NotImplementedError(
                f"BertConfig.quant={c.quant!r}: the int8 GEMM kernel is not "
                "ported yet (ROADMAP.md)")
        self.config = c
        self.embeddings = BertEmbeddings(c, device)
        self.encoder = BertEncoder(c, device)

    def forward(self, input_ids, token_type_ids, attention_mask):
        x = self.embeddings(input_ids, token_type_ids)
        # additive bias in float32: 0 for valid keys, -1e9 for padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        return x.float()
