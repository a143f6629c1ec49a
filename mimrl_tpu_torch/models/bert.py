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

Quantisation (``BertConfig.quant``: none | int8_fwd | int8 | int8_all):
with a mode other than 'none' the four dense products of a layer (fused
QKV, attention output, FFN up and down) go through
``ops/quant.py::quant_linear``: operands quantised to int8 on the fly and
multiplied by the hand-written int8 GEMM kernel on a CUDA tensor (its plain
version on a CPU tensor), four launches per layer and forward. Parameter
names and shapes are the same for every mode.

Attention has two routes. ``flash_attn`` 'on' or 'auto' goes through
``ops/flash_attention.py::flash_attention``: on a CUDA tensor it launches
the hand-written forward kernel, and the backward kernel when a gradient
is taken; on a CPU tensor the same wrapper runs the kernels' plain
versions. ``flash_attn`` 'off' runs the plain forward under
autograd. In training mode with a positive attention dropout rate a seed
is drawn from the caller's generator on the inputs' device (no host
round trip) and both routes build the same Philox mask from it, as
``mimrl_tpu/models/bert.py:158-173`` draws a seed for its kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from mimrl_tpu_torch.ops.quant import MODES, quant_linear


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
    # 'none' | 'int8_fwd' | 'int8' | 'int8_all' (ops/quant.py)
    quant: str = "none"
    # 'on' | 'off' | 'auto' (= on for CUDA tensors, off on the CPU)
    flash_attn: str = "auto"

    @classmethod
    def tiny(cls) -> "BertConfig":
        """Small config for tests."""
        return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=64)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """LayerNorm in float32, result cast back to the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           c: "BertConfig") -> torch.Tensor:
    """``x @ weight.T + bias`` in the compute dtype, or through the int8
    product when the config quantises."""
    if c.quant != "none":
        return quant_linear(x.to(c.dtype), weight, bias, c.quant, c.dtype)
    return F.linear(x.to(c.dtype), weight.to(c.dtype), bias.to(c.dtype))



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
             + _rows_in_fixed_order(self.token_type_embeddings.weight,
                                    token_type_ids).to(dt))
        return self.dropout(_layer_norm(self.LayerNorm, x, dt))


def _rows_in_fixed_order(table: torch.Tensor, ids: torch.Tensor
                         ) -> torch.Tensor:
    """``table[ids]`` (the values of an embedding lookup) as a chain of
    ``torch.where`` over the table's few rows, so that the backward sums
    each row's gradient by a reduction of fixed order. The CUDA embedding
    backward sums the positions of one index (all 12,800 of a batch, for
    the token types) in an order that changes from run to run, and a
    float32 run then does not repeat on the card."""
    out = table[0].expand(*ids.shape, table.shape[1])
    for row in range(1, table.shape[0]):
        out = torch.where((ids == row)[..., None], table[row], out)
    return out


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
        self.config = c
        self.dense = nn.Linear(d_in, c.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, h, residual):
        c = self.config
        h = self.dropout(_dense(h, self.dense.weight, self.dense.bias, c))
        return _layer_norm(self.LayerNorm, h + residual, c.dtype)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.config = c
        self.self = BertSelfAttention(c, device)
        self.output = BertSelfOutput(c.hidden_size, c, device)

    def forward(self, x, attn_bias, generator=None):
        c = self.config
        bs, T, H = x.shape
        nh = c.num_attention_heads
        hd = H // nh
        s = self.self
        # fused QKV projection: one [H, 3H] matmul instead of three (and, when
        # quantised, one [H, 3H] matrix with per-column scales)
        w = torch.cat([s.query.weight, s.key.weight, s.value.weight])
        b = torch.cat([s.query.bias, s.key.bias, s.value.bias])
        qkv = _dense(x, w, b, c)
        q, k, v = (y.reshape(bs, T, nh, hd).transpose(1, 2).contiguous()
                   for y in qkv.split(H, dim=-1))
        p_rate = float(c.attention_probs_dropout_prob)
        if self.training and p_rate > 0.0:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), device=x.device,
                                 generator=generator)
        else:
            seed, p_rate = None, 0.0
        if c.flash_attn not in ("auto", "on", "off"):
            raise ValueError(
                f"BertConfig.flash_attn={c.flash_attn!r} (want auto|on|off)")
        if c.flash_attn != "off":
            ctx = flash_attention(q, k, v, attn_bias, seed, p_rate)
        else:
            ctx = flash_attention_plain(q, k, v, attn_bias, seed, p_rate)
        ctx = ctx.transpose(1, 2).reshape(bs, T, H).to(c.dtype)
        return self.output(ctx, x)


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

    def forward(self, x, attn_bias, generator=None):
        x = self.attention(x, attn_bias, generator)
        up = self.intermediate.dense
        h = F.gelu(_dense(x, up.weight, up.bias, self.config),
                   approximate="none")
        return self.output(h, x)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            [BertLayer(c, device) for _ in range(c.num_hidden_layers)])


class BertModel(nn.Module):
    """Returns last_hidden_state [bs, T, hidden] in float32. ``generator``
    (on the inputs' device) feeds the attention dropout seeds in training
    mode; hidden dropout is ``nn.Dropout`` and draws from the device's
    default generator."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        if c.quant not in MODES:
            raise ValueError(f"BertConfig.quant={c.quant!r} (want one of "
                             f"{MODES})")
        self.config = c
        self.embeddings = BertEmbeddings(c, device)
        self.encoder = BertEncoder(c, device)

    def forward(self, input_ids, token_type_ids, attention_mask,
                generator=None):
        x = self.embeddings(input_ids, token_type_ids)
        # additive bias in float32: 0 for valid keys, -1e9 for padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, attn_bias, generator)
        return x.float()


def load_bert_weights(path: str, model: BertModel) -> None:
    """Load pretrained weights into ``model`` in place (the counterpart of
    ``mimrl_tpu/models/bert.py::load_bert_weights``):

    - an ``.npz`` of flattened flax keys (``layer_0/attention/qkv/kernel``)
      goes through ``models/convert.py::state_dict_from_jax``;
    - anything else is a torch file in HuggingFace's layout (a
      ``pytorch_model.bin``), read with ``torch.load(weights_only=True)``;
      each tensor is found by its name here or with the ``bert.`` prefix,
      and every other key (the pooler, task heads, ``position_ids``) is
      ignored, as the JAX package's ``convert_hf_torch_state_dict`` does.

    A tensor that the model needs and the file lacks raises, and so does
    one of another shape.
    """
    if path.endswith(".npz"):
        tree: dict = {}
        with np.load(path) as flat:
            for key in flat.files:
                node = tree
                *parents, leaf = key.split("/")
                for k in parents:
                    node = node.setdefault(k, {})
                node[leaf] = flat[key]
        prefixed = state_dict_from_jax(
            {"bertmodel": tree}, nn.ModuleDict({"bertmodel": model}))
        state = {k[len("bertmodel."):]: v for k, v in prefixed.items()}
    else:
        found = torch.load(path, map_location="cpu", weights_only=True)
        state = {}
        for name, dst in model.state_dict().items():
            src = next((found[c] for c in (name, "bert." + name)
                        if c in found), None)
            if src is None:
                raise KeyError(f"{path}: no tensor {name} (nor bert.{name})")
            if src.shape != dst.shape:
                raise ValueError(f"{path}: {name} has shape "
                                 f"{tuple(src.shape)}, the model "
                                 f"{tuple(dst.shape)}")
            state[name] = src
    model.load_state_dict(state, strict=True)
