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
``mimrl_tpu/models/bert.py:158-173`` draws a seed for its kernel; on a
data-parallel mesh the mask's batch rows are the rank's global rows.

On a mesh with a ``model`` axis (``parallel/mesh.py``) the four dense
kernels hold column blocks (tensor parallelism). Under ``--seq_shard``
(``Mesh.seq_shard``) the tower runs sequence parallel: the embeddings,
LayerNorms, hidden dropouts and residual adds on this rank's time slice,
the sequence gathered before the fused QKV and the FFN up-projection
(this rank's heads and hidden units), the attention output dense and the
FFN down-projection on row blocks with their partial sums
reduce-scattered back to the slice; attention takes the plain route with
this rank's heads, its dropout the heads' rows of the whole mask
(``head0``), and the output is gathered whole at the end. On a ``pipe`` axis
``parallel/pipeline.py`` runs the layers in stages over microbatches: it
draws each layer's attention seed once per forward (``attention_seed``,
in layer order, as this module draws them) and hands it to the layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.device import widen
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from mimrl_tpu_torch.ops.quant import MODES, quant_linear
from mimrl_tpu_torch.parallel import mesh as pmesh
from mimrl_tpu_torch.parallel.mesh import Dropout


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
    return F.layer_norm(widen(x), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           c: "BertConfig", mesh=None, parts: int = 1) -> torch.Tensor:
    """``x @ weight.T + bias`` in the compute dtype, or through the int8
    product when the config quantises. Tensor-parallel (``mesh``: ``weight``
    holds this rank's block of the output rows, ``parallel/mesh.py``): the
    product runs on the block, its output columns (``parts`` concatenated
    outputs: 3 for the fused QKV) are gathered over ``model`` and the whole
    bias is added after."""
    if mesh is None:
        if c.quant != "none":
            return quant_linear(x.to(c.dtype), weight, bias, c.quant, c.dtype)
        return F.linear(x.to(c.dtype), weight.to(c.dtype), bias.to(c.dtype))
    x = pmesh.copy_to(x.to(c.dtype), mesh, (pmesh.MODEL_AXIS,))
    if c.quant != "none":
        y = quant_linear(x, weight, None, c.quant, c.dtype)
    else:
        y = F.linear(x, weight.to(c.dtype))
    return pmesh.gather_columns(y, mesh, parts) + bias.to(c.dtype)


def _tp(module: nn.Module, weight: torch.Tensor):
    """The mesh when ``weight`` holds this rank's block of its output rows
    (tensor parallelism, ``parallel/mesh.py::shard_params``), else None."""
    return pmesh.mesh_of(module) if pmesh.shard_dim(weight) is not None else None


def _part(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` under ``--seq_shard``: the
    block ``shard_params`` holds, or a view of the whole parameter (whose
    gradient is then this rank's part, summed over ``model``)."""
    if pmesh.shard_dim(t) == dim:
        return t
    n = mesh.shape[pmesh.MODEL_AXIS]
    block = t.shape[dim] // n
    return t.narrow(dim, mesh.coords[pmesh.MODEL_AXIS] * block, block)


class _PartialSums(torch.autograd.Function):
    """``h @ w.T`` of low-precision ``h`` and ``w`` (cast to ``h``'s
    dtype) accumulated and returned in float32: a row-parallel product's
    partial sums, which ``seq_scatter`` adds in float32 before the one
    rounding that the unsharded product makes. On the card ``torch.mm``'s
    ``out_dtype``; on the CPU the float32 product of the same values (the
    products of two bf16 values are exact in float32). The backward is the
    unsharded product's own, in ``h``'s dtype."""

    @staticmethod
    def forward(ctx, h, w):
        wd = w.to(h.dtype)
        ctx.save_for_backward(h, wd)
        ctx.w_dtype = w.dtype
        h2 = h.reshape(-1, h.shape[-1])
        if h.is_cuda:
            out = torch.mm(h2, wd.t(), out_dtype=torch.float32)
        else:
            out = torch.mm(widen(h2), widen(wd).t())
        return out.reshape(*h.shape[:-1], wd.shape[0])

    @staticmethod
    def backward(ctx, g):
        h, wd = ctx.saved_tensors
        gd = g.to(h.dtype)
        gw = gd.reshape(-1, gd.shape[-1]).t().mm(h.reshape(-1, h.shape[-1]))
        return gd.matmul(wd), gw.to(ctx.w_dtype)


def _partial_sums(h: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """This rank's partial sums of a row-parallel product in float32 (the
    unsharded product accumulates the whole input axis in float32 and
    rounds once): ``_PartialSums`` in a low-precision ``dtype``, else the
    float32 product."""
    h = h.to(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return _PartialSums.apply(h, w)
    return F.linear(widen(h), widen(w.to(dtype)))


def _check_seq(c: "BertConfig", mesh) -> None:
    n = mesh.shape[pmesh.MODEL_AXIS]
    for what, size in (("attention heads", c.num_attention_heads),
                       ("intermediate units", c.intermediate_size)):
        if size % n:
            raise ValueError(f"--seq_shard: {size} {what} do not split "
                             f"over {n} ranks of model")


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
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, time=None):
        """``time``: (first step, whole length) of a time slice
        (``--seq_shard``): the slice's steps are embedded."""
        dt = self.config.dtype
        t0 = 0
        if time is not None:
            t0, steps = time[0], input_ids.shape[1] // (
                self.mesh.shape[pmesh.MODEL_AXIS])
            input_ids = input_ids[:, t0:t0 + steps]
            token_type_ids = token_type_ids[:, t0:t0 + steps]
        pos_ids = torch.arange(t0, t0 + input_ids.shape[1],
                               device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos_ids)[None].to(dt)
             + _rows_in_fixed_order(self.token_type_embeddings.weight,
                                    token_type_ids).to(dt))
        return self.dropout(_layer_norm(self.LayerNorm, x, dt), time=time)


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


def attention_seed(generator, device) -> torch.Tensor:
    """One layer's attention dropout seed, drawn from ``generator`` on
    ``device`` (no host round trip)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), device=device,
                         generator=generator)


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
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, h, residual, time=None):
        """``time`` (``--seq_shard``): ``h`` holds this rank's heads or
        hidden units over the whole sequence, ``residual`` the time slice;
        the row-parallel product's partial sums are reduce-scattered to
        the slice."""
        c = self.config
        if time is not None:
            mesh = self.mesh
            part = _partial_sums(h, _part(self.dense.weight, mesh, 1), c.dtype)
            # the bias joins the first rank's partial sums before the one
            # rounding, as the unsharded product adds it before its own;
            # its gradient (the whole sequence's) is then rounded once too
            first = float(mesh.coords[pmesh.MODEL_AXIS] == 0)
            bias = widen(self.dense.bias.to(c.dtype)) * first
            h = self.dropout(pmesh.seq_scatter(part + bias, mesh).to(c.dtype),
                             time=time)
        else:
            h = self.dropout(_dense(h, self.dense.weight, self.dense.bias, c,
                                    _tp(self, self.dense.weight)))
        return _layer_norm(self.LayerNorm, h + residual, c.dtype)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.config = c
        self.self = BertSelfAttention(c, device)
        self.output = BertSelfOutput(c.hidden_size, c, device)

    def forward(self, x, attn_bias, generator=None, seed=None, time=None):
        """``seed``: the layer's attention seed drawn already (the
        pipeline's), else one is drawn from ``generator``. ``time``
        (``--seq_shard``): ``x`` is this rank's time slice, gathered for
        the fused QKV of this rank's heads."""
        c = self.config
        bs, T, H = x.shape
        nh = c.num_attention_heads
        hd = H // nh
        s = self.self
        # fused QKV projection: one [H, 3H] matmul instead of three (and, when
        # quantised, one [H, 3H] matrix with per-column scales)
        head0 = 0
        if time is not None:
            mesh = self.mesh
            nh //= mesh.shape[pmesh.MODEL_AXIS]
            head0 = mesh.coords[pmesh.MODEL_AXIS] * nh
            T, H = time[1], nh * hd
            w = torch.cat([_part(l.weight, mesh, 0)
                           for l in (s.query, s.key, s.value)])
            b = torch.cat([_part(l.bias, mesh, 0)
                           for l in (s.query, s.key, s.value)])
            qkv = F.linear(pmesh.seq_gather(x.to(c.dtype), mesh),
                           w.to(c.dtype), b.to(c.dtype))
        else:
            w = torch.cat([s.query.weight, s.key.weight, s.value.weight])
            b = torch.cat([s.query.bias, s.key.bias, s.value.bias])
            qkv = _dense(x, w, b, c, _tp(self, s.query.weight), parts=3)
        q, k, v = (y.reshape(bs, T, nh, hd).transpose(1, 2).contiguous()
                   for y in qkv.split(H, dim=-1))
        p_rate = float(c.attention_probs_dropout_prob)
        if self.training and p_rate > 0.0:
            if seed is None:
                seed = attention_seed(generator, x.device)
        else:
            seed, p_rate = None, 0.0
        if c.flash_attn not in ("auto", "on", "off"):
            raise ValueError(
                f"BertConfig.flash_attn={c.flash_attn!r} (want auto|on|off)")
        row0 = pmesh.attention_batch_offset(self)
        if c.flash_attn != "off" and time is None:
            ctx = flash_attention(q, k, v, attn_bias, seed, p_rate, row0)
        else:
            ctx = flash_attention_plain(q, k, v, attn_bias, seed, p_rate,
                                        row0, head0)
        ctx = ctx.transpose(1, 2).reshape(bs, T, H).to(c.dtype)
        return self.output(ctx, x, time)


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

    def forward(self, x, attn_bias, generator=None, seed=None, time=None):
        x = self.attention(x, attn_bias, generator, seed, time)
        up = self.intermediate.dense
        c = self.config
        if time is not None:  # this rank's hidden units, the whole sequence
            mesh = self.mesh
            h = F.linear(pmesh.seq_gather(x.to(c.dtype), mesh),
                         _part(up.weight, mesh, 0).to(c.dtype),
                         _part(up.bias, mesh, 0).to(c.dtype))
        else:
            h = _dense(x, up.weight, up.bias, c, _tp(self, up.weight))
        return self.output(F.gelu(h, approximate="none"), x, time)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            [BertLayer(c, device) for _ in range(c.num_hidden_layers)])


class BertModel(nn.Module):
    """Returns last_hidden_state [bs, T, hidden] in float32. ``generator``
    (on the inputs' device) feeds the attention dropout seeds in training
    mode; hidden dropout (``parallel/mesh.py::Dropout``) draws from the
    device's default generator."""

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
        mesh = pmesh.mesh_of(self)
        time = None
        if mesh is not None and mesh.seq_shard:  # --seq_shard
            _check_seq(self.config, mesh)
            time = (pmesh.time_slice(mesh, input_ids.shape[1])[0],
                    input_ids.shape[1])
        x = self.embeddings(input_ids, token_type_ids, time)
        # additive bias in float32: 0 for valid keys, -1e9 for padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, attn_bias, generator, time=time)
        if time is not None:
            x = pmesh.gather(x, mesh, (pmesh.MODEL_AXIS,), 1)
        return widen(x)


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
