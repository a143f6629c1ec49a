"""The MIMRL model forward (PyTorch port of ``mimrl_tpu.models.model``,
``MimrlModel.__call__``, model.py:224-331): BERT text tower, bi-GRU
audio/video encoders, CubeMLP fusion and the classifier.

Sub-module names are the reference torch ``Model``'s (``bertmodel``,
``W_t``, ``rnn_a``, ``ln_a``, ``mlp_encoder``, ``classifier``, ...), so
the state_dict keys are the reference's names.

Ported in this slice: ``encoders='gru'``, ``fusion='cubemlp'``. The
``vmi_*``/``vcmi_*`` estimator bank is only used by training and is not
built yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.device import compute_dtype
from mimrl_tpu_torch.models.bert import BertConfig, BertModel
from mimrl_tpu_torch.models.cubemlp import AxisLayerNorm, MLPEncoder
from mimrl_tpu_torch.models.encoders import BiRnnEncoder, lengths_from_sequence


def get_output_dim(features_compose_t: str, features_compose_k: str,
                   d_out: int, t_out: int, k_out: int) -> int:
    """Classifier input width (ref: Model.py:12-27)."""
    if features_compose_k in ("mean", "sum"):
        classify_dim = d_out
    elif features_compose_k == "cat":
        classify_dim = d_out * k_out
    else:
        raise NotImplementedError(features_compose_k)
    if features_compose_t == "cat":
        classify_dim = classify_dim * t_out
    elif features_compose_t not in ("mean", "sum"):
        raise NotImplementedError(features_compose_t)
    return classify_dim


def _compose(x: torch.Tensor, how: str, dim: int) -> torch.Tensor:
    if how == "mean":
        return x.mean(dim=dim)
    if how == "sum":
        return x.sum(dim=dim)
    return torch.cat(x.unbind(dim=dim), dim=-1)  # cat


class MimrlModel(nn.Module):
    def __init__(self, d_a: int, d_v: int, d_common: int = 128,
                 encoders: str = "gru", features_compose_t: str = "mean",
                 features_compose_k: str = "mean", num_class: int = 1,
                 activate: str = "gelu", time_len: int = 100,
                 d_hiddens: Sequence[Sequence[int]] = ((10, 2, 128), (5, 2, 128)),
                 d_outs: Sequence[Sequence[int]] = ((10, 2, 128), (5, 2, 128)),
                 dropout_mlp: Sequence[float] = (0.5, 0.5, 0.5),
                 dropout: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
                 bias: bool = False, ln_first: bool = False,
                 res_project: Sequence[bool] = (True, True),
                 use_pallas: bool = False, fusion: str = "cubemlp",
                 bert_config: BertConfig = BertConfig(), device=None):
        super().__init__()
        if fusion != "cubemlp":
            raise NotImplementedError(
                f"fusion {fusion!r}: only CubeMLP is ported (ROADMAP.md)")
        self.time_len = time_len
        self.features_compose_t = features_compose_t
        self.features_compose_k = features_compose_k

        self.bertmodel = BertModel(bert_config, device)
        # projector (no bias, ref: Model.py:264)
        self.W_t = nn.Linear(bert_config.hidden_size, d_common, bias=False,
                             device=device)
        # 2-layer bidirectional GRU (ref: Model.py:254-255)
        self.rnn_a = BiRnnEncoder(encoders, d_a, d_common, 2, device)
        self.rnn_v = BiRnnEncoder(encoders, d_v, d_common, 2, device)
        self.ln_a = nn.LayerNorm(d_common, eps=1e-6, device=device)
        self.ln_v = nn.LayerNorm(d_common, eps=1e-6, device=device)
        self.dropout_t = nn.Dropout(dropout[0])
        self.dropout_a = nn.Dropout(dropout[1])
        self.dropout_v = nn.Dropout(dropout[2])
        self.mlp_encoder = MLPEncoder(
            activate, (time_len, 3, d_common), d_hiddens, d_outs,
            dropout_mlp, bias, ln_first, res_project, use_pallas, device)

        t_out, k_out, d_out = d_outs[-1]
        self.classify_dim = get_output_dim(
            features_compose_t, features_compose_k, d_out, t_out, k_out)
        if self.classify_dim <= 128:
            self.classifier = nn.Linear(self.classify_dim, num_class,
                                        device=device)
        else:
            self.classifier_hidden = nn.Linear(self.classify_dim, 128,
                                               device=device)
            self.classifier_dropout = nn.Dropout(dropout[3])
            self.classifier = nn.Linear(128, num_class, device=device)

    def forward(self, bert_sentences, bert_sentence_types,
                bert_sentence_att_mask, a, v, return_features: bool = True):
        """Token ids/types/mask [bs, T] int, a [bs, T, d_a], v [bs, T, d_v].
        Returns (out, F_F, T_F, A_F, V_F), or (out,) without features."""
        T = self.time_len
        t = self.bertmodel(bert_sentences, bert_sentence_types,
                           bert_sentence_att_mask)
        t = self.W_t(t)

        # lengths from non-zero rows, clamped to >=1 (ref: Model.py:425-432)
        a = self.rnn_a(a, lengths_from_sequence(a))
        v = self.rnn_v(v, lengths_from_sequence(v))
        a = F.relu(self.ln_a(a))
        v = F.relu(self.ln_v(v))

        t = self.dropout_t(t)
        a = self.dropout_a(a)
        v = self.dropout_v(v)

        # summary features = time-mean (ref: Model.py:466)
        T_F, A_F, V_F = t.mean(dim=1), a.mean(dim=1), v.mean(dim=1)

        if not t.shape[1] == a.shape[1] == v.shape[1] == T:
            raise ValueError(f"inputs must be padded to time_len={T}")
        x = torch.stack([t, a, v], dim=2)  # [bs, T, 3, d_common]
        x = self.mlp_encoder(x)

        # compose over k then t (ref: Model.py:489-507)
        fused = _compose(_compose(x, self.features_compose_k, 2),
                         self.features_compose_t, 1)

        if self.classify_dim <= 128:
            out = self.classifier(fused)
        else:
            h = F.relu(self.classifier_hidden(fused))
            out = self.classifier(self.classifier_dropout(h))
        if return_features:
            return out, fused, T_F, A_F, V_F
        return (out,)


def bert_config_from(cfg: MimrlConfig, vocab_size: int) -> BertConfig:
    """The BERT tower's config for a run (as the JAX Solver builds it)."""
    return BertConfig(
        vocab_size=max(vocab_size, 64),
        hidden_size=cfg.bert_hidden,
        num_hidden_layers=cfg.bert_layers,
        num_attention_heads=cfg.bert_heads,
        intermediate_size=cfg.bert_intermediate or cfg.bert_hidden * 4,
        max_position_embeddings=max(512, cfg.time_len),
        hidden_dropout_prob=cfg.bert_dropout,
        attention_probs_dropout_prob=cfg.bert_dropout,
        dtype=compute_dtype(cfg.compute_dtype),
        quant=cfg.quant,
        flash_attn=cfg.flash_attn,
    )


def build_model(cfg: MimrlConfig, vocab_size: int, d_a: int, d_v: int,
                device=None) -> MimrlModel:
    """A MimrlModel for a run config, with uninitialised storage on
    ``device`` (load a state_dict or call ``init_weights`` next)."""
    with torch.device("meta"):
        model = MimrlModel(
            d_a=d_a, d_v=d_v, d_common=cfg.d_common, encoders=cfg.encoders,
            features_compose_t=cfg.features_compose_t,
            features_compose_k=cfg.features_compose_k,
            num_class=cfg.num_class, activate=cfg.activate,
            time_len=cfg.time_len,
            d_hiddens=tuple(map(tuple, cfg.d_hiddens)),
            d_outs=tuple(map(tuple, cfg.d_outs)),
            dropout_mlp=tuple(cfg.dropout_mlp), dropout=tuple(cfg.dropout),
            bias=cfg.bias, ln_first=cfg.ln_first,
            res_project=tuple(cfg.res_project), use_pallas=cfg.use_pallas,
            fusion=cfg.fusion, bert_config=bert_config_from(cfg, vocab_size))
    return model.to_empty(device=device or "cpu")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init drawn from ``generator`` (a CPU generator, so
    the weights do not depend on the device): Linear weights normal with
    std 1/sqrt(fan_in) and zero bias; embeddings normal with std 0.02;
    LayerNorms ones/zeros; GRU weights uniform in +-1/sqrt(hidden)."""

    def fill(p, draw):
        p.copy_(draw(torch.empty(p.shape, dtype=p.dtype)))

    for m in model.modules():
        if isinstance(m, nn.Linear):
            fill(m.weight, lambda t: t.normal_(
                0.0, 1.0 / math.sqrt(m.in_features), generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            fill(m.weight, lambda t: t.normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, (nn.LayerNorm, AxisLayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                fill(p, lambda t: t.uniform_(-bound, bound,
                                             generator=generator))
    return model
