"""The MIMRL model (PyTorch port of ``mimrl_tpu.models.model``): the
text tower (BERT over token ids, or dense text features with no BERT),
the audio/video encoders (2-layer bi-GRU, 1-layer bi-LSTM or Conv1d),
the fusion encoder (CubeMLP, or ``models/fusion.py``'s transformer, TFN or
MoE) and the classifier (``MimrlModel.__call__``,
model.py:224-331), plus the embedded MI / conditional-MI estimator bank
and the two stage losses (model.py:197-219, :336-448).

Sub-module names are the reference torch ``Model``'s (``bertmodel``,
``W_t``, ``rnn_a`` or ``conv_a``, ``ln_a``, ``mlp_encoder`` (whichever
fusion it is), ``classifier``,
``vmi_estimator_f_t``, ``vcmi_estimator_ac_t``, ...), so the state_dict
keys are the reference's names and the optimizer's name-based split
('bert' / 'vmi' / 'vcmi' / rest) works on them.

Ported: every encoder and every fusion, and both execution-order flags
of the JAX package:

- ``fused_estimators`` (model.py:339-425): the estimators whose parameters
  have equal shapes run as one batched pass (``mi/estimators.py``'s
  ``batched_vmi`` / ``batched_vcmi``). The five VMI estimators form one
  group when the fused features are ``d_common`` wide, else ``{f_t, f_a,
  f_v}`` and ``{t_a, t_v}``; the six classifiers always form one group.
  CLUB runs one estimator after the other, as in JAX (:344). Off, all
  eleven run one after the other.
- ``fused_av_scan`` (model.py:268-277): the audio and video recurrences on
  two CUDA streams (``encoders.run_pair``); on the CPU one after the
  other.

Both change the order of the same math, not the parameters or their names.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.device import compute_dtype
from mimrl_tpu_torch.mi.estimators import (VCMIEstimator, VMIEstimator,
                                           batched_vcmi, batched_vmi)
from mimrl_tpu_torch.models.bert import BertConfig, BertModel
from mimrl_tpu_torch.models.cubemlp import AxisLayerNorm, MLPEncoder
from mimrl_tpu_torch.models.encoders import (BiRnnEncoder, ConvEncoder,
                                             lengths_from_sequence, run_pair)
from mimrl_tpu_torch.models.fusion import (MoEBlock, MoEFusion, TFNFusion,
                                           TransformerFusion)
from mimrl_tpu_torch.parallel.mesh import (PIPE_AXIS, Dropout, gather_rows,
                                           mesh_of)
from mimrl_tpu_torch.parallel.pipeline import bert_forward_pipelined


# Estimator hyperparameters hard-coded by the reference (ref: Model.py:285-286)
EST_HIDDEN_DIM = 256
EST_EMBED_DIM = 128
EST_LAYERS = 2
EST_ACTIVATION = "relu"
EST_MU, EST_RHO = 0.0, 1.0

# a batch's model inputs: BERT's three (raw text) or "text" (dense text)
MODEL_INPUTS = ("bert_sentences", "bert_sentence_types",
                "bert_sentence_att_mask", "audio", "video", "text")
VMI_KEYS = ("f_t", "f_a", "f_v", "t_a", "t_v")
CMI_KEYS = ("ac_t", "ta_c", "vc_t", "tv_c", "tc_a", "tc_v")


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


def _groups_by_shape(model: nn.Module, prefix: str,
                     keys: Sequence[str]) -> list:
    """The keys whose modules ``{prefix}{key}`` have parameters of equal
    names and shapes, grouped in key order."""
    groups: Dict[tuple, list] = {}
    for key in keys:
        shapes = tuple((name, tuple(p.shape)) for name, p in getattr(
            model, prefix + key).named_parameters())
        groups.setdefault(shapes, []).append(key)
    return list(groups.values())


class MimrlModel(nn.Module):
    def __init__(self, d_a: int, d_v: int, d_common: int = 128,
                 d_t: int = 768, raw_text: bool = True,
                 encoders: str = "gru", features_compose_t: str = "mean",
                 features_compose_k: str = "mean", num_class: int = 1,
                 activate: str = "gelu", time_len: int = 100,
                 d_hiddens: Sequence[Sequence[int]] = ((10, 2, 128), (5, 2, 128)),
                 d_outs: Sequence[Sequence[int]] = ((10, 2, 128), (5, 2, 128)),
                 dropout_mlp: Sequence[float] = (0.5, 0.5, 0.5),
                 dropout: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
                 bias: bool = False, ln_first: bool = False,
                 res_project: Sequence[bool] = (True, True),
                 critic_type: str = "separate", baseline_type: str = "constant",
                 bound_type: str = "infonce", k_neighbor: int = 2,
                 radius: float = 1.0, cmi_last_acticate: str = "sigmoid",
                 use_pallas: bool = False, fused_estimators: bool = False,
                 fused_av_scan: bool = False, fusion: str = "cubemlp",
                 fusion_layers: int = 2, fusion_heads: int = 4,
                 moe_experts: int = 4, moe_topk: int = 2,
                 bert_config: BertConfig = BertConfig(), device=None):
        super().__init__()
        self.time_len = time_len
        self.d_common = d_common
        self.k_neighbor = k_neighbor
        self.radius = radius
        self.features_compose_t = features_compose_t
        self.features_compose_k = features_compose_k
        self.encoders = encoders
        self.raw_text = raw_text
        self.bound_type = bound_type
        self.fused_estimators = fused_estimators
        self.fused_av_scan = fused_av_scan

        # raw text: BERT over the token ids; dense text (glove etc.) goes
        # to the projector directly and no BERT exists (model.py:235-254)
        if raw_text:
            self.bertmodel = BertModel(bert_config, device)
            d_t = bert_config.hidden_size
        # projector (no bias, ref: Model.py:264)
        self.W_t = nn.Linear(d_t, d_common, bias=False, device=device)
        if encoders == "conv":  # ref: Model.py:248-249
            self.conv_a = ConvEncoder(d_a, d_common, device)
            self.conv_v = ConvEncoder(d_v, d_common, device)
        else:
            # 2-layer bidirectional GRU or 1-layer bidirectional LSTM
            # (ref: Model.py:251-255)
            layers = 1 if encoders == "lstm" else 2
            self.rnn_a = BiRnnEncoder(encoders, d_a, d_common, layers, device)
            self.rnn_v = BiRnnEncoder(encoders, d_v, d_common, layers, device)
        self.ln_a = nn.LayerNorm(d_common, eps=1e-6, device=device)
        self.ln_v = nn.LayerNorm(d_common, eps=1e-6, device=device)
        self.dropout_t = Dropout(dropout[0])
        self.dropout_a = Dropout(dropout[1])
        self.dropout_v = Dropout(dropout[2])
        # the fusion encoder (model.py:149-185); every fusion but CubeMLP
        # keeps the [bs, T, 3, d_common] shape
        if fusion == "cubemlp":
            self.mlp_encoder = MLPEncoder(
                activate, (time_len, 3, d_common), d_hiddens, d_outs,
                dropout_mlp, bias, ln_first, res_project, use_pallas, device)
            t_out, k_out, d_out = d_outs[-1]
        else:
            if fusion == "transformer":
                self.mlp_encoder = TransformerFusion(
                    d_common, time_len, num_layers=fusion_layers,
                    num_heads=fusion_heads, dropout=dropout_mlp[0],
                    device=device)
            elif fusion == "moe":
                self.mlp_encoder = MoEFusion(
                    d_common, time_len, num_layers=fusion_layers,
                    num_heads=fusion_heads, num_experts=moe_experts,
                    top_k=moe_topk, dropout=dropout_mlp[0], device=device)
            elif fusion == "tfn":
                self.mlp_encoder = TFNFusion(d_common, dropout=dropout_mlp[0],
                                             device=device)
            else:
                raise ValueError(f"fusion {fusion!r}: choose cubemlp, "
                                 "transformer, tfn or moe")
            t_out, k_out, d_out = time_len, 3, d_common
        self.classify_dim = get_output_dim(
            features_compose_t, features_compose_k, d_out, t_out, k_out)
        if self.classify_dim <= 128:
            self.classifier = nn.Linear(self.classify_dim, num_class,
                                        device=device)
        else:
            self.classifier_hidden = nn.Linear(self.classify_dim, 128,
                                               device=device)
            self.classifier_dropout = Dropout(dropout[3])
            self.classifier = nn.Linear(128, num_class, device=device)

        # Fusion information I(F;T), I(F;A), I(F;V) and invariant
        # information I(T;A), I(T;V) (ref: Model.py:290-295); F_F has the
        # classifier's input width, the summary features d_common
        for key in VMI_KEYS:
            x_dim = self.classify_dim if key[0] == "f" else d_common
            setattr(self, f"vmi_estimator_{key}", VMIEstimator(
                critic_type, baseline_type, bound_type, x_dim, d_common,
                EST_HIDDEN_DIM, EST_EMBED_DIM, EST_LAYERS, EST_ACTIVATION,
                EST_MU, EST_RHO, device))
        # conditional-MI classifiers (ref: Model.py:298-303)
        for key in CMI_KEYS:
            setattr(self, f"vcmi_estimator_{key}", VCMIEstimator(
                EST_EMBED_DIM, EST_HIDDEN_DIM, EST_ACTIVATION,
                cmi_last_acticate, device=device))
        self.vmi_groups = _groups_by_shape(self, "vmi_estimator_", VMI_KEYS)
        self.cmi_groups = _groups_by_shape(self, "vcmi_estimator_", CMI_KEYS)

    def forward(self, bert_sentences, bert_sentence_types,
                bert_sentence_att_mask, a, v, return_features: bool = True,
                generator=None, text_features=None, text_hidden=None):
        """Token ids/types/mask [bs, T] int (raw text; None for dense
        text), a [bs, T, d_a], v [bs, T, d_v], ``text_features`` [bs, T,
        d_t] (dense text). Returns (out, F_F, T_F, A_F, V_F), or (out,)
        without features. ``generator`` feeds BERT's attention dropout
        seeds in training mode. ``text_hidden`` [bs, T, H]: BERT's output
        computed already (the pipelined stack, ``parallel/pipeline.py``),
        taken in place of the tower (ref: mimrl_tpu/models/model.py:
        232-250)."""
        T = self.time_len
        with span("model/text"):  # BERT (or the dense text) and W_t
            if text_hidden is not None:
                t = text_hidden
            elif self.raw_text:
                t = self.bertmodel(bert_sentences, bert_sentence_types,
                                   bert_sentence_att_mask, generator)
            elif text_features is None:
                raise ValueError("a dense-text model takes text_features "
                                 "[bs, T, d_t]")
            else:
                t = text_features
            t = self.W_t(t)

        if self.encoders == "conv":
            a, v = self.conv_a(a), self.conv_v(v)
        else:
            # lengths from non-zero rows, clamped to >=1 (ref: Model.py:425-432)
            lengths_a = lengths_from_sequence(a)
            lengths_v = lengths_from_sequence(v)
            if self.fused_av_scan:
                a, v = run_pair(self.rnn_a, a, lengths_a,
                                self.rnn_v, v, lengths_v)
            else:
                a = self.rnn_a(a, lengths_a)
                v = self.rnn_v(v, lengths_v)
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

    # ------------------------------------------------------------------ #
    # Stage losses (ref: Model.py:305-386)
    # ------------------------------------------------------------------ #
    def _all_estimates(self, labels, F_F, T_F, A_F, V_F, knn: Dict):
        """The 5 MI and 6 CMI estimates; ``knn`` maps CMI_KEYS to (x, y, z)
        conditional-product sample triples. Labels are tiled to d_common
        (model.py:336-337). Batched by parameter shape under
        ``fused_estimators`` unless the bound is CLUB (model.py:343-345)."""
        labels = labels.reshape(-1, 1).to(T_F.dtype).repeat(1, self.d_common)
        pairs = {"f_t": (F_F, T_F), "f_a": (F_F, A_F), "f_v": (F_F, V_F),
                 "t_a": (T_F, A_F), "t_v": (T_F, V_F)}
        triples = {
            "ac_t": (A_F, labels, T_F), "ta_c": (T_F, A_F, labels),
            "vc_t": (V_F, labels, T_F), "tv_c": (T_F, V_F, labels),
            "tc_a": (T_F, labels, A_F), "tc_v": (T_F, labels, V_F),
        }
        mis, losses = {}, {}
        if not self.fused_estimators or self.bound_type == "club":
            for key in VMI_KEYS:
                mis[key], losses[key] = getattr(
                    self, f"vmi_estimator_{key}")(*pairs[key])
            for key in CMI_KEYS:
                mis[key], losses[key] = getattr(
                    self, f"vcmi_estimator_{key}")(*triples[key], *knn[key])
            return mis, losses

        def stack(inputs, group, j):
            return torch.stack([inputs[k][j] for k in group])

        for group in self.vmi_groups:
            mi, loss = batched_vmi(
                [getattr(self, f"vmi_estimator_{k}") for k in group],
                stack(pairs, group, 0), stack(pairs, group, 1))
            for i, key in enumerate(group):
                mis[key], losses[key] = mi[i], loss[i]
        for group in self.cmi_groups:
            mi, loss = batched_vcmi(
                [getattr(self, f"vcmi_estimator_{k}") for k in group],
                [stack(triples, group, j) for j in range(3)],
                [stack(knn, group, j) for j in range(3)])
            for i, key in enumerate(group):
                mis[key], losses[key] = mi[i], loss[i]
        return mis, losses

    def compute_vmi_loss_stage1(self, labels, F_F, T_F, A_F, V_F, knn):
        """11 (mi, mi_loss) pairs for critic training
        (ref: Model.py:305-341)."""
        with span("mi/estimates"):
            m, l = self._all_estimates(labels, F_F, T_F, A_F, V_F, knn)
        order = VMI_KEYS + CMI_KEYS
        return [m[k] for k in order], [l[k] for k in order]

    def compute_vmi_loss_stage2(self, labels, F_F, T_F, A_F, V_F, knn):
        """8 derived (mi, mi_loss) pairs for main-model training
        (ref: Model.py:343-386)."""
        with span("mi/estimates"):
            m, l = self._all_estimates(labels, F_F, T_F, A_F, V_F, knn)
            mi_inv = m["t_a"] + m["t_v"]
            mi_spec_t = m["tc_a"] + m["tc_v"] - m["ta_c"] - m["tv_c"]
            mi_spec_a = m["ac_t"] - m["ta_c"]
            mi_spec_v = m["vc_t"] - m["tv_c"]
            mi_comp = m["ta_c"] + m["tv_c"]
        mis = [m["f_t"], m["f_a"], m["f_v"], mi_inv,
               mi_spec_t, mi_spec_a, mi_spec_v, mi_comp]
        losses = [l["f_t"], l["f_a"], l["f_v"], -mi_inv,
                  -mi_spec_t, -mi_spec_a, -mi_spec_v, -mi_comp]
        return mis, losses


def forward_batch(model: MimrlModel, batch: Dict[str, torch.Tensor],
                  return_features: bool = True, generator=None):
    """The model on a batch dict of MODEL_INPUTS; a batch holds the raw or
    the dense text, as its model takes. On a mesh (``parallel/mesh.py``)
    the inputs are this rank's rows of the batch and the outputs are
    gathered to the global batch; on a ``pipe`` axis BERT runs as the
    mesh's pipeline (``parallel/pipeline.py``, ``Mesh.set_pipeline``) and
    the model takes its output (ref: mimrl_tpu/train/steps.py:198-218)."""
    mesh = mesh_of(model)
    inputs = [batch.get(k) for k in MODEL_INPUTS[:5]]
    hidden = None
    if (mesh is not None and mesh.shape[PIPE_AXIS] > 1 and model.raw_text
            and batch.get("text") is None):
        with span("model/text"):
            hidden = bert_forward_pipelined(
                model.bertmodel, mesh, *inputs[:3],
                n_microbatches=mesh.n_microbatches, n_virtual=mesh.n_virtual,
                remat=mesh.remat, generator=generator)
    outs = model(*inputs, return_features=return_features,
                 generator=generator, text_features=batch.get("text"),
                 text_hidden=hidden)
    return tuple(gather_rows(o, mesh) for o in outs)


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
                device=None, d_t: int = 768, raw_text: bool = True
                ) -> MimrlModel:
    """A MimrlModel for a run config, with uninitialised storage on
    ``device`` (load a state_dict or call ``init_weights`` next).
    ``raw_text``: BERT over token ids (the DeclareLab family's default);
    else dense text of width ``d_t`` and no BERT (``uses_raw_text``)."""
    with torch.device("meta"):
        model = MimrlModel(
            d_a=d_a, d_v=d_v, d_common=cfg.d_common, d_t=d_t,
            raw_text=raw_text, encoders=cfg.encoders,
            features_compose_t=cfg.features_compose_t,
            features_compose_k=cfg.features_compose_k,
            num_class=cfg.num_class, activate=cfg.activate,
            time_len=cfg.time_len,
            d_hiddens=tuple(map(tuple, cfg.d_hiddens)),
            d_outs=tuple(map(tuple, cfg.d_outs)),
            dropout_mlp=tuple(cfg.dropout_mlp), dropout=tuple(cfg.dropout),
            bias=cfg.bias, ln_first=cfg.ln_first,
            res_project=tuple(cfg.res_project),
            critic_type=cfg.critic_type, baseline_type=cfg.baseline_type,
            bound_type=cfg.bound_type, k_neighbor=cfg.k_neighbor,
            radius=cfg.radius, cmi_last_acticate=cfg.cmi_last_acticate,
            use_pallas=cfg.use_pallas, fused_estimators=cfg.fused_estimators,
            fused_av_scan=cfg.fused_av_scan, fusion=cfg.fusion, fusion_layers=cfg.fusion_layers,
            fusion_heads=cfg.fusion_heads, moe_experts=cfg.moe_experts,
            moe_topk=cfg.moe_topk,
            bert_config=bert_config_from(cfg, vocab_size))
    return model.to_empty(device=device or "cpu")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every parameter, the estimator bank
    included, drawn from ``generator`` (a CPU generator, so the weights do
    not depend on the device): Linear weights normal with std
    1/sqrt(fan_in) and zero bias; embeddings normal with std 0.02;
    LayerNorms ones/zeros; GRU and LSTM weights uniform in
    +-1/sqrt(hidden), then every recurrent ``weight_hh`` re-initialised
    orthogonal per gate-stacked matrix, as ``apply_orthogonal_whh`` does
    (model.py:504-519, ref: Customization.py:18-21); Conv1d kernels normal
    with std 1/sqrt(fan_in) and zero bias. The fusions follow their flax
    initialisers (fusion.py): position tables normal with std 0.02, the
    experts' ``w1`` [E, d, h] and ``w2`` [E, h, d] normal with std
    1/sqrt(fan_in), where LeCun normal's fan_in counts the expert axis as
    a receptive field (E * d and E * h), and zero expert biases."""

    def fill(p, draw):
        p.copy_(draw(torch.empty(p.shape, dtype=p.dtype)))

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            fill(m.weight, lambda t: t.normal_(
                0.0, 1.0 / math.sqrt(fan_in), generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            fill(m.weight, lambda t: t.normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, (nn.LayerNorm, AxisLayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (TransformerFusion, MoEFusion)):
            for p in (m.pos_time, m.pos_modality):
                fill(p, lambda t: t.normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, MoEBlock):
            for w in (m.w1, m.w2):
                fan_in = w.shape[0] * w.shape[1]
                fill(w, lambda t: t.normal_(
                    0.0, 1.0 / math.sqrt(fan_in), generator=generator))
            m.b1.zero_()
            m.b2.zero_()
        elif isinstance(m, nn.RNNBase):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                fill(p, lambda t: t.uniform_(-bound, bound,
                                             generator=generator))
            for name, p in m.named_parameters():
                if name.startswith("weight_hh"):
                    fill(p, lambda t: _orthogonal(t, generator))
    return model


def _orthogonal(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A (semi-)orthogonal matrix of t's shape from a seeded normal draw
    (QR with the sign fix of ``nn.init.orthogonal_``, which takes no
    generator)."""
    rows, cols = t.shape
    flat = torch.empty(max(rows, cols), min(rows, cols)).normal_(
        0.0, 1.0, generator=generator)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return t.copy_(q if rows >= cols else q.t())
