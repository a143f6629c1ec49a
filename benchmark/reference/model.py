"""The plain reference of the MIMRL model, in float32 PyTorch operations.

BERT (HuggingFace's post-LayerNorm encoder), the 2-layer bidirectional GRU
towers over the valid prefix of each utterance, CubeMLP's axis mixing, the
classifier, the five InfoNCE critics and the six kNN-conditional classifiers
of the estimator bank: the equations of MIMRL's ``Model.py``, ``VMI.py`` and
``MLPProcess.py`` written out once, with no kernel, no fusion and no batching
of the estimators. Parameters live in a flat dict whose names are the
reference torch model's (``bertmodel.encoder.layer.0.attention.self.query.
weight``, ``rnn_a.weight_hh_l0_reverse``, ``vmi_estimator_f_t.critic_model.
MLP_g.fc_in.weight``, ...), so one seeded dict feeds both this reference and
the system under test.

Random draws (dropout masks, attention dropout seeds, kNN anchors) come from a
``Draws`` object, which replays the draws of a training step in the order the
system makes them (``reference/rng.py``). Nothing here imports the system.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.rng import Draws

Params = Dict[str, torch.Tensor]

VMI_KEYS = ("f_t", "f_a", "f_v", "t_a", "t_v")
CMI_KEYS = ("ac_t", "ta_c", "vc_t", "tv_c", "tc_a", "tc_v")
EST_HIDDEN, EST_EMBED, EST_LAYERS = 256, 128, 2
AXES = "lkd"


def _dims(text: str) -> List[List[int]]:
    """``50-3-128=10-3-128`` -> [[50, 3, 128], [10, 3, 128]]."""
    return [[int(v) for v in block.split("-")] for block in text.split("=")]


class Spec:
    """The model's sizes, read from a configuration's flags."""

    def __init__(self, flags: Dict, d_audio: int, d_video: int,
                 vocab: int = 30522):
        self.bs = int(flags["--batch_size"])
        self.T = int(flags["--time_len"])
        self.d = int(flags["--d_common"])
        self.H = int(flags.get("--bert_hidden", 768))
        self.layers = int(flags.get("--bert_layers", 12))
        self.heads = int(flags.get("--bert_heads", 12))
        self.ffn = int(flags.get("--bert_intermediate", 4 * self.H))
        self.vocab = vocab
        self.max_pos = max(512, self.T)
        self.p_bert = float(flags.get("--bert_dropout", 0.1))
        self.dropout = [float(v) for v in flags["--dropout"].split("-")]
        self.dropout_mlp = [float(v) for v in flags["--dropout_mlp"].split("-")]
        self.hiddens = _dims(flags["--d_hiddens"])
        self.outs = _dims(flags["--d_outs"])
        self.bias = bool(flags.get("--bias", False))
        self.res_project = [v == "1" for v in flags["--res_project"].split("-")]
        self.d_audio, self.d_video = d_audio, d_video
        self.k = int(flags["--k_neighbor"])
        self.coef1 = [float(v) for v in
                      flags["--loss_mi_coefficient1"].split("-")]
        self.coef2 = [float(v) for v in
                      flags["--loss_mi_coefficient2"].split("-")]
        self.clip = float(flags["--gradient_clip"])
        self.lr = float(flags["--learning_rate"])
        self.bert_lr_rate = float(flags["--bert_lr_rate"])
        self.mi_lr_rate = float(flags.get("--mi_lr_rate", 1.0))
        self.stage1_n = int(flags["--stage1_n"])
        self.compute_dtype = {"bfloat16": torch.bfloat16}.get(
            flags.get("--compute_dtype", "float32"), torch.float32)
        for key, want in (("--encoders", "gru"), ("--activate", "gelu"),
                          ("--critic_type", "separate"),
                          ("--baseline_type", "constant"),
                          ("--bound_type", "infonce"), ("--loss", "MAE"),
                          ("--optm", "Adam")):
            if flags.get(key, want) != want:
                raise NotImplementedError(f"the reference covers {key} "
                                          f"{want}, not {flags[key]}")
        if self.hiddens[-1][2] != self.d or self.outs[-1][2] != self.d:
            raise NotImplementedError("the reference covers a fused width "
                                      "of d_common")


def param_shapes(s: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the reference model's order."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    H, d = s.H, s.d

    def linear(name, n_in, n_out, bias=True):
        shapes[f"{name}.weight"] = (n_out, n_in)
        if bias:
            shapes[f"{name}.bias"] = (n_out,)

    def norm(name, n):
        shapes[f"{name}.weight"] = (n,)
        shapes[f"{name}.bias"] = (n,)

    e = "bertmodel.embeddings"
    shapes[f"{e}.word_embeddings.weight"] = (s.vocab, H)
    shapes[f"{e}.position_embeddings.weight"] = (s.max_pos, H)
    shapes[f"{e}.token_type_embeddings.weight"] = (2, H)
    norm(f"{e}.LayerNorm", H)
    for i in range(s.layers):
        p = f"bertmodel.encoder.layer.{i}"
        for w in ("query", "key", "value"):
            linear(f"{p}.attention.self.{w}", H, H)
        linear(f"{p}.attention.output.dense", H, H)
        norm(f"{p}.attention.output.LayerNorm", H)
        linear(f"{p}.intermediate.dense", H, s.ffn)
        linear(f"{p}.output.dense", s.ffn, H)
        norm(f"{p}.output.LayerNorm", H)
    linear("W_t", H, d, bias=False)
    for tower, d_in in (("rnn_a", s.d_audio), ("rnn_v", s.d_video)):
        for layer in range(2):
            n_in = d_in if layer == 0 else 2 * d
            for sfx in ("", "_reverse"):
                shapes[f"{tower}.weight_ih_l{layer}{sfx}"] = (3 * d, n_in)
                shapes[f"{tower}.weight_hh_l{layer}{sfx}"] = (3 * d, d)
                shapes[f"{tower}.bias_ih_l{layer}{sfx}"] = (3 * d,)
                shapes[f"{tower}.bias_hh_l{layer}{sfx}"] = (3 * d,)
    norm("ln_a", d)
    norm("ln_v", d)
    d_in = [s.T, 3, d]
    for b, (hid, out) in enumerate(zip(s.hiddens, s.outs)):
        p = f"mlp_encoder.layers_stack.{b}"
        for i, n in enumerate(AXES):
            linear(f"{p}.mlp_{n}.fc1", d_in[i], hid[i], s.bias)
            linear(f"{p}.mlp_{n}.fc2", hid[i], out[i], s.bias)
            shapes[f"{p}.ln_{n}.weight"] = (out[i],)
            shapes[f"{p}.ln_{n}.bias"] = (out[i],)
            if s.res_project[b]:
                shapes[f"{p}.res_projection_{n}.weight"] = (out[i], d_in[i])
        d_in = list(out)
    linear("classifier", d, 1)
    for key in VMI_KEYS:
        for mlp in ("MLP_g", "MLP_h"):
            p = f"vmi_estimator_{key}.critic_model.{mlp}"
            linear(f"{p}.fc_in", d, EST_HIDDEN)
            for j in range(EST_LAYERS):
                linear(f"{p}.fc_{j}", EST_HIDDEN, EST_HIDDEN)
            linear(f"{p}.fc_out", EST_HIDDEN, EST_EMBED)
    for key in CMI_KEYS:
        p = f"vcmi_estimator_{key}.classifier"
        linear(f"{p}.fc0", 3 * EST_EMBED, EST_HIDDEN)
        linear(f"{p}.fc1", EST_HIDDEN, EST_HIDDEN)
        linear(f"{p}.fc2", EST_HIDDEN, EST_HIDDEN)
        linear(f"{p}.fc_out", EST_HIDDEN, 2)
    return shapes


def is_estimator(name: str) -> bool:
    return name.startswith(("vmi_", "vcmi_"))


def is_bert(name: str) -> bool:
    return name.startswith("bertmodel.")


# ---------------------------------------------------------------------- #
# the forward pass


def _linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def _layer_norm(P: Params, name: str, x: torch.Tensor, eps: float):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], eps)


def _attention(q, k, v, bias, keep: Optional[torch.Tensor], p: float):
    """softmax(q k^T / sqrt(hd) + bias), inverted dropout by ``keep``, . v."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + bias, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - p), 0.0)
    return torch.matmul(probs, v)


def bert(P: Params, s: Spec, ids, types, mask, draws: Optional[Draws]):
    e = "bertmodel.embeddings"
    T = ids.shape[1]
    x = (P[f"{e}.word_embeddings.weight"][ids.long()]
         + P[f"{e}.position_embeddings.weight"][:T][None]
         + P[f"{e}.token_type_embeddings.weight"][types.long()])
    x = _layer_norm(P, f"{e}.LayerNorm", x, 1e-12)
    if draws is not None:
        x = draws.dropout(x, s.p_bert, s.compute_dtype)
    bias = (1.0 - mask[:, None, None, :].float()) * -1e9
    bs, nh, hd = x.shape[0], s.heads, s.H // s.heads
    for i in range(s.layers):
        p = f"bertmodel.encoder.layer.{i}"
        q, k, v = (_linear(P, f"{p}.attention.self.{w}", x)
                   .reshape(bs, T, nh, hd).transpose(1, 2)
                   for w in ("query", "key", "value"))
        keep = (None if draws is None else
                draws.attention_keep(bs, nh, T, s.p_bert))
        ctx = _attention(q, k, v, bias, keep, s.p_bert)
        h = _linear(P, f"{p}.attention.output.dense",
                    ctx.transpose(1, 2).reshape(bs, T, s.H))
        if draws is not None:
            h = draws.dropout(h, s.p_bert, s.compute_dtype)
        x = _layer_norm(P, f"{p}.attention.output.LayerNorm", h + x, 1e-12)
        h = F.gelu(_linear(P, f"{p}.intermediate.dense", x))
        h = _linear(P, f"{p}.output.dense", h)
        if draws is not None:
            h = draws.dropout(h, s.p_bert, s.compute_dtype)
        x = _layer_norm(P, f"{p}.output.LayerNorm", h + x, 1e-12)
    return x


def lengths_of(x: torch.Tensor) -> torch.Tensor:
    """Rows that are not all zero, at least one (MIMRL's Utils.py:297)."""
    return (x.abs().sum(dim=-1) != 0).sum(dim=1).clamp(min=1)


def _gru(x, w_ih, w_hh, b_ih, b_hh):
    """One direction of a GRU layer from a zero state; gates (r, z, n)."""
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    gi = F.linear(x, w_ih, b_ih)  # [bs, T, 3d]
    outs = []
    for t in range(x.shape[1]):
        gh = F.linear(h, w_hh, b_hh)
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)


def bigru(P: Params, tower: str, x: torch.Tensor) -> torch.Tensor:
    """Two bidirectional layers over each sample's valid prefix; outputs
    past the prefix are zero; the last layer's directions are summed."""
    bs, T, _ = x.shape
    lengths = lengths_of(x)
    pos = torch.arange(T, device=x.device)[None, :]
    valid = (pos < lengths[:, None]).to(x.dtype)[..., None]
    rev = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)

    def take(y):
        return torch.gather(y, 1, rev[..., None].expand(-1, -1, y.shape[-1]))

    for layer in range(2):
        def weights(sfx):
            return [P[f"{tower}.{w}_l{layer}{sfx}"]
                    for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        fwd = _gru(x, *weights("")) * valid
        bwd = take(_gru(take(x), *weights("_reverse"))) * valid
        x = fwd + bwd if layer == 1 else torch.cat([fwd, bwd], dim=-1)
    return x


def _axis_linear(P: Params, name: str, x: torch.Tensor, axis: int):
    """A Linear over one axis of [bs, l, k, d]."""
    y = torch.movedim(F.linear(torch.movedim(x, axis, -1),
                               P[f"{name}.weight"], P.get(f"{name}.bias")),
                      -1, axis)
    return y


def _axis_norm(P: Params, name: str, x: torch.Tensor, axis: int):
    mean = x.mean(dim=axis, keepdim=True)
    var = (x - mean).square().mean(dim=axis, keepdim=True)
    shape = [1, 1, 1, 1]
    shape[axis] = x.shape[axis]
    return ((x - mean) * torch.rsqrt(var + 1e-6)
            * P[f"{name}.weight"].reshape(shape)
            + P[f"{name}.bias"].reshape(shape))


def cubemlp(P: Params, s: Spec, x: torch.Tensor) -> torch.Tensor:
    """CubeMLP (post-LayerNorm): per block, mix L, then K, then D."""
    for b in range(len(s.hiddens)):
        p = f"mlp_encoder.layers_stack.{b}"
        for i, n in enumerate(AXES):
            axis = i + 1
            res = (_axis_linear(P, f"{p}.res_projection_{n}", x, axis)
                   if s.res_project[b] else x)
            h = F.gelu(_axis_linear(P, f"{p}.mlp_{n}.fc1", x, axis))
            h = _axis_linear(P, f"{p}.mlp_{n}.fc2", h, axis)
            if s.dropout_mlp[i] > 0:
                raise NotImplementedError("CubeMLP dropout")
            x = _axis_norm(P, f"{p}.ln_{n}", h + res, axis)
    return x


def forward(P: Params, s: Spec, batch: Dict[str, torch.Tensor],
            draws: Optional[Draws] = None):
    """(out [bs, 1], F_F, T_F, A_F, V_F); ``draws`` None is eval mode."""
    t = bert(P, s, batch["bert_sentences"], batch["bert_sentence_types"],
             batch["bert_sentence_att_mask"], draws)
    t = _linear(P, "W_t", t)
    a = F.relu(_layer_norm(P, "ln_a", bigru(P, "rnn_a", batch["audio"]), 1e-6))
    v = F.relu(_layer_norm(P, "ln_v", bigru(P, "rnn_v", batch["video"]), 1e-6))
    if draws is not None:
        t = draws.dropout(t, s.dropout[0], torch.float32)
        a = draws.dropout(a, s.dropout[1], torch.float32)
        v = draws.dropout(v, s.dropout[2], torch.float32)
    x = cubemlp(P, s, torch.stack([t, a, v], dim=2))
    fused = x.mean(dim=2).mean(dim=1)
    out = _linear(P, "classifier", fused)
    return out, fused, t.mean(dim=1), a.mean(dim=1), v.mean(dim=1)


# ---------------------------------------------------------------------- #
# the estimator bank


def _mlp(P: Params, prefix: str, names: Sequence[str], x: torch.Tensor):
    for j, n in enumerate(names):
        x = _linear(P, f"{prefix}.{n}", x)
        if j < len(names) - 1:
            x = F.relu(x)
    return x


_CRITIC = ("fc_in",) + tuple(f"fc_{j}" for j in range(EST_LAYERS)) + ("fc_out",)
_CLASSIFIER = ("fc0", "fc1", "fc2", "fc_out")


def infonce(P: Params, key: str, x: torch.Tensor, y: torch.Tensor):
    """(mi, loss) of the separable critic under the InfoNCE bound."""
    p = f"vmi_estimator_{key}.critic_model"
    scores = _mlp(P, f"{p}.MLP_h", _CRITIC, y) @ _mlp(
        P, f"{p}.MLP_g", _CRITIC, x).t()
    n = scores.shape[-1]
    mi = math.log(n) + (torch.diagonal(scores)
                        - torch.logsumexp(scores, dim=-1)).mean()
    return mi, -mi


def _tile(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else x.repeat(1, width // x.shape[-1])


def conditional_mi(P: Params, key: str, joint, prod):
    """(cmi, bce) of the classifier between joint triples and kNN
    conditional-product triples (NWJ ratio of its sigmoid outputs)."""
    j = torch.cat([_tile(f, EST_EMBED) for f in joint], dim=-1)
    q = torch.cat([_tile(f, EST_EMBED) for f in prod], dim=-1)
    n = q.shape[0]
    batch = torch.cat([j[:n], q], dim=0)
    targets = torch.cat([batch.new_tensor([1.0, 0.0]).expand(n, 2),
                         batch.new_tensor([0.0, 1.0]).expand(n, 2)])
    gamma = torch.sigmoid(torch.clamp(_mlp(
        P, f"vcmi_estimator_{key}.classifier", _CLASSIFIER, batch), -10, 10))
    bce = -(targets * torch.clamp_min(torch.log(gamma), -100.0)
            + (1 - targets) * torch.clamp_min(torch.log1p(-gamma), -100.0)
            ).mean()
    g = gamma[:, 0]
    ratio = torch.log(g / (1.0 - g + 1e-6))
    cmi = 1.0 + (ratio[:n].sum() - ratio[n:].sum()) / (2 * n)
    return cmi, bce


def estimates(P: Params, s: Spec, labels, F_F, T_F, A_F, V_F, knn: Dict):
    """{key: (mi, loss)} of the eleven estimators."""
    C = labels.reshape(-1, 1).float().repeat(1, s.d)
    pairs = {"f_t": (F_F, T_F), "f_a": (F_F, A_F), "f_v": (F_F, V_F),
             "t_a": (T_F, A_F), "t_v": (T_F, V_F)}
    triples = {"ac_t": (A_F, C, T_F), "ta_c": (T_F, A_F, C),
               "vc_t": (V_F, C, T_F), "tv_c": (T_F, V_F, C),
               "tc_a": (T_F, C, A_F), "tc_v": (T_F, C, V_F)}
    out = {k: infonce(P, k, *pairs[k]) for k in VMI_KEYS}
    out.update({k: conditional_mi(P, k, triples[k], knn[k])
                for k in CMI_KEYS})
    return out


def stage1_loss(P: Params, s: Spec, labels, feats, knn):
    est = estimates(P, s, labels, *feats, knn)
    return sum(est[k][1] * c for k, c in zip(VMI_KEYS + CMI_KEYS, s.coef1))


def stage2_mi_losses(P: Params, s: Spec, labels, feats, knn):
    """(the weighted sum of the eight MI terms, the sum of their sizes)."""
    m = {k: v[0] for k, v in estimates(P, s, labels, *feats, knn).items()}
    losses = {k: -m[k] for k in VMI_KEYS}
    inv = m["t_a"] + m["t_v"]
    spec_t = m["tc_a"] + m["tc_v"] - m["ta_c"] - m["tv_c"]
    spec_a = m["ac_t"] - m["ta_c"]
    spec_v = m["vc_t"] - m["tv_c"]
    comp = m["ta_c"] + m["tv_c"]
    terms = [t * c for t, c in zip(
        [losses["f_t"], losses["f_a"], losses["f_v"], -inv, -spec_t, -spec_a,
         -spec_v, -comp], s.coef2)]
    return sum(terms), sum(t.detach().abs() for t in terms)


def knn_sample(X, Y, Z, valid, anchors, k: int):
    """Conditional-product triples: each anchor's k nearest rows in
    Z-space (anchors and invalid rows excluded) give x; (y, z) are the
    anchor's, repeated k times; every field is tiled to the widest."""
    Zf = Z.float()
    Zq = Zf[anchors]
    d2 = ((Zq * Zq).sum(dim=1, keepdim=True) - 2.0 * torch.matmul(Zq, Zf.t())
          + (Zf * Zf).sum(dim=1)[None, :])
    excluded = (~valid).index_fill(0, anchors, True)
    nbr = torch.topk(d2.masked_fill(excluded[None, :], math.inf), k, dim=1,
                     largest=False).indices.reshape(-1)
    rep = anchors.repeat_interleave(k)
    x, y, z = X[nbr], Y[rep], Z[rep]
    width = max(x.shape[1], y.shape[1], z.shape[1])
    return _tile(x, width), _tile(y, width), _tile(z, width)


def knn_all(bank: Dict[str, torch.Tensor], s: Spec, draws: Draws) -> Dict:
    """The six estimators' triples from the epoch's feature bank, anchors
    drawn in the bank's order of estimators."""
    fields = {"ac_t": "ACT", "ta_c": "TAC", "vc_t": "VCT", "tv_c": "TVC",
              "tc_a": "TCA", "tc_v": "TCV"}
    m = s.bs // s.k
    out = {}
    for key in CMI_KEYS:
        X, Y, Z = (bank[f] for f in fields[key])
        anchors = draws.anchors(bank["valid"], m)
        out[key] = knn_sample(X, Y, Z, bank["valid"], anchors, s.k)
    return out


def task_loss(out, labels, mask):
    """Mean absolute error over the real rows."""
    return ((out.reshape(-1) - labels.reshape(-1)).abs() * mask).sum() / mask.sum()
