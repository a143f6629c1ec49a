"""In-model MI / conditional-MI estimators (PyTorch port of
``mimrl_tpu.mi.estimators``; ref: Model.py:108-225).

``VMIEstimator`` wraps a critic, a baseline and a bound; ``VCMIEstimator``
is the classifier-based conditional-MI estimator trained against kNN
conditional-product negatives. ``batched_vmi`` and ``batched_vcmi`` run E
estimators of one parameter shape in one pass, each with its own weights
(``--fused_estimators``; the JAX package vmaps the same modules,
``mimrl_tpu/models/model.py:371-425``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mimrl_tpu_torch.mi import bounds
from mimrl_tpu_torch.mi.critics import (BaselineModel, ClubCritic,
                                        CriticModel, batched_chain,
                                        batched_log_baseline, batched_scores,
                                        stack_linears)
from mimrl_tpu_torch.utils.activations import get_activation_fn


class VMIEstimator(nn.Module):
    """(features_x, features_y) -> (mi, mi_loss) (ref: Model.py:108-148).
    With the CLUB bound, mi is the upper bound's log-ratio estimate and
    mi_loss the critic's negative log-likelihood."""

    alpha_logit = 0.01  # hard-coded in the reference (Model.py:117)
    ma_rate = 0.01

    def __init__(self, critic_type: str, baseline_type: str, bound_type: str,
                 x_dim: int, y_dim: int, hidden_dim: int = 256,
                 embed_dim: int = 128, layers: int = 2,
                 activation: str = "relu", mu: float = 0.0, rho: float = 1.0,
                 device=None):
        super().__init__()
        self.bound_type = bound_type
        if bound_type == "club":
            self.critic_model = ClubCritic(x_dim, y_dim, hidden_dim, layers,
                                           activation, device)
            return
        self.critic_model = CriticModel(critic_type, x_dim, y_dim, hidden_dim,
                                        embed_dim, layers, activation, device)
        if bound_type in ("tuba", "interpolate"):
            self.baseline_model = BaselineModel(
                baseline_type, y_dim, hidden_dim, layers, activation, mu, rho,
                device)

    def forward(self, features_x, features_y):
        if self.bound_type == "club":
            mu, logvar = self.critic_model(features_x)
            return bounds.club_bound_and_nll(mu, logvar, features_y)
        scores = self.critic_model(features_x, features_y)
        log_baseline = None
        if self.bound_type in ("tuba", "interpolate"):
            log_baseline = self.baseline_model(features_y)
        return bounds.mi_and_loss(self.bound_type, scores, log_baseline,
                                  self.alpha_logit, self.ma_rate)


def batched_vmi(estimators: Sequence[VMIEstimator], features_x: torch.Tensor,
                features_y: torch.Tensor):
    """E estimators of one shape (not CLUB) on features_x [E, bs, x_dim],
    features_y [E, bs, y_dim] -> (mi [E], mi_loss [E])."""
    first = estimators[0]
    scores = batched_scores([e.critic_model for e in estimators],
                            features_x, features_y)
    log_baseline = None
    if first.bound_type in ("tuba", "interpolate"):
        log_baseline = batched_log_baseline(
            [e.baseline_model for e in estimators], features_y)
    return bounds.mi_and_loss(first.bound_type, scores, log_baseline,
                              first.alpha_logit, first.ma_rate)


class MLPForCMI(nn.Module):
    """3-hidden-layer MLP -> clamp(-10, 10) -> sigmoid / hardtanh head
    (ref: Model.py:47-72)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 activation: str = "relu", last_activate: str = "sigmoid",
                 device=None):
        super().__init__()
        if last_activate not in ("hardtanh", "sigmoid"):
            raise NotImplementedError(last_activate)
        self.act = get_activation_fn(activation)
        self.last_activate = last_activate
        self.fc0 = nn.Linear(in_dim, hidden_dim, device=device)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.fc_out = nn.Linear(hidden_dim, output_dim, device=device)

    def linears(self):
        return [self.fc0, self.fc1, self.fc2, self.fc_out]

    def forward(self, x):
        *hidden, out = self.linears()
        for layer in hidden:
            x = self.act(layer(x))
        return self.head(out(x))

    def head(self, logits):
        x = torch.clamp(logits, -10.0, 10.0)
        if self.last_activate == "hardtanh":
            return torch.clamp(x, 1e-4, 1.0 - 1e-4)
        return torch.sigmoid(x)


def _binary_cross_entropy(probs, targets):
    """``F.binary_cross_entropy`` on probabilities, mean reduction (per
    matrix of a stack [..., rows, 2]), with the log clamp at -100 (ref:
    Model.py:198), written as the JAX package writes it."""
    log_p = torch.clamp_min(torch.log(probs), -100.0)
    log_1p = torch.clamp_min(torch.log1p(-probs), -100.0)
    return -(targets * log_p + (1.0 - targets) * log_1p).mean(dim=(-2, -1))


class VCMIEstimator(nn.Module):
    """Classifier-based conditional MI I(X;Y|Z) (ref: Model.py:150-225):
    joint samples (x, y, z) of the batch against conditional-product
    samples of ``prod_knn_sample``; a 2-way classifier is trained with BCE
    and the estimate is the NWJ (or DV) log-ratio of its outputs."""

    def __init__(self, embed_dim: int = 128, hidden_dim: int = 256,
                 activation: str = "relu", last_activate: str = "sigmoid",
                 cmi_type: str = "nwj", device=None):
        super().__init__()
        if cmi_type not in ("nwj", "dv"):
            raise NotImplementedError(cmi_type)
        self.embed_dim = embed_dim
        self.cmi_type = cmi_type
        self.classifier = MLPForCMI(3 * embed_dim, hidden_dim, 2, activation,
                                    last_activate, device)

    def _tile_to_embed(self, f):
        d = f.shape[-1]
        if d != self.embed_dim:
            if self.embed_dim % d != 0:
                raise ValueError(f"cannot tile dim {d} to {self.embed_dim}")
            f = f.repeat(*(1,) * (f.dim() - 1), self.embed_dim // d)
        return f

    def _classifier_batch(self, joint_xyz, knn_xyz):
        """The joint rows then the conditional-product rows, each triple
        tiled to 3 * embed, [..., 2n, 3 * embed], with the BCE targets
        [2n, 2]."""
        joint = torch.cat([self._tile_to_embed(f) for f in joint_xyz], dim=-1)
        prod = torch.cat([self._tile_to_embed(f) for f in knn_xyz], dim=-1)
        # when bs % k != 0 the product set is smaller: the joint set is
        # truncated to match (ref: Model.py:180-187)
        n = prod.shape[-2]
        batch = torch.cat([joint[..., :n, :], prod], dim=-2)
        # rows [1, 0] for the joint set, then [0, 1] for the product set
        targets = torch.eye(2, dtype=batch.dtype, device=batch.device)[
            :, None, :].expand(2, n, 2).reshape(2 * n, 2)
        return batch, targets

    def forward(self, features_x, features_y, features_z, knn_x, knn_y, knn_z):
        batch, targets = self._classifier_batch(
            (features_x, features_y, features_z), (knn_x, knn_y, knn_z))
        out = self.classifier(batch)
        return self._estimate_cmi(out), _binary_cross_entropy(out, targets)

    def _estimate_cmi(self, gamma):
        """NWJ / DV ratio estimate from the classifier's outputs on the
        combined batch, per matrix of a stack [..., 2n, 2] (ref:
        Model.py:203-225)."""
        batch_size = gamma.shape[-2]  # = 2n, as Model.py:204
        half = batch_size // 2
        gamma_joint = gamma[..., :half, 0:1]
        gamma_prod = gamma[..., half:, 0:1]
        sum1 = torch.log(gamma_joint / (1.0 - gamma_joint + 1e-6)).sum(
            dim=(-2, -1))
        sum2 = torch.log(gamma_prod / (1.0 - gamma_prod + 1e-6)).sum(
            dim=(-2, -1))
        if self.cmi_type == "nwj":
            return 1.0 + (sum1 - sum2) / batch_size
        return sum1 / batch_size - torch.log(sum2 / batch_size)


def batched_vcmi(estimators: Sequence[VCMIEstimator], joint_xyz, knn_xyz):
    """E classifiers of one shape on the joint triples (x, y, z), each
    [E, bs, d], and the kNN triples, each [E, n, d] -> (cmi [E], bce [E])."""
    first = estimators[0]
    batch, targets = first._classifier_batch(joint_xyz, knn_xyz)
    classifiers = [e.classifier for e in estimators]
    logits = batched_chain(stack_linears(classifiers), batch,
                           classifiers[0].act)
    out = classifiers[0].head(logits)
    return first._estimate_cmi(out), _binary_cross_entropy(out, targets)
