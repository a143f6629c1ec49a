"""The reference's training steps and its readings of them.

One step is MIMRL's (``Solver.py:194-248``): stage 2 is the task loss (MAE
over the real rows) plus, once a feature bank exists, the weighted MI terms,
and updates BERT and the rest; stage 1 updates the estimator bank alone on
features of a training-mode forward that carry no gradient. An update clips
each gradient element to the gradient clip, then takes an Adam step (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected; the first moment kept in the dtype the
configuration's ``moment_dtype`` states, bfloat16 by default, with b1 rounded
to it in ``b1 * m``), BERT's rate scaled by ``bert_lr_rate``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import model as M
from benchmark.reference.rng import Draws

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Per-leaf Adam state over ``names``; ``state`` may hold the count and
    the moments to start from ({name: tensor})."""

    def __init__(self, names: Sequence[str], P: M.Params, lr: float,
                 scales: Dict[str, float], clip: float, mu_dtype,
                 state: Optional[Dict] = None):
        self.names, self.lr, self.scales, self.clip = list(names), lr, scales, clip
        self.mu_dtype = mu_dtype
        self.mu_decay = float(torch.tensor(B1, dtype=mu_dtype))
        if state is None:
            self.count = 0.0
            self.mu = {n: torch.zeros_like(P[n], dtype=mu_dtype) for n in names}
            self.nu = {n: torch.zeros_like(P[n]) for n in names}
        else:
            self.count = float(state["count"])
            self.mu = {n: state["mu"][n].to(P[n].device) for n in names}
            self.nu = {n: state["nu"][n].to(P[n].device) for n in names}

    @torch.no_grad()
    def step(self, P: M.Params, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1.0
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for n in self.names:
            g = grads[n].clamp(-self.clip, self.clip)
            m = self.mu[n].float() * self.mu_decay + (1.0 - B1) * g
            self.nu[n] = B2 * self.nu[n] + (1.0 - B2) * g * g
            update = (m / c1) / ((self.nu[n] / c2).sqrt() + EPS)
            self.mu[n] = m.to(self.mu_dtype)
            P[n].add_(update * (-self.lr * self.scales[n]))


def _grads(loss, P: M.Params, names) -> Dict[str, torch.Tensor]:
    got = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(P[n]) if g is None else g
            for n, g in zip(names, got)}


def steps(kind: str, P: M.Params, s: M.Spec, batches: List[Dict],
          draws: Draws, opt: Adam, bank: Optional[Dict] = None) -> Dict:
    """Three steps of one kind from ``P`` (changed in place), each on its
    own batch: ``task`` (stage 2 with no bank), ``mi`` (stage 2 with the
    bank's kNN samples) or ``critic`` (stage 1). Returns the losses with
    their scales (the loss's size; for ``mi`` the task loss plus the sizes
    of the eight weighted MI terms, which may cancel to near zero), the
    norm of each leaf's clipped gradient at the first step, the norm of
    each leaf's change over the three, and the features of each step."""
    start = {n: P[n].detach().clone() for n in opt.names}
    losses, scales, grad_norms, feats_out = [], [], {}, []
    for i, batch in enumerate(batches):
        labels, mask = batch["labels"], batch["sample_mask"]
        with torch.enable_grad():
            if kind == "critic":
                with torch.no_grad():
                    feats = M.forward(P, s, batch, draws)[1:]
                knn = M.knn_all(bank, s, draws)
                loss = M.stage1_loss(P, s, labels, feats, knn)
                scale = loss.detach().abs()
            else:
                knn = M.knn_all(bank, s, draws) if kind == "mi" else None
                out, *feats = M.forward(P, s, batch, draws)
                loss = M.task_loss(out, labels, mask)
                scale = loss.detach().abs()
                if knn is not None:
                    mi, size = M.stage2_mi_losses(P, s, labels, feats, knn)
                    loss, scale = loss + mi, scale + size
            grads = _grads(loss, P, opt.names)
        if i == 0:
            grad_norms = {n: float(g.clamp(-opt.clip, opt.clip).norm())
                          for n, g in grads.items()}
        losses.append(loss.item())
        scales.append(scale.item())
        feats_out.append([f.detach().cpu() for f in feats])
        opt.step(P, grads)
    change = {n: float((P[n].detach() - start[n]).norm()) for n in opt.names}
    return {"loss": losses, "scale": scales, "grad": grad_norms,
            "change": change, "feats": feats_out}


@torch.no_grad()
def outputs(P: M.Params, s: M.Spec, batches: List[Dict]) -> List[torch.Tensor]:
    """The eval-mode outputs [bs, 1] of each batch."""
    return [M.forward(P, s, b)[0].detach().cpu() for b in batches]
