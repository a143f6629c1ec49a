"""Standalone MI estimation harness (PyTorch port of
``mimrl_tpu.mi.standalone``).

The reference's ``train_MINE`` / ``compute_MI`` (ref: VMI.py:253-396):
train a fresh critic (and baseline) on a pair of feature sets and read an
MI estimate off the training history, checked against correlated
Gaussians whose MI is known.

The EMA follows the reference: after every optimizer step the parameters
are *replaced* by their EMA shadow (VMI.py:338-340 calls ``update()`` and
then ``apply_shadow()``, and never ``restore()``). The steps of an epoch
run without a host read; the epoch's mean MI is read once, at its end.

Run the calibration sweep with ``python -m mimrl_tpu_torch.mi.standalone``
(on the card; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mimrl_tpu_torch.device import resolve_device
from mimrl_tpu_torch.mi import bounds
from mimrl_tpu_torch.mi.estimators import VMIEstimator


def sample_correlated_gaussian(generator: torch.Generator, rho: float = 0.5,
                               dim: int = 20, num_samples: int = 1000
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correlated Gaussian pair with known MI (ref: VMI.py:389-393), drawn
    from ``generator`` on its device: ``y = rho x + sqrt(1 - rho^2) eps``."""
    kw = dict(generator=generator, device=generator.device)
    x = torch.randn(num_samples, dim, **kw)
    eps = torch.randn(num_samples, dim, **kw)
    return x, rho * x + math.sqrt(1.0 - rho ** 2) * eps


def rho_to_mi(dim: int, rho: float) -> float:
    """Analytic MI of the correlated Gaussian (ref: VMI.py:395-396)."""
    return -0.5 * np.log(1 - rho ** 2) * dim


def _loss(est: VMIEstimator, bound_type: str, alpha_logit: float,
          ma_et: torch.Tensor, ma_rate: float, x, y):
    """(loss, mi, ma_et) of one batch (mimrl_tpu/mi/standalone.py:46-69)."""
    if bound_type == "club":
        mu, logvar = est.critic_model(x)
        mi, nll = bounds.club_bound_and_nll(mu, logvar, y)
        return nll, mi, ma_et
    scores = est.critic_model(x, y)
    if bound_type == "mine":
        mi, t, et = bounds.mine_lower_bound_parts(scores)
        ma_et = (1.0 - ma_rate) * ma_et + ma_rate * et.mean()
        # the standalone path negates (ref: VMI.py:311), unlike the
        # in-model one
        loss = -(t.mean() - (1.0 / ma_et).detach() * et.mean())
        return loss, mi, ma_et.detach()
    log_baseline = (est.baseline_model(y)
                    if bound_type in ("tuba", "interpolate") else None)
    mi, loss = bounds.mi_and_loss(bound_type, scores, log_baseline,
                                  alpha_logit)
    return loss, mi, ma_et


class EMA:
    """Weight EMA over a list of parameters (the reference's EMA class,
    VMI.py:253-284): ``shadow = register(params)``; ``update(params,
    shadow)`` sets ``shadow = (1 - decay) p + decay shadow`` in place;
    ``apply_shadow(params, shadow)`` copies the shadow into the
    parameters. ``restore`` is the caller keeping its own copy."""

    def __init__(self, decay: float):
        self.decay = decay

    def register(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [p.detach().clone() for p in params]

    @torch.no_grad()
    def update(self, params, shadow) -> None:
        torch._foreach_mul_(shadow, self.decay)
        torch._foreach_add_(shadow, list(params), alpha=1.0 - self.decay)

    @torch.no_grad()
    def apply_shadow(self, params, shadow) -> None:
        torch._foreach_copy_(list(params), shadow)


def train_mine(generator: Optional[torch.Generator], critic_type: str,
               baseline_type: str, bound_type: str, features_x, features_y,
               epochs: int = 100, batch_size: int = 128, lr: float = 5e-4,
               alpha_logit: float = 0.0, hidden_dim: int = 256,
               embed_dim: int = 128, layers: int = 2,
               activation: str = "relu", mu: float = 0.0, rho: float = 1.0,
               ma_et: float = 1.0, ma_rate: float = 0.01,
               weight_decay: float = 0.999, log: bool = False,
               device=None, init_state: Optional[Dict] = None,
               batch_order: Optional[torch.Tensor] = None) -> np.ndarray:
    """Train a critic (and baseline) and return the per-epoch MI history
    (ref: VMI.py:287-347): Adamax, then the EMA shadow replaces the
    parameters after every step; ``weight_decay`` is the EMA decay, named
    as in VMI.py:287.

    ``features_x`` / ``features_y``: [n, d] arrays or tensors. The epoch
    takes the first ``n // batch_size`` batches in row order, as the JAX
    package does; ``batch_order`` reorders the rows first: [n] indices for
    every epoch, or [epochs, n] for one order per epoch. The weights are
    drawn from ``generator`` (a CPU generator) as the model's are
    (``models/model.py::init_weights``), or taken from ``init_state``, the
    state_dict of a ``VMIEstimator`` of this configuration (``critic_model.*``
    and ``baseline_model.*``). ``device``: the card unless ``"cpu"``."""
    from mimrl_tpu_torch.models.model import init_weights

    if bound_type in ("interpolated", "interpolate") and \
            baseline_type == "constant":
        raise ValueError("the interpolate bound needs a baseline other than "
                         "'constant'")
    dev = resolve_device(device)
    x = torch.as_tensor(features_x, dtype=torch.float32).to(dev)
    y = torch.as_tensor(features_y, dtype=torch.float32).to(dev)
    n = x.shape[0]
    if n < batch_size:
        raise ValueError(f"{n} samples make no batch of {batch_size}")
    n_batches = n // batch_size
    n_used = n_batches * batch_size

    est = VMIEstimator(critic_type, baseline_type, bound_type, x.shape[1],
                       y.shape[1], hidden_dim, embed_dim, layers, activation,
                       mu, rho)
    if init_state is None:
        init_weights(est, generator or torch.Generator().manual_seed(0))
    else:
        est.load_state_dict(init_state, strict=True)
    est.to(dev)
    params = list(est.parameters())
    opt = torch.optim.Adamax(params, lr=lr)
    ema = EMA(weight_decay)
    shadow = ema.register(params)
    ma = torch.full((), ma_et, dtype=torch.float32, device=dev)

    history = []
    for epoch in range(epochs):
        if batch_order is not None:
            order = batch_order if batch_order.dim() == 1 else batch_order[epoch]
            order = order.to(dev)
            xe, ye = x[order], y[order]
        else:
            xe, ye = x, y
        xb = xe[:n_used].reshape(n_batches, batch_size, -1)
        yb = ye[:n_used].reshape(n_batches, batch_size, -1)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for b in range(n_batches):
            loss, mi, ma = _loss(est, bound_type, alpha_logit, ma,
                                 ma_rate, xb[b], yb[b])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ema.update(params, shadow)
            ema.apply_shadow(params, shadow)
            total = total + mi.detach()
        history.append(float(total / n_batches))  # one read per epoch
        if log and epoch % 50 == 0:
            print("Epoch", epoch, ":", np.round(history[-1], 3))
    return np.asarray(history)


def estimate_from_history(history_mi: np.ndarray, estimation: str) -> float:
    """A scalar MI estimate from a history: its max, the mean of its last
    50 epochs, or that mean after Savitzky-Golay smoothing (ref:
    VMI.py:350-378)."""
    if estimation == "max":
        return float(np.max(history_mi))
    if estimation == "mean":
        return (float(np.mean(history_mi[-50:-1])) if len(history_mi) > 1
                else float(history_mi[-1]))
    if estimation == "smooth":
        from scipy.signal import savgol_filter

        smoothed = savgol_filter(history_mi, min(51, len(history_mi) | 1), 3)
        return float(np.mean(smoothed[-50:-1]))
    raise NotImplementedError(estimation)


def compute_mi(generator: Optional[torch.Generator], critic_type: str,
               baseline_type: str, bound_type: str, features_x, features_y,
               estimation: str = "mean", **kwargs):
    """Train a fresh estimator (``train_mine``) and return (estimate,
    history)."""
    history_mi = train_mine(generator, critic_type, baseline_type,
                            bound_type, features_x, features_y, **kwargs)
    return estimate_from_history(history_mi, estimation), history_mi


def show_history_mi(history_mi, mi_score, true_mi):
    """Plot an MI history against the estimate and the truth (ref:
    VMI.py:381-387). Needs matplotlib, imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.plot(history_mi)
    plt.hlines(mi_score, 0, len(history_mi))
    plt.text(10, mi_score + np.max(history_mi) / 50,
             str(np.round(mi_score, 2)))
    plt.title("Mutual information estimation, true MI is "
              + str(np.round(true_mi, 2)))
    return plt.gcf()


def _seeds(seed: int, case: int) -> Tuple[int, int]:
    """The data and training seeds of one (bound, rho) case."""
    data, train = np.random.SeedSequence([seed, case]).generate_state(2)
    return int(data), int(train)


def run_sweep(bound_types=None, rhos=(0.3, 0.6, 0.9), dim=5, n=2048,
              epochs=60, seed=0, critic_type="separate",
              baseline_type="constant", estimation="max", plot_dir=None,
              batch_size=256, lr=2e-3, weight_decay=0.9, device=None):
    """Estimate MI for correlated Gaussians across bounds x correlations
    against the analytic truth (the sweep of the reference's dead
    ``__main__``, VMI.py:409-461). The defaults are the settings at which
    ``tests/test_bounds.py::test_gaussian_mi_recovery`` checks recovery.
    Returns {bound: [(rho, true_mi, estimate, wall_s), ...]}."""
    bound_types = bound_types or [
        "dv", "mine", "tuba", "nwj", "infonce", "js", "js_fgan", "smile"]
    dev = resolve_device(device)
    results = {}
    for b_idx, bound in enumerate(bound_types):
        rows = []
        for i, rho in enumerate(rhos):
            data_seed, train_seed = _seeds(seed, b_idx * 1000 + i)
            x, y = sample_correlated_gaussian(
                torch.Generator(dev).manual_seed(data_seed), rho=rho,
                dim=dim, num_samples=n)
            true = rho_to_mi(dim, rho)
            base = "unnormalized" if bound == "interpolate" else baseline_type
            t0 = time.perf_counter()
            score, hist = compute_mi(
                torch.Generator().manual_seed(train_seed), critic_type, base,
                bound, x, y, estimation=estimation, epochs=epochs,
                batch_size=batch_size, lr=lr, weight_decay=weight_decay,
                device=dev)
            wall = time.perf_counter() - t0
            rows.append((rho, true, score, wall))
            print(f"{bound:10s} rho={rho:.2f} true={true:6.3f} "
                  f"est={score:6.3f} ({wall:.1f} s)")
            if plot_dir is not None:
                import os

                os.makedirs(plot_dir, exist_ok=True)
                fig = show_history_mi(hist, score, true)
                fig.savefig(os.path.join(plot_dir, f"{bound}_rho{rho:.2f}.png"))
                fig.clf()
        results[bound] = rows
    return results


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="MI-estimator calibration sweep vs analytic Gaussians")
    ap.add_argument("--bounds", nargs="*", default=None)
    ap.add_argument("--rhos", nargs="*", type=float, default=[0.3, 0.6, 0.9])
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--critic_type", default="separate")
    ap.add_argument("--baseline_type", default="constant")
    ap.add_argument("--estimation", default="max",
                    choices=["max", "mean", "smooth"])
    ap.add_argument("--plot_dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the CPU")
    a = ap.parse_args(argv)
    return run_sweep(a.bounds, tuple(a.rhos), a.dim, epochs=a.epochs,
                     seed=a.seed, critic_type=a.critic_type,
                     baseline_type=a.baseline_type, estimation=a.estimation,
                     plot_dir=a.plot_dir, device=a.device)


if __name__ == "__main__":
    main()
