"""The two-stage training loop's steps (PyTorch port of
``mimrl_tpu.train.steps``:47-338; ref: Solver.py:194-248).

- ``critic_step``  = stage 1's inner loop body (Solver.py:204-216): updates
  only the vmi / vcmi parameter group. The model's forward runs in training
  mode (dropout on) under ``torch.no_grad()``: the features are constants
  of this stage, so no graph is built through BERT and the attention
  backward kernel is not launched.
- ``train_step``   = stage 2's body (Solver.py:220-242): updates main + bert
  with ``task_loss + sum(coef2 * mi_loss)`` (Customization.py:104-113) and
  writes the batch's features into the new bank.
- Epoch-0 semantics (no bank yet): stage 1 is skipped and stage 2 runs
  with ``use_mi=False``, the task loss alone and zero MI telemetry
  (ref: Solver.py:201-203, Customization.py:97-98, :105-106).
- Feature banks are epoch-stale: stage 2 writes the bank that the next
  epoch reads (ref: Solver.py:219-244).
- ``features_step`` / ``critic_update`` split the critic step for
  ``--fast_stage1``: one forward per batch, then the critics' updates on
  the cached features.
- ``custom_loss`` (``--custom_loss``, ``train/custom.py``): the resolved
  hook ``fn(out, labels, (F, T, A, V))``, added to stage 2's objective and
  to the eval loss (``mimrl_tpu/train/steps.py:285-287``, ``:336-337``).
- ``grad_debug_step`` (``--check_gradient``): a separate forward and
  backward of a stage's loss, giving each parameter's sum and its
  gradient's sum (``mimrl_tpu/train/steps.py:579-616``).
- ``selection_metric`` / ``selection_better``: the model-selection rule
  of ``eval/metrics.current_result_better`` as device functions, for the
  best models that ``--epoch_group`` keeps on the device
  (``mimrl_tpu/train/steps.py:632-669``).
- The epoch functions (``critic_epoch_fresh``, ``critic_epoch``,
  ``critic_epoch_cached``, ``train_epoch``, ``eval_epoch``) are the
  ``--epoch_scan`` rung (ref: ``mimrl_tpu/train/steps.py:346-578``): they
  take the epoch stacked on the device ([NB, bs, ...]) and call each step
  body through ``run(name, body, **inputs)``. The default runs it;
  ``train/graphs.py::StepGraphs`` captures it in a CUDA graph at first use
  and replays it for the other batches. So a body reads and writes the
  training state only through tensors that stay in place, and takes the
  batch's position as a device tensor.

On a mesh (``parallel/mesh.py``) a batch holds this rank's rows of the
model's inputs beside the global labels and sample mask; ``forward_batch``
gathers the outputs and features to the global batch, so the losses, the
kNN samples and the bank writes are the single-process ones, identical
on every rank, and the gradients are averaged over the batch axes before
each update.

Nothing here reads a value back from the device: losses, MI values and
outputs are returned as device tensors, and the non-finite guard
(``--skip_nonfinite_updates``) selects with ``torch.where`` on a device
flag. Parameters, optimizer state and banks are updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.mi.knn import prod_knn_sample
from mimrl_tpu_torch.models.model import (CMI_KEYS, MODEL_INPUTS, MimrlModel,
                                          forward_batch)
from mimrl_tpu_torch.parallel.mesh import (MODEL_AXIS, all_reduce, mesh_of,
                                           reduce_gradients, shard_dim)
from mimrl_tpu_torch.train.losses import compute_task_loss
from mimrl_tpu_torch.train.optim import ChainOptimizer


class FeatureBank:
    """Epoch-wide feature store: fixed [N_bank, d] device tensors and a
    valid mask, written in place by slices (the reference grows python
    lists and concatenates them, Solver.py:219-244)."""

    FIELDS = ("C", "F", "T", "A", "V")

    def __init__(self, n_bank: int, n_valid: int, d_common: int,
                 d_fused: Optional[int] = None, dtype=torch.float32,
                 device=None):
        def z(d):
            return torch.zeros((n_bank, d), dtype=dtype, device=device)

        self.C = z(1)  # labels
        self.F = z(d_common if d_fused is None else d_fused)
        self.T, self.A, self.V = z(d_common), z(d_common), z(d_common)
        self.valid = torch.arange(n_bank, device=device) < n_valid

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f) for f in self.FIELDS]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """A copy of the five fields and the valid mask."""
        return {f: getattr(self, f).clone() for f in self.FIELDS + ("valid",)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy a ``state_dict()`` in place; raises on another field set,
        shape or dtype."""
        names = self.FIELDS + ("valid",)
        if set(state) != set(names):
            raise ValueError(f"bank state holds {sorted(state)}, want "
                             f"{sorted(names)}")
        for f in names:
            src, dst = state[f], getattr(self, f)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"bank field {f}: {src.dtype} {tuple(src.shape)}, want "
                    f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)

    def zero_(self) -> "FeatureBank":
        for t in self.tensors():
            t.zero_()
        return self

    @torch.no_grad()
    def copy_(self, other: "FeatureBank") -> "FeatureBank":
        """Every field <- ``other``'s, in place (the valid mask is fixed)."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)
        return self

    def rows(self, offset, n: int) -> torch.Tensor:
        """The row ids [offset, offset + n) on the bank's device; ``offset``
        is an int or a device tensor."""
        return torch.arange(n, device=self.C.device) + offset

    @torch.no_grad()
    def write(self, offset, labels, F, T, A, V,
              ok: Optional[torch.Tensor] = None) -> None:
        """Rows [offset, offset + bs) <- this batch (``offset``: an int or
        a device tensor); with ``ok`` (a device bool) false, the rows keep
        what they held."""
        new = (labels.reshape(-1, 1), F, T, A, V)
        rows = self.rows(offset, labels.shape[0])
        for bank, x in zip(self.tensors(), new):
            x = x.detach().to(bank.dtype)
            if ok is not None:
                x = torch.where(ok, x, bank.index_select(0, rows))
            bank.index_copy_(0, rows, x)


def sample_all_knn(generator: Optional[torch.Generator], bank: FeatureBank,
                   batch_size: int, k_neighbor: int, radius: float,
                   anchors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, Tuple]:
    """The six conditional-product sample triples of one loss evaluation
    (ref: Model.py:323-339): I(x;y|z) samples are (x_bank, y_bank, z_bank).
    ``anchors`` may give each estimator's anchor rows (the tests inject the
    JAX package's)."""
    triples = {
        "ac_t": (bank.A, bank.C, bank.T),
        "ta_c": (bank.T, bank.A, bank.C),
        "vc_t": (bank.V, bank.C, bank.T),
        "tv_c": (bank.T, bank.V, bank.C),
        "tc_a": (bank.T, bank.C, bank.A),
        "tc_v": (bank.T, bank.C, bank.V),
    }
    with span("mi/knn"):
        return {
            name: prod_knn_sample(
                generator, *triples[name], batch_size=batch_size,
                k_neighbor=k_neighbor, radius=radius, valid=bank.valid,
                anchor_idx=None if anchors is None else anchors[name])
            for name in CMI_KEYS
        }


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Device bool: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _guarded_step(enabled: bool, optimizer: ChainOptimizer, loss, grads
                  ) -> Optional[torch.Tensor]:
    """One optimizer step under the ``--skip_nonfinite_updates``
    containment: when it is enabled and the loss or any gradient is NaN or
    Inf, parameters and optimizer state keep their old values. The loss is
    checked as well as the gradients, because a NaN target gives a NaN loss
    with finite garbage gradients (abs and max swallow NaN in their
    backward). Returns the device flag ``ok``, or None when not enabled.
    On a mesh the gradients are averaged over the batch axes first
    (``ChainOptimizer.reduce``), so every rank decides alike."""
    with span("optim/step"):
        grads = optimizer.reduce(grads)
        if not enabled:
            optimizer.step(grads)
            return None
        ok = torch.isfinite(loss) & _all_finite(grads)
        live = list(optimizer.params) + optimizer.state()
        with torch.no_grad():
            old = [t.detach().clone() for t in live]
            optimizer.step(grads)
            for t, o in zip(live, old):
                t.copy_(torch.where(ok, t, o))
        return ok


def _grads(loss, params: List[nn.Parameter]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def host_tensors(batch: Dict, labels: np.ndarray, task: str, pin: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Host batch -> the model's inputs, the sample mask and the labels as
    CPU tensors (int64 labels for classification, float32 otherwise), in
    page-locked memory with ``pin`` (for copies that do not block the
    host)."""
    model_batch = {k: torch.from_numpy(np.asarray(batch[k]))
                   for k in MODEL_INPUTS + ("sample_mask",) if k in batch}
    labels = np.asarray(labels)
    labels = torch.from_numpy(
        labels.astype(np.int64 if task == "classification" else np.float32))
    if pin:
        model_batch = {k: v.pin_memory() for k, v in model_batch.items()}
        labels = labels.pin_memory()
    return model_batch, labels


def to_device(batch: Dict, labels: np.ndarray, task: str, device
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Host batch -> the model's inputs, the sample mask and the labels on
    the device (``host_tensors``, then copies in stream order)."""
    model_batch, labels = host_tensors(batch, labels, task)
    return ({k: v.to(device, non_blocking=True) for k, v in model_batch.items()},
            labels.to(device, non_blocking=True))


def stage2_loss(model: MimrlModel, cfg: MimrlConfig,
                batch: Dict[str, torch.Tensor], labels: torch.Tensor,
                knn: Optional[Dict[str, Tuple]],
                generator: Optional[torch.Generator],
                custom_loss: Optional[Callable] = None):
    """The model's forward and the stage-2 objective: the task loss, plus
    ``sum(coef2 * mi_loss)`` when ``knn`` holds the bank's samples (None:
    no MI, zero telemetry), plus ``custom_loss(out, labels, feats)`` when
    it is given. Returns (loss, the 8 MI channels detached, output, [F_F,
    T_F, A_F, V_F])."""
    out, *feats = forward_batch(model, batch, generator=generator)
    total = compute_task_loss(cfg.loss, cfg.num_class, out, labels,
                              batch.get("sample_mask"))
    if knn is not None:
        mis, mi_losses = model.compute_vmi_loss_stage2(labels, *feats, knn)
        total = total + sum(l * c for l, c in zip(
            mi_losses, cfg.loss_mi_coefficient2))
        mis = torch.stack(mis).detach()
    else:
        mis = torch.zeros(8, dtype=torch.float32, device=out.device)
    if custom_loss is not None:
        total = total + custom_loss(out, labels, tuple(feats))
    return total, mis, out, feats


def features_step(model: MimrlModel, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """The training-mode forward (dropout on) under ``no_grad``: [F_F,
    T_F, A_F, V_F], constants of stage 1."""
    model.train()
    with span("step/features"), torch.no_grad():
        _, *feats = forward_batch(model, batch, generator=generator)
    return feats


def critic_update(model: MimrlModel, opt_vmi: ChainOptimizer,
                  cfg: MimrlConfig, feats: Sequence[torch.Tensor],
                  labels: torch.Tensor, bank: FeatureBank,
                  generator: Optional[torch.Generator],
                  anchors: Optional[Dict[str, torch.Tensor]] = None):
    """One update of the estimator parameters from given features.
    Returns (loss, the 11 MI estimates) as device tensors."""
    model.train()
    with span("step/critic"):
        knn = sample_all_knn(generator, bank, cfg.batch_size, cfg.k_neighbor,
                             cfg.radius, anchors)
        mis, losses = model.compute_vmi_loss_stage1(labels, *feats, knn)
        total = sum(l * c for l, c in zip(losses, cfg.loss_mi_coefficient1))
        grads = _grads(total, opt_vmi.params)
        _guarded_step(cfg.skip_nonfinite_updates, opt_vmi, total.detach(),
                      grads)
        return total.detach(), torch.stack(mis).detach()


def critic_step(model: MimrlModel, opt_vmi: ChainOptimizer, cfg: MimrlConfig,
                batch: Dict[str, torch.Tensor], labels: torch.Tensor,
                bank: FeatureBank, generator: Optional[torch.Generator],
                anchors: Optional[Dict[str, torch.Tensor]] = None):
    """Stage 1: a fresh forward, then one update of the estimator
    parameters. Returns (loss, the 11 MI estimates) as device tensors."""
    with span("step/critic"):
        feats = features_step(model, batch, generator)
        return critic_update(model, opt_vmi, cfg, feats, labels, bank,
                             generator, anchors)


def train_step(model: MimrlModel, opt_main: ChainOptimizer, cfg: MimrlConfig,
               batch: Dict[str, torch.Tensor], labels: torch.Tensor,
               bank: FeatureBank, new_bank: FeatureBank, offset,
               generator: Optional[torch.Generator], use_mi: bool,
               anchors: Optional[Dict[str, torch.Tensor]] = None,
               custom_loss: Optional[Callable] = None):
    """Stage 2: one update of the main and BERT parameters, and the
    batch's features written to ``new_bank`` at ``offset`` (an int or a
    device tensor). Returns (loss,
    the 8 MI channels, the model's output) as device tensors."""
    model.train()
    with span("step/train"):
        knn = (sample_all_knn(generator, bank, cfg.batch_size,
                              cfg.k_neighbor, cfg.radius, anchors)
               if use_mi else None)
        total, mis, out, feats = stage2_loss(model, cfg, batch, labels, knn,
                                             generator, custom_loss)
        grads = _grads(total, opt_main.params)
        ok = _guarded_step(cfg.skip_nonfinite_updates, opt_main,
                           total.detach(), grads)
        if ok is not None:
            # NaN features in the bank would poison every later kNN sample
            ok = ok & _all_finite(feats + [labels.float()])
        new_bank.write(offset, labels, *feats, ok=ok)
        return total.detach(), mis, out.detach()


@torch.no_grad()
def eval_step(model: MimrlModel, cfg: MimrlConfig,
              batch: Dict[str, torch.Tensor], labels: torch.Tensor,
              bank: FeatureBank, generator: Optional[torch.Generator],
              use_mi: bool,
              anchors: Optional[Dict[str, torch.Tensor]] = None,
              custom_loss: Optional[Callable] = None):
    """Deterministic forward and the stage-2 objective. Returns (loss, the
    8 MI channels, output, (F_F, T_F, A_F, V_F))."""
    model.eval()
    with span("step/eval"):
        knn = (sample_all_knn(generator, bank, cfg.batch_size,
                              cfg.k_neighbor, cfg.radius, anchors)
               if use_mi else None)
        loss, mis, out, feats = stage2_loss(model, cfg, batch, labels, knn,
                                            None, custom_loss)
        return loss, mis, out, tuple(feats)


def grad_debug_step(model: MimrlModel, cfg: MimrlConfig,
                    batch: Dict[str, torch.Tensor], labels: torch.Tensor,
                    bank: FeatureBank, generator: Optional[torch.Generator],
                    stage: int,
                    anchors: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """``--check_gradient``: a training-mode forward with its own kNN
    samples and dropout draw, and the gradient of the stage's loss (stage
    1: the critics' weighted losses; stage 2: the task loss and the
    weighted MI losses, without the custom hook, as in JAX) for every
    parameter whose name holds no "bert". Returns {name: (the parameter's
    sum, its gradient's sum)} as device tensors; names are the model's
    ``named_parameters()`` names (ref: Utils.py:11-19). Updates nothing."""
    model.train()
    knn = sample_all_knn(generator, bank, cfg.batch_size, cfg.k_neighbor,
                         cfg.radius, anchors)
    if stage == 1:
        feats = forward_batch(model, batch, generator=generator)[1:]
        _, losses = model.compute_vmi_loss_stage1(labels, *feats, knn)
        total = sum(l * c for l, c in zip(losses, cfg.loss_mi_coefficient1))
    else:
        total = stage2_loss(model, cfg, batch, labels, knn, generator)[0]
    named = [(n, p) for n, p in model.named_parameters() if "bert" not in n]
    mesh = mesh_of(model)
    grads = reduce_gradients(mesh, _grads(total, [p for _, p in named]))
    sums = {}
    for (n, p), g in zip(named, grads):
        p_sum, g_sum = p.detach().sum(), g.sum()
        if shard_dim(p) is not None:  # this rank's block: sum the blocks
            p_sum, g_sum = (all_reduce(t, mesh, (MODEL_AXIS,))
                            for t in (p_sum, g_sum))
        sums[n] = (p_sum, g_sum)
    return sums


# ---------------------------------------------------------------------- #
# The --epoch_scan rung: one epoch's stage over the stacked batches.


def call(name: str, body: Callable, **inputs):
    """Run a step body (the default ``run`` of the epoch functions; ``name``
    keys a captured graph in ``train/graphs.py``)."""
    del name
    return body(**inputs)


def _batch_at(batches: Dict[str, torch.Tensor], i: int
             ) -> Dict[str, torch.Tensor]:
    """Batch ``i`` of an epoch stacked as [NB, bs, ...] tensors."""
    return {k: v[i] for k, v in batches.items()}


def _anchor_kw(anchors: Optional[Sequence[Dict]], j: int) -> Dict:
    return {} if anchors is None else {"anchors": anchors[j]}


def _pass_sums(losses: List[torch.Tensor], n_passes: int) -> torch.Tensor:
    """[n_passes] sums of the per-step losses, in pass order."""
    return torch.stack(losses).reshape(n_passes, -1).sum(dim=1)


def critic_epoch_fresh(model: MimrlModel, opt_vmi: ChainOptimizer,
                       cfg: MimrlConfig, batches: Dict[str, torch.Tensor],
                       labels: torch.Tensor, bank: FeatureBank,
                       generator: Optional[torch.Generator], n_passes: int,
                       run: Callable = call,
                       anchors: Optional[Sequence[Dict]] = None
                       ) -> torch.Tensor:
    """Stage 1 as the reference runs it (the default under
    ``--epoch_scan``): a fresh forward, with its own dropout draw, for every
    pass over every batch (steps.py:386-434). ``anchors``: one dict per
    step, pass-major. Returns the [n_passes] critic-loss sums."""
    nb = labels.shape[0]

    def body(batch, labels, anchors=None):
        return critic_step(model, opt_vmi, cfg, batch, labels, bank,
                           generator, anchors)

    losses = [run("critic_step", body, batch=_batch_at(batches, i),
                  labels=labels[i], **_anchor_kw(anchors, p * nb + i))[0]
              for p in range(n_passes) for i in range(nb)]
    return _pass_sums(losses, n_passes)


def critic_epoch(model: MimrlModel, opt_vmi: ChainOptimizer,
                 cfg: MimrlConfig, batches: Dict[str, torch.Tensor],
                 labels: torch.Tensor, bank: FeatureBank,
                 generator: Optional[torch.Generator], n_passes: int,
                 run: Callable = call,
                 anchors: Optional[Sequence[Dict]] = None) -> torch.Tensor:
    """Stage 1 under ``--fast_stage1``: one forward per batch, then
    ``n_passes`` sweeps of critic updates over the cached features
    (steps.py:346-384). Returns the [n_passes] critic-loss sums."""
    nb = labels.shape[0]

    def features(batch):
        return features_step(model, batch, generator)

    def update(feats, labels, anchors=None):
        return critic_update(model, opt_vmi, cfg, feats, labels, bank,
                             generator, anchors)

    cached = [run("features_step", features, batch=_batch_at(batches, i))
              for i in range(nb)]
    losses = [run("critic_update", update, feats=cached[i], labels=labels[i],
                  **_anchor_kw(anchors, p * nb + i))[0]
              for p in range(n_passes) for i in range(nb)]
    return _pass_sums(losses, n_passes)


def critic_epoch_cached(model: MimrlModel, opt_vmi: ChainOptimizer,
                        cfg: MimrlConfig, bank: FeatureBank, nb: int,
                        generator: Optional[torch.Generator], n_passes: int,
                        run: Callable = call,
                        anchors: Optional[Sequence[Dict]] = None
                        ) -> torch.Tensor:
    """Stage 1 under ``--stage1_cached``: no forward; the features and
    labels of batch i are rows [i * bs, (i + 1) * bs) of the epoch-stale
    bank, which the previous epoch's stage 2 wrote (steps.py:436-496).
    Returns the [n_passes] critic-loss sums."""
    bs = cfg.batch_size
    offsets = torch.arange(nb, device=bank.C.device) * bs

    def update(offset, anchors=None):
        rows = bank.rows(offset, bs)
        feats = [f.index_select(0, rows) for f in (bank.F, bank.T, bank.A,
                                                    bank.V)]
        labels = bank.C.index_select(0, rows)[:, 0].float()
        return critic_update(model, opt_vmi, cfg, feats, labels, bank,
                             generator, anchors)

    losses = [run("critic_update_cached", update, offset=offsets[i],
                  **_anchor_kw(anchors, p * nb + i))[0]
              for p in range(n_passes) for i in range(nb)]
    return _pass_sums(losses, n_passes)


def train_epoch(model: MimrlModel, opt_main: ChainOptimizer,
                cfg: MimrlConfig, batches: Dict[str, torch.Tensor],
                labels: torch.Tensor, bank: FeatureBank,
                new_bank: FeatureBank, generator: Optional[torch.Generator],
                use_mi: bool, run: Callable = call,
                anchors: Optional[Sequence[Dict]] = None,
                custom_loss: Optional[Callable] = None):
    """Stage 2 over the epoch (steps.py:498-520): batch i's features go to
    rows [i * bs, (i + 1) * bs) of ``new_bank``. Returns (losses [NB], MI
    channels [NB, 8], outputs [NB, bs, C])."""
    nb = labels.shape[0]
    offsets = torch.arange(nb, device=labels.device) * cfg.batch_size

    def body(batch, labels, offset, anchors=None):
        return train_step(model, opt_main, cfg, batch, labels, bank,
                          new_bank, offset, generator, use_mi, anchors,
                          custom_loss)

    steps = [run("train_step_mi" if use_mi else "train_step", body,
                 batch=_batch_at(batches, i), labels=labels[i],
                 offset=offsets[i], **_anchor_kw(anchors, i))
             for i in range(nb)]
    return tuple(torch.stack(x) for x in zip(*steps))


def eval_epoch(model: MimrlModel, cfg: MimrlConfig,
               batches: Dict[str, torch.Tensor], labels: torch.Tensor,
               bank: FeatureBank, generator: Optional[torch.Generator],
               use_mi: bool, run: Callable = call,
               anchors: Optional[Sequence[Dict]] = None,
               custom_loss: Optional[Callable] = None):
    """``eval_step`` over a stacked split (steps.py:522-536). Returns
    (losses [NB], MI channels [NB, 8], outputs [NB, bs, C], the four
    feature stacks [NB, bs, d])."""
    nb = labels.shape[0]

    def body(batch, labels, anchors=None):
        loss, mis, out, feats = eval_step(model, cfg, batch, labels, bank,
                                          generator, use_mi, anchors,
                                          custom_loss)
        return (loss, mis, out, *feats)

    steps = [run("eval_step_mi" if use_mi else "eval_step", body,
                 batch=_batch_at(batches, i), labels=labels[i],
                 **_anchor_kw(anchors, i)) for i in range(nb)]
    losses, mis, outs, *feats = (torch.stack(x) for x in zip(*steps))
    return losses, mis, outs, tuple(feats)


# ---------------------------------------------------------------------- #
# --epoch_group's selection on the device (ref: steps.py:632-669).


def selection_metric(sel: str, outs: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The selection scalar of one eval split, float32 over the sample
    mask: ``outs`` [NB, bs, C], ``labels`` and ``mask`` [NB, bs]. ``mae``
    (down), ``acc`` (up; the sign for one output, else the argmax) or
    ``ccc`` (up; ``eval/metrics.ccc_score`` as masked sums), the rules of
    ``eval/metrics.current_result_better``. Sums in float32 may resolve a
    near-tie below 1e-7 otherwise than the host's metrics (as in JAX,
    ``mimrl_tpu/core/config.py:222-226``)."""
    m = mask.reshape(-1).float()
    n = m.sum().clamp_min(1.0)
    if sel == "acc":
        if outs.shape[-1] == 1:
            pred = (outs.reshape(-1) > 0).long()
        else:
            pred = outs.reshape(-1, outs.shape[-1]).argmax(dim=-1)
        hit = (pred == labels.reshape(-1).long()).float()
        return (hit * m).sum() / n
    p = outs.reshape(-1).float()
    t = labels.reshape(-1).float()
    if sel == "mae":
        return ((p - t).abs() * m).sum() / n
    if sel == "ccc":
        mx, my = (p * m).sum() / n, (t * m).sum() / n
        cov = ((p - mx) * (t - my) * m).sum() / n
        vx = ((p - mx).square() * m).sum() / n
        vy = ((t - my).square() * m).sum() / n
        return 2 * cov / (vx + vy + (mx - my).square())
    raise NotImplementedError(sel)


def selection_better(sel: str, new: torch.Tensor,
                     best: torch.Tensor) -> torch.Tensor:
    """The device flag "``new`` beats ``best``": lower MAE, higher
    accuracy or CCC."""
    return new < best if sel == "mae" else new > best
