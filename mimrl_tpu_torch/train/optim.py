"""Optimizers, parameter partitioning and learning-rate schedules (PyTorch
port of ``mimrl_tpu.train.optim``; ref: Solver.py:119-170).

- Parameters are partitioned by their top-level module name into bert /
  vmi (with vcmi) / main groups, the reference's ``'bert' in name`` /
  ``'vmi' in name`` / ``'vcmi' in name`` tests (Solver.py:124-133).
- The main optimizer covers bert + main, with the bert group's rate scaled
  by ``bert_lr_rate`` (when > 0) and by the freeze mask; the vmi optimizer
  covers the vmi group at ``learning_rate * mi_lr_rate`` (``cmi_lr_rate``
  is accepted and unused, Solver.py:140-142).
- One update is the chain of the JAX package (optim.py:200-243): clip the
  gradient by VALUE (``clip_grad_value_``, Solver.py:212) -> add
  ``weight_decay * p`` (torch-Adam style L2) -> Adam (b1 0.9, b2 0.999,
  eps 1e-8, bias-corrected) or SGD momentum 0.9 -> per-parameter scale ->
  ``-lr``.
- ``moment_dtype='bfloat16'`` keeps Adam's first moment (SGD's momentum)
  in bf16, with ``b1`` itself rounded to bf16 in ``b1 * m`` as optax's
  ``update_moment`` has it under jit; the second moment stays float32.
  ``torch.optim.Adam`` cannot hold a bf16 moment beside float32
  parameters, so the update is written here in plain tensor ops on flat
  moment tensors: no TPU kernel stood here, stock ops are right.
- The learning rate lives in a device tensor that the ``learning_rate``
  setter writes, so a step captured in a CUDA graph reads the rate of the
  epoch it is replayed in; the four schedule families (step / multi_step /
  exp / plateau) are host-side functions of the epoch (``LRScheduler``).
  Under ``--epoch_group`` the plateau schedule runs on the device
  (``PlateauState``: JAX's ``plateau_state``), so a group of epochs waits
  for no valid loss on the host.
- ``--optm SAM`` raises as in the reference (Solver.py:150-151).
- ``fused_optim`` is an execution-order flag of the JAX package; there is
  one code path here.
- On a mesh (``parallel/mesh.py``) ``ChainOptimizer.reduce`` averages the
  gradients over the batch axes (BERT's summed over ``pipe`` first, on a
  pipe mesh); ``train/steps.py`` calls it before the
  step, so the clip by value sees the whole gradient (clipping a partial
  sum would clip another value) and the non-finite decision is the same
  on every rank. A model-sharded parameter's moments in the flat tensors
  are those of this rank's block.
- Float64 parameters (the equality certificates of
  ``parallel/check.py``) keep float64 moments and arithmetic.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.parallel.mesh import reduce_gradients

B1, B2, EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9  # ref: Solver.py:148


def partition_params(model: nn.Module
                     ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter],
                                Dict[str, nn.Parameter]]:
    """(main, bert, vmi) dicts of named parameters, split by the top-level
    module name; disjoint and complete."""
    main, bert, vmi = {}, {}, {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if "bert" in top:
            bert[name] = p
        elif top.startswith(("vmi_", "vcmi_")):
            vmi[name] = p
        else:
            main[name] = p
    return main, bert, vmi


def bert_freeze_mask(bert_names: Iterable[str], bert_freeze: str
                     ) -> Dict[str, float]:
    """0.0 = frozen (ref: Customization.py:7-16): 'part' freezes encoder
    layers 0-8, 'all' freezes everything, 'no' nothing."""
    mask = {}
    for name in bert_names:
        parts = name.split(".")
        frozen = bert_freeze == "all"
        if bert_freeze == "part" and "layer" in parts:
            frozen = int(parts[parts.index("layer") + 1]) <= 8
        mask[name] = 0.0 if frozen else 1.0
    return mask


class ChainOptimizer:
    """clip by value -> L2 weight decay -> Adam | SGD momentum -> per-
    parameter scale -> -lr, over a fixed list of parameters.

    ``step(grads)`` takes the gradients explicitly (one per parameter, in
    order) and updates parameters and state in place; it reads nothing
    back from the device. ``scales`` holds one float per parameter
    (``bert_lr_rate`` times the freeze mask for BERT's, 1 elsewhere).

    The moments are one flat tensor each, over all parameters: a step is a
    dozen elementwise passes over flat tensors and three ``_foreach`` calls
    on the parameters, not a dozen launches per parameter (BERT-base has
    about 400 of them).
    """

    def __init__(self, cfg: MimrlConfig, params: List[nn.Parameter],
                 scales: Optional[List[float]] = None,
                 learning_rate: Optional[float] = None):
        if cfg.optm == "SAM":
            # accepted by the parser, rejected by the solver (Solver.py:150)
            raise NotImplementedError(
                "SAM is accepted by the CLI but not wired into the two-stage "
                "solver (reference parity)")
        if cfg.optm not in ("Adam", "SGD"):
            raise NotImplementedError(cfg.optm)
        self.kind = cfg.optm
        self.params = list(params)
        self.scales = list(scales) if scales is not None else [1.0] * len(self.params)
        self.gradient_clip = cfg.gradient_clip
        self.weight_decay = cfg.weight_decay
        # float32 arithmetic, float64 for float64 parameters
        self.acc = (torch.float64 if self.params[0].dtype == torch.float64
                    else torch.float32)
        mu_dtype = (torch.bfloat16 if cfg.moment_dtype == "bfloat16"
                    else self.acc)
        dev = self.params[0].device
        self.mesh = None  # parallel/mesh.py: set on a mesh run
        self.sizes = [p.numel() for p in self.params]
        total = sum(self.sizes)
        # the step count lives on the device, so that the non-finite guard
        # can keep it, with the moments, without reading a flag back
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        # -learning_rate, read by the step on the device
        self._neg_lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.learning_rate = (cfg.learning_rate if learning_rate is None
                              else learning_rate)
        self.mu = torch.zeros(total, dtype=mu_dtype, device=dev)
        self.nu = torch.zeros(total if self.kind == "Adam" else 0,
                              dtype=self.acc, device=dev)
        # optax's `decay * m` takes the moment's dtype, so under bfloat16
        # the decay is bf16(0.9) = 0.8984375; the compiled JAX step keeps the
        # product itself in float32 (XLA allows the excess precision), and
        # so does this one
        self.mu_decay = float(torch.tensor(
            B1 if self.kind == "Adam" else SGD_MOMENTUM, dtype=mu_dtype))

    @property
    def learning_rate(self) -> float:
        return self._learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float) -> None:
        """Sets the rate of the steps enqueued after this call (a device
        write in stream order: nothing waits for the device)."""
        self._learning_rate = float(value)
        self._neg_lr.fill_(-self._learning_rate)

    def learning_rate_from(self, lr: torch.Tensor) -> None:
        """Set the rate from a float64 device scalar, rounded to float32
        as the setter rounds a host float; nothing waits for the device,
        and ``learning_rate`` reads the last host value until the next
        host set."""
        self._neg_lr.copy_(lr.neg())

    def state(self) -> List[torch.Tensor]:
        """Every state tensor (what the non-finite guard snapshots)."""
        return [self.count, self.mu, self.nu]

    def state_dict(self) -> Dict:
        """A copy of the step count and both flat moments, each in its own
        dtype, with the optimizer's kind and parameter sizes."""
        return {"kind": self.kind, "sizes": list(self.sizes),
                **{name: t.detach().clone() for name, t in
                   zip(("count", "mu", "nu"), self.state())}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict()`` in place; raises when it was written by
        another kind of optimizer, over other parameters, or with another
        moment dtype."""
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']}, this "
                             f"optimizer is {self.kind}")
        if list(state["sizes"]) != self.sizes:
            raise ValueError("optimizer state over other parameters: "
                             f"{len(state['sizes'])} tensors of "
                             f"{sum(state['sizes'])} values, want "
                             f"{len(self.sizes)} of {sum(self.sizes)}")
        for name, dst in zip(("count", "mu", "nu"), self.state()):
            src = state[name]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"optimizer state {name}: {src.dtype} {tuple(src.shape)}, "
                    f"want {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).to(self.acc) for t in tensors])

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients as ``step`` takes them: on a mesh averaged over
        its batch axes, BERT's summed over ``pipe`` first
        (``parallel/mesh.py::reduce_gradients``), else as they are."""
        return reduce_gradients(self.mesh, grads, self.params)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        g = self._flat(grads)
        if self.gradient_clip > 0:
            g.clamp_(-self.gradient_clip, self.gradient_clip)
        if self.weight_decay > 0:
            g.add_(self._flat(self.params), alpha=self.weight_decay)
        self.count += 1
        m2 = self.mu.to(self.acc) * self.mu_decay  # a new tensor, never mu
        if self.kind == "Adam":
            m2.add_(g, alpha=1.0 - B1)  # (1 - b1) * g + b1 * m
            self.nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            c1 = 1.0 - B1 ** self.count
            c2 = 1.0 - B2 ** self.count
            denom = (self.nu / c2).sqrt_().add_(EPS)
            update = (m2 / c1).div_(denom)
        else:
            m2.add_(g)  # optax.trace: t = g + decay * t, the update is t
            update = m2
        self.mu.copy_(m2)  # rounds under moment_dtype=bfloat16
        views = [u.view(p.shape) for u, p in zip(update.split(self.sizes),
                                                 self.params)]
        torch._foreach_mul_(views, self.scales)
        update.mul_(self._neg_lr)
        torch._foreach_add_(self.params, views)


def make_main_optimizer(cfg: MimrlConfig, params_main: Dict[str, nn.Parameter],
                        params_bert: Dict[str, nn.Parameter]) -> ChainOptimizer:
    """The optimizer over main + bert, with BERT's rate scaling and freeze
    mask (optim.py:200-225)."""
    bert_rate = cfg.bert_lr_rate if cfg.bert_lr_rate > 0 else 1.0
    freeze = bert_freeze_mask(params_bert, cfg.bert_freeze)
    params = list(params_main.values()) + list(params_bert.values())
    scales = ([1.0] * len(params_main)
              + [freeze[name] * bert_rate for name in params_bert])
    return ChainOptimizer(cfg, params, scales, cfg.learning_rate)


def make_vmi_optimizer(cfg: MimrlConfig, params_vmi: Dict[str, nn.Parameter]
                       ) -> ChainOptimizer:
    return ChainOptimizer(cfg, list(params_vmi.values()), None,
                          cfg.learning_rate * cfg.mi_lr_rate)


class LRScheduler:
    """Host-side epoch scheduler for the reference's four families
    (ref: Solver.py:153-170). ``step(val_loss)`` advances one epoch and
    returns the factor to multiply the base rate by."""

    def __init__(self, cfg: MimrlConfig):
        self.kind = cfg.lr_decrease
        self.rate = cfg.lr_decrease_rate
        self.mode = "min" if cfg.task == "regression" else "max"
        self.factor = 1.0
        self.epoch = 0
        if self.kind == "step":
            self.period = int(cfg.lr_decrease_iter)
        elif self.kind == "multi_step":
            self.milestones = list(map(int, str(cfg.lr_decrease_iter).split("-")))
        elif self.kind == "plateau":
            self.patience = int(cfg.lr_decrease_iter)
            self.best = None
            self.bad_epochs = 0
        elif self.kind != "exp":
            raise NotImplementedError(self.kind)

    def state_dict(self) -> Dict:
        """What ``step`` reads and writes: the factor, the epochs stepped,
        and under plateau the best metric and the bad epochs since."""
        state = {"kind": self.kind, "factor": self.factor, "epoch": self.epoch}
        if self.kind == "plateau":
            state.update(best=self.best, bad_epochs=self.bad_epochs)
        return state

    def load_state_dict(self, state: Dict) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"schedule state of {state['kind']!r}, this "
                             f"schedule is {self.kind!r}")
        self.factor = float(state["factor"])
        self.epoch = int(state["epoch"])
        if self.kind == "plateau":
            self.best = state["best"]
            self.bad_epochs = int(state["bad_epochs"])

    @property
    def needs_metric(self) -> bool:
        """True when ``step`` reads the epoch's valid metric (plateau): the
        next epoch's rate is then not known before this epoch's metrics, so
        the epoch loop cannot dispatch ahead."""
        return self.kind == "plateau"

    def step(self, val_metric: Optional[float] = None) -> float:
        """Advance one epoch (called after it, like scheduler.step(),
        ref: Solver.py:52-57) and return the factor."""
        self.epoch += 1
        if self.kind == "step":
            if self.epoch % self.period == 0:
                self.factor *= self.rate
        elif self.kind == "multi_step":
            if self.epoch in self.milestones:
                self.factor *= self.rate
        elif self.kind == "exp":
            self.factor *= self.rate
        elif self.kind == "plateau":
            if val_metric is None:
                raise ValueError("the plateau schedule needs the valid loss")
            better = (self.best is None
                      or (self.mode == "min" and val_metric < self.best)
                      or (self.mode == "max" and val_metric > self.best))
            if better:
                self.best = val_metric
                self.bad_epochs = 0
            else:
                self.bad_epochs += 1
                if self.bad_epochs > self.patience:
                    self.factor *= self.rate
                    self.bad_epochs = 0
        return self.factor


class PlateauState:
    """The plateau schedule's state on the device, for ``--epoch_group``
    (JAX: ``plateau_state`` / ``plateau_cfg``,
    ``mimrl_tpu/train/steps.py:802-821``): the factor and the best valid
    loss in float64, whether a best exists, and the bad epochs.

    ``step(loss_sum, n)`` follows ``LRScheduler.step`` exactly, with the
    valid loss ``loss_sum / n`` in float64 as the host's
    ``float(loss_sum) / n`` and the factor's products in float64 as the
    host's, so the rates it writes are the host's bit for bit. Every
    operation is a device operation (``torch.where``, in place): nothing
    waits for the device. ``state_dict(values)`` turns fetched values
    back into ``LRScheduler``'s state."""

    def __init__(self, schedule: LRScheduler, device):
        if schedule.kind != "plateau":
            raise ValueError(f"a {schedule.kind!r} schedule has no plateau "
                             "state")
        self.rate, self.patience = schedule.rate, schedule.patience
        self.mode = schedule.mode

        def full(value, dtype):
            return torch.full((), value, dtype=dtype, device=device)

        self.factor = full(schedule.factor, torch.float64)
        have = schedule.best is not None
        self.best = full(schedule.best if have else 0.0, torch.float64)
        self.have_best = full(have, torch.bool)
        self.bad = full(schedule.bad_epochs, torch.int64)

    @torch.no_grad()
    def step(self, loss_sum: torch.Tensor, n: int) -> torch.Tensor:
        """Advance one epoch on the valid loss ``loss_sum / n`` (a float32
        device sum over ``n`` batches); returns the factor (float64)."""
        val = loss_sum.double() / n
        improved = val < self.best if self.mode == "min" else val > self.best
        better = improved | ~self.have_best
        bad = torch.where(better, torch.zeros_like(self.bad), self.bad + 1)
        decay = ~better & (bad > self.patience)
        self.best.copy_(torch.where(better, val, self.best))
        self.have_best.fill_(True)
        self.factor.copy_(torch.where(decay, self.factor * self.rate,
                                      self.factor))
        self.bad.copy_(torch.where(decay, torch.zeros_like(bad), bad))
        return self.factor

    def values(self) -> Dict[str, torch.Tensor]:
        """Copies of the state tensors, to fetch to the host."""
        return {"factor": self.factor.clone(), "best": self.best.clone(),
                "have_best": self.have_best.clone(), "bad": self.bad.clone()}

    def state_dict(self, values: Dict, epoch: int) -> Dict:
        """``LRScheduler.state_dict()`` from fetched ``values()`` after
        ``epoch`` schedule steps."""
        return {"kind": "plateau", "factor": float(values["factor"]),
                "epoch": epoch,
                "best": float(values["best"]) if values["have_best"] else None,
                "bad_epochs": int(values["bad"])}
