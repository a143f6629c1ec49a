"""The training loop: two-stage epochs, evaluation, model selection,
checkpoints and the run log (PyTorch port of the per-batch path of
``mimrl_tpu.train.solver``; ref: Solver.py:18-531).

Same epoch structure, label routing, score routing, dual best-model
tracking, epoch log line and telemetry channels as the JAX package. The
host loop feeds batches to ``train/steps.py`` and keeps every loss, MI
value and output on the device until the epoch ends.

Checkpoints carry the whole training state (``core/checkpoint.py``), so
``--resume <task dir>`` continues a run from its ``latest`` slot as if it
had not stopped: the loader's pass counter, the schedule's state and the
random generators' states are restored besides the weights, the
optimizers' moments and the feature bank. SIGTERM or SIGINT during
``solve`` stops the run after the current epoch, with ``latest`` written
(graceful preemption, as in ``mimrl_tpu/train/solver.py``).
``--bert_weights`` loads pretrained BERT weights after the random init.

The schedule rungs (ref: ``mimrl_tpu/train/solver.py:495-697``):

- per batch (the default): the loader feeds each step; ``--fast_stage1``
  runs one forward per batch and ``stage1_n`` critic updates on the cached
  features; with ``--num_workers`` > 0 stage 2's host batches are built on
  a background thread, in page-locked memory, and copied without blocking
  the host;
- ``--epoch_scan``: the epoch is stacked on the device once (one shuffle
  for stage 1 and stage 2, one loader pass per epoch, as the JAX scan
  does; the valid and test stacks are built once) and each stage runs as
  an epoch function of ``train/steps.py`` whose step bodies
  ``train/graphs.py`` captures in CUDA graphs and replays per batch.
  Stage 1 takes a fresh forward per pass and batch, or with
  ``--fast_stage1`` one forward per batch, or with ``--stage1_cached`` the
  previous epoch's bank. With ``--pipeline_epochs`` (the default) and a
  schedule that does not read the valid metric, epoch e + 1 is dispatched
  before epoch e's host work (scores, logs, checkpoints), from a snapshot
  taken at its dispatch.

Not ported, and refused with a ``NotImplementedError`` that names
ROADMAP.md: ``--epoch_group``, ``--check_gradient``, ``--custom_loss``,
``--profile_dir``, ``--distributed`` and a mesh over more than one device.
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mimrl_tpu_torch.core.checkpoint import (SLOT_FORMAT, CheckpointManager,
                                             is_full_slot)
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.core.logging import ScalarWriter, log_message, set_logger
from mimrl_tpu_torch.data.pipeline import prefetch
from mimrl_tpu_torch.data.tokenizer import build_tokenizer
from mimrl_tpu_torch.data.universal import (get_data_loader,
                                            get_label_from_datas,
                                            uses_raw_text)
from mimrl_tpu_torch.device import resolve_device
from mimrl_tpu_torch.eval.metrics import (current_result_better,
                                          get_score_from_result)
from mimrl_tpu_torch.models.bert import load_bert_weights
from mimrl_tpu_torch.models.model import (MODEL_INPUTS, build_model,
                                          init_weights)
from mimrl_tpu_torch.train import steps
from mimrl_tpu_torch.train.graphs import StepGraphs
from mimrl_tpu_torch.train.optim import (LRScheduler, make_main_optimizer,
                                         make_vmi_optimizer, partition_params)

MI_NAMES = ("ft", "fa", "fv", "in", "spec_t", "spec_a", "spec_v", "comp")


def _refuse_unported(opt: MimrlConfig) -> None:
    unported = {
        "--epoch_group > 1": opt.epoch_group > 1,
        "--check_gradient": opt.check_gradient,
        "--custom_loss": bool(opt.custom_loss),
        "--profile_dir": bool(opt.profile_dir),
        "--distributed": opt.distributed,
        "a mesh over more than one device (--mesh_data/--mesh_model/"
        "--mesh_pipe/--mesh_dcn)": (
            opt.mesh_data > 1 or opt.mesh_model > 1 or opt.mesh_pipe > 1
            or opt.mesh_dcn > 1),
        "--fusion other than cubemlp": opt.fusion != "cubemlp",
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            "not ported to mimrl_tpu_torch yet (ROADMAP.md, Open items): "
            + "; ".join(asked))


class Solver:
    """Builds data, model and optimizers for a config and trains it.

    Runs on the CUDA device unless ``device`` (or ``opt.device``) asks for
    the CPU. Random state: the Solver owns one ``torch.Generator`` on its
    device, seeded from ``opt.seed``, for the kNN anchors and the attention
    dropout seeds; ``nn.Dropout`` takes no generator, so the Solver also
    seeds torch's default generators from ``opt.seed``, once, here.
    Weights are drawn from a CPU generator seeded the same way, so they do
    not depend on the device. A checkpoint saves all three generators'
    states, which ``--resume`` restores.

    ``graphs=False`` runs the ``--epoch_scan`` step bodies eagerly on the
    card too, as the reference that the captured run must equal.
    """

    def __init__(self, opt: MimrlConfig, device=None, graphs: bool = True):
        _refuse_unported(opt)
        self.opt = opt
        self.device = resolve_device(device if device is not None
                                     else opt.device)
        self.task_path, self.writer, self.ckpt = self.prepare_checkpoint_log()
        log_message(str(opt))
        log_message("Making logger and dataset...")

        self.raw_text = uses_raw_text(opt)  # else dense text, no BERT
        self.tokenizer = build_tokenizer(opt.bert_vocab)
        (self.train_loader, self.valid_loader, self.test_loader,
         self.d_t, self.d_a, self.d_v) = get_data_loader(opt, self.tokenizer)

        log_message("Making model and optimizer...")
        torch.manual_seed(opt.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(opt.seed)
        self.graphs = StepGraphs(self.device, [self.generator], enabled=graphs)
        self.model = build_model(opt, self.tokenizer.vocab_size, self.d_a,
                                 self.d_v, self.device, d_t=self.d_t,
                                 raw_text=self.raw_text)
        init_weights(self.model, torch.Generator().manual_seed(opt.seed))
        if opt.bert_weights and self.raw_text:
            load_bert_weights(opt.bert_weights, self.model.bertmodel)
            log_message(f"Loaded BERT weights from {opt.bert_weights}")
        if opt.print_params:
            for name, _ in self.model.named_parameters():
                log_message("\t" + name)

        # optimizers + schedules (dual, ref: Solver.py:119-170)
        params_main, params_bert, params_vmi = partition_params(self.model)
        log_message("Parameters: " + ", ".join(
            f"{group} {sum(p.numel() for p in params.values())}"
            for group, params in (("main", params_main), ("bert", params_bert),
                                  ("vmi", params_vmi))))
        self.opt_main = make_main_optimizer(opt, params_main, params_bert)
        self.opt_vmi = make_vmi_optimizer(opt, params_vmi)
        self.lr_schedule = LRScheduler(opt)
        self.base_lr_main = opt.learning_rate
        self.base_lr_vmi = opt.learning_rate * opt.mi_lr_rate

        # feature banks: one row per train-step sample; the epoch reads
        # `bank` and writes `new_bank`, which is then copied into `bank`
        # (both stay in place: captured steps hold their addresses)
        self.n_bank = len(self.train_loader) * opt.batch_size
        n_valid = min(len(self.train_loader.ds), self.n_bank)
        bank_kw = dict(n_bank=self.n_bank, n_valid=n_valid,
                       d_common=opt.d_common, d_fused=self.model.classify_dim,
                       dtype=getattr(torch, opt.bank_dtype),
                       device=self.device)
        self.bank = steps.FeatureBank(**bank_kw)
        self.new_bank = steps.FeatureBank(**bank_kw)
        self.have_bank = False  # epoch-0 semantics (ref: Customization.py:97)
        # mean critic loss of each stage-1 pass of the last epoch
        self.stage1_pass_losses: List[float] = []

        # --epoch_scan: dataset-order tensors and the unshuffled splits'
        # stacks on the device, by loader
        self._flats: Dict = {}
        self._stacks: Dict = {}

        self.start_epoch = 0
        self._preempted = False
        self._prev_handlers = None
        if opt.resume:
            self._resume(opt.resume)

    # ------------------------------------------------------------------ #
    def prepare_checkpoint_log(self):
        task_path = os.path.join(self.opt.task_dir, self.opt.task_name)
        os.makedirs(task_path, exist_ok=True)
        set_logger(os.path.join(task_path, "Running.log"))
        writer = ScalarWriter(task_path)
        ckpt = CheckpointManager(task_path)
        ckpt.save_config(self.opt.to_json())
        return task_path, writer, ckpt

    def _host(self, batch: Dict):
        """Host batch -> (CPU tensors and labels, page-locked on the card's
        runs, host labels, host sample mask)."""
        labels = np.asarray(get_label_from_datas(self.opt, batch))
        tensors = steps.host_tensors(batch, labels, self.opt.task,
                                     pin=self.device.type == "cuda")
        return tensors, labels, batch["sample_mask"]

    def _to_device(self, host):
        """``_host``'s result -> (device batch, device labels, host labels,
        host sample mask), copied in stream order."""
        (model_batch, labels), labels_np, mask = host
        return ({k: v.to(self.device, non_blocking=True)
                 for k, v in model_batch.items()},
                labels.to(self.device, non_blocking=True), labels_np, mask)

    def _prep(self, batch: Dict):
        """Host batch -> (device batch, device labels, host labels)."""
        return self._to_device(self._host(batch))[:3]

    def _snapshot(self, epoch: int) -> Dict:
        """The whole training state after ``epoch``, as a slot holds it
        (``core/checkpoint.py``): copies, so the steps cannot change it."""
        rng = {"solver": self.generator.get_state(),
               "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"format": SLOT_FORMAT, "epoch": epoch,
                "model": {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()},
                "opt_main": self.opt_main.state_dict(),
                "opt_vmi": self.opt_vmi.state_dict(),
                "bank": self.bank.state_dict(), "have_bank": self.have_bank,
                "lr_schedule": self.lr_schedule.state_dict(),
                "loader_passes": self.train_loader.passes, "rng": rng}

    def _resume(self, resume_dir: str) -> None:
        """Continue from the ``latest`` slot of ``resume_dir``: the next
        epoch runs as it would have in the run that wrote the slot."""
        mgr = CheckpointManager(resume_dir)
        state = mgr.restore("latest", map_location="cpu")
        if state is None:
            if os.path.exists(mgr.jax_path("latest")):
                raise NotImplementedError(
                    f"{mgr.jax_path('latest')} is a mimrl_tpu slot: resuming "
                    "its optax moments is not ported to mimrl_tpu_torch yet "
                    "(ROADMAP.md, Open items); Predictor serves it")
            log_message(f"No latest checkpoint in {resume_dir}; fresh start")
            return
        if not is_full_slot(state):
            raise ValueError(f"{resume_dir}: the latest slot holds the model "
                             "alone, not a training state to resume")
        rng = state["rng"]
        if ("cuda" in rng) != (self.device.type == "cuda"):
            raise ValueError(f"{resume_dir}: the latest slot was written on "
                             f"another device type than {self.device.type}")
        self.model.load_state_dict(state["model"], strict=True)
        self.opt_main.load_state_dict(state["opt_main"])
        self.opt_vmi.load_state_dict(state["opt_vmi"])
        self.bank.load_state_dict(state["bank"])
        self.have_bank = bool(state["have_bank"])
        self.lr_schedule.load_state_dict(state["lr_schedule"])
        self.opt_main.learning_rate = self.base_lr_main * self.lr_schedule.factor
        self.opt_vmi.learning_rate = self.base_lr_vmi * self.lr_schedule.factor
        self.train_loader.passes = state["loader_passes"]
        self.generator.set_state(rng["solver"])
        torch.set_rng_state(rng["cpu"])
        if "cuda" in rng:
            torch.cuda.set_rng_state(rng["cuda"], self.device)
        self.start_epoch = int(state["epoch"]) + 1
        log_message(f"Resumed from {resume_dir} at epoch {self.start_epoch}")

    # ------------------------------------------------------------------ #
    def train(self, epoch: int):
        """One epoch: stage 1 (critics) x stage1_n, then stage 2 (main)
        (ref: Solver.py:194-248)."""
        opt = self.opt
        t_stage1 = time.time()
        n = len(self.train_loader)
        running_loss_mi = 0.0
        self.stage1_pass_losses = []

        # Stage 1 (skipped at epoch 0, ref: Solver.py:201-203)
        if epoch > 0 and self.have_bank:
            if opt.fast_stage1:
                # one forward per batch, stage1_n critic updates on the
                # cached features (ref: mimrl_tpu/train/solver.py:511-530)
                cached = []
                for batch in self.train_loader:
                    model_batch, labels_dev, _ = self._prep(batch)
                    cached.append((steps.features_step(
                        self.model, model_batch, self.generator), labels_dev))
                passes = [[steps.critic_update(
                    self.model, self.opt_vmi, opt, feats, labels_dev,
                    self.bank, self.generator)[0]
                    for feats, labels_dev in cached]
                    for _ in range(opt.stage1_n)]
            else:
                passes = []
                for _ in range(opt.stage1_n):
                    mi_losses = []
                    for batch in self.train_loader:
                        model_batch, labels_dev, _ = self._prep(batch)
                        loss, _mis = steps.critic_step(
                            self.model, self.opt_vmi, opt, model_batch,
                            labels_dev, self.bank, self.generator)
                        mi_losses.append(loss)
                    passes.append(mi_losses)
            for mi_losses in passes:
                pass_loss = float(torch.stack(mi_losses).sum())
                running_loss_mi += pass_loss
                self.stage1_pass_losses.append(pass_loss / n)
        self._synchronize()
        t_stage2 = time.time()
        log_message(f"  stage1: {t_stage2 - t_stage1:.2f}s" + "".join(
            f" pass{i + 1}:[{l:.4f}]"
            for i, l in enumerate(self.stage1_pass_losses)))

        # Stage 2
        use_mi = self.have_bank
        self.new_bank.zero_()
        offset = 0
        step_losses, step_mis, outs, masks, targets = [], [], [], [], []
        host_batches = map(self._host, self.train_loader)
        if opt.num_workers > 0:  # ref: mimrl_tpu/train/solver.py:559-560
            host_batches = prefetch(host_batches, 2)
        for host in host_batches:
            model_batch, labels_dev, labels_np, sample_mask = self._to_device(host)
            loss, mis, out = steps.train_step(
                self.model, self.opt_main, opt, model_batch, labels_dev,
                self.bank, self.new_bank, offset, self.generator, use_mi)
            # device tensors are kept; converting here would synchronise
            # the host on every step
            step_losses.append(loss)
            step_mis.append(mis)
            outs.append(out)
            masks.append(np.asarray(sample_mask) > 0.5)
            targets.append(labels_np)
            offset += opt.batch_size
        self._synchronize()
        log_message(f"  stage2: {time.time() - t_stage2:.2f}s")

        running_loss = float(torch.stack(step_losses).sum())
        mis_sum = torch.stack(step_mis).sum(dim=0).cpu().numpy()
        self.bank.copy_(self.new_bank)
        self.have_bank = True
        predictions = np.concatenate(
            [o.float().cpu().numpy()[m] for o, m in zip(outs, masks)])
        targets = np.concatenate([t[m] for t, m in zip(targets, masks)])
        train_score = get_score_from_result(
            predictions, targets, opt.dataset, opt.task, opt.num_class)
        return (running_loss / n, running_loss_mi / n,
                (mis_sum / n).tolist(), train_score)

    def evaluate(self, loader):
        """No-grad eval pass (ref: Solver.py:250-270)."""
        opt = self.opt
        use_mi = self.have_bank
        losses, mis_list, outs, masks, targets, features = [], [], [], [], [], []
        for batch in loader:
            model_batch, labels_dev, labels_np = self._prep(batch)
            loss, mis, out, feats = steps.eval_step(
                self.model, opt, model_batch, labels_dev, self.bank,
                self.generator, use_mi)
            losses.append(loss)
            mis_list.append(mis)
            outs.append(out)
            masks.append(batch["sample_mask"] > 0.5)
            targets.append(labels_np)
            if opt.save_best_features:
                features.append(feats)

        n = len(loader)
        predictions = np.concatenate(
            [o.float().cpu().numpy()[m] for o, m in zip(outs, masks)])
        targets = np.concatenate([t[m] for t, m in zip(targets, masks)])
        if opt.save_best_features:
            features = [[f.float().cpu().numpy()[m] for f in fl]
                        for fl, m in zip(features, masks)]
        score = get_score_from_result(predictions, targets, opt.dataset,
                                      opt.task, opt.num_class)
        avg_loss = float(torch.stack(losses).sum()) / n
        avg_mis = (torch.stack(mis_list).sum(dim=0).cpu().numpy() / n).tolist()
        return (avg_loss, avg_mis, score, predictions, targets,
                features if opt.save_best_features else None)

    # ------------------------------------------------------------------ #
    # --epoch_scan (ref: mimrl_tpu/train/solver.py:300-494, :595-697)
    def _stack_epoch(self, loader):
        """The epoch's batches stacked on the device: ([NB, bs, ...] model
        inputs and sample mask, [NB, bs] labels, host labels per batch,
        host masks per batch). The dataset-order tensors are uploaded once;
        each epoch gathers them by the loader's own plan for the pass with
        the seed ``seed + passes`` and advances ``passes`` by one, as JAX's
        ``_stack_epoch_device_shuffle`` does. AVEC2019's random-word tokens
        are drawn anew each pass, after its shuffle, and uploaded for that
        pass (JAX restacks such an epoch from its loader,
        ``mimrl_tpu/train/solver.py:329-333``). Unshuffled loaders of fixed
        tensors (the valid and test splits) are stacked once."""
        if loader in self._stacks:
            return self._stacks[loader]
        if loader not in self._flats:
            fields = [("audio", loader._audio), ("video", loader._video)]
            if loader._text_feat is not None:
                fields.append(("text", loader._text_feat))
            if loader._tokens is not None:
                fields += zip(MODEL_INPUTS[:3], loader._tokens)
            self._flats[loader] = {k: torch.from_numpy(v).to(self.device)
                                   for k, v in fields}
        idx_plan, mask_plan, tokens = loader.next_epoch()
        flats = self._flats[loader]
        if not loader.static_tensors:
            flats = dict(flats, **{k: torch.from_numpy(v).to(self.device)
                                   for k, v in zip(MODEL_INPUTS[:3], tokens)})
        idx = torch.from_numpy(idx_plan).to(self.device)
        batches = {k: v[idx] for k, v in flats.items()}
        batches["sample_mask"] = torch.from_numpy(mask_plan).to(self.device)
        ds_labels = [np.asarray(lab) for lab in loader.ds.labels]
        labels_np = [np.asarray(get_label_from_datas(
            self.opt, {"labels": [lab[i] for lab in ds_labels]}))
            for i in idx_plan]
        labels = torch.from_numpy(np.stack(labels_np).astype(
            np.int64 if self.opt.task == "classification" else np.float32))
        result = (batches, labels.to(self.device), labels_np,
                  [m > 0.5 for m in mask_plan])
        if not loader.shuffle and loader.static_tensors:
            self._stacks[loader] = result
        return result

    def _train_epoch_scan_dispatch(self, epoch: int):
        """Enqueue the epoch's stages; returns ``finalize()``, which waits
        for them and returns what ``train`` returns."""
        opt = self.opt
        batches, labels, labels_np, masks = self._stack_epoch(self.train_loader)
        nb = len(self.train_loader)
        t0 = time.time()
        pass_sums = None
        if epoch > 0 and self.have_bank:
            if opt.stage1_cached:
                pass_sums = steps.critic_epoch_cached(
                    self.model, self.opt_vmi, opt, self.bank, nb,
                    self.generator, opt.stage1_n, run=self.graphs)
            else:
                critic = (steps.critic_epoch if opt.fast_stage1
                          else steps.critic_epoch_fresh)
                pass_sums = critic(self.model, self.opt_vmi, opt, batches,
                                   labels, self.bank, self.generator,
                                   opt.stage1_n, run=self.graphs)
        use_mi = self.have_bank
        self.new_bank.zero_()
        losses, mis, outs = steps.train_epoch(
            self.model, self.opt_main, opt, batches, labels, self.bank,
            self.new_bank, self.generator, use_mi, run=self.graphs)
        self.bank.copy_(self.new_bank)
        self.have_bank = True
        log_message(f"  train dispatch: {time.time() - t0:.2f}s")

        def finalize():
            sums = [] if pass_sums is None else pass_sums.cpu().tolist()
            self.stage1_pass_losses = [x / nb for x in sums]
            log_message("  stage1:" + "".join(
                f" pass{i + 1}:[{l:.4f}]"
                for i, l in enumerate(self.stage1_pass_losses)))
            outs_np = outs.float().cpu().numpy()
            predictions = np.concatenate(
                [o[m] for o, m in zip(outs_np, masks)])
            targets = np.concatenate([t[m] for t, m in zip(labels_np, masks)])
            score = get_score_from_result(predictions, targets, opt.dataset,
                                          opt.task, opt.num_class)
            return (float(losses.sum()) / nb, sum(sums) / nb,
                    (mis.sum(dim=0).cpu().numpy() / nb).tolist(), score)

        return finalize

    def _evaluate_epoch_scan_dispatch(self, loader):
        """Enqueue one split's eval; returns ``finalize()``, which returns
        what ``evaluate`` returns."""
        opt = self.opt
        batches, labels, labels_np, masks = self._stack_epoch(loader)
        losses, mis, outs, feats = steps.eval_epoch(
            self.model, opt, batches, labels, self.bank, self.generator,
            self.have_bank, run=self.graphs)

        def finalize():
            n = len(loader)
            outs_np = outs.float().cpu().numpy()
            predictions = np.concatenate(
                [o[m] for o, m in zip(outs_np, masks)])
            targets = np.concatenate([t[m] for t, m in zip(labels_np, masks)])
            score = get_score_from_result(predictions, targets, opt.dataset,
                                          opt.task, opt.num_class)
            features = None
            if opt.save_best_features:
                feats_np = [f.float().cpu().numpy() for f in feats]
                features = [[f[i][m] for f in feats_np]
                            for i, m in enumerate(masks)]
            return (float(losses.sum()) / n,
                    (mis.sum(dim=0).cpu().numpy() / n).tolist(), score,
                    predictions, targets, features)

        return finalize

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    def solve(self):
        """Train from ``start_epoch`` to the last epoch, or until SIGTERM
        or SIGINT: then the current epoch ends, ``latest`` is written and
        the run returns as if it had finished. The signal handlers are
        installed for this call only (main thread only), and the first
        signal puts the previous ones back, so a second one acts at once."""
        log_message("Start training...")
        self._preempted = False
        prev_handlers = self._install_preemption_handlers()
        try:
            return self._solve_loop()
        finally:
            self._restore_signal_handlers(prev_handlers)
            self._prev_handlers = None

    def _solve_loop(self):
        opt = self.opt
        tracking = {"score": [None, None, None],  # valid, test, test at best valid
                    "predictions": [None, None, None],
                    "features": [None, None, None],
                    "targets": [None, None],
                    "valid_state": None, "test_state": None}
        # pipelined epochs (ref: mimrl_tpu/train/solver.py:1343-1446): epoch
        # e's host work overlaps epoch e + 1's device work; the schedule is
        # stepped at dispatch, so it must not read the valid metric
        pipelined = (opt.epoch_scan and opt.pipeline_epochs
                     and not self.lr_schedule.needs_metric)
        pending = None  # (epoch, t0, the three finalize()s, snapshot)
        for epoch in range(self.start_epoch, opt.epochs_num):
            t0 = time.time()
            if opt.epoch_scan:
                fins = (self._train_epoch_scan_dispatch(epoch),
                        self._evaluate_epoch_scan_dispatch(self.valid_loader),
                        self._evaluate_epoch_scan_dispatch(self.test_loader))
            else:
                results = (self.train(epoch), self.evaluate(self.valid_loader),
                           self.evaluate(self.test_loader))
                fins = tuple((lambda r=r: r) for r in results)
            if pipelined:
                self._step_schedule(None)
                snap = self._snapshot(epoch)
                if pending is not None:
                    p_epoch, p_t0, p_fins, p_snap = pending
                    # dt: dispatch to dispatch, the steady-state epoch time
                    self._finalize_epoch(tracking, p_epoch, t0 - p_t0,
                                         *(f() for f in p_fins), snap=p_snap)
                pending = (epoch, t0, fins, snap)
                if self._preempted:
                    break
                continue
            self._finalize_epoch(tracking, epoch, time.time() - t0,
                                 *(f() for f in fins))
            if self._preempted:
                self._stop_preempted(epoch, self._snapshot(epoch))
                break
        if pending is not None:
            p_epoch, p_t0, p_fins, p_snap = pending
            self._finalize_epoch(tracking, p_epoch, time.time() - p_t0,
                                 *(f() for f in p_fins), snap=p_snap)
            if self._preempted:
                self._stop_preempted(p_epoch, p_snap)
        log_message("Training complete.")
        self.writer.close()
        if tracking["score"][0] is not None:
            self.log_best_scores(tracking["score"])
        self.save_results(tracking["predictions"], tracking["targets"],
                          tracking["features"], tracking["valid_state"],
                          tracking["test_state"])
        return tracking["score"]

    def _stop_preempted(self, epoch: int, snap: Dict) -> None:
        self.ckpt.save("latest", snap)
        log_message(f"Preemption requested: checkpointed at epoch {epoch}, "
                    "stopping.")

    def _step_schedule(self, val_loss: Optional[float]) -> None:
        """Advance the learning-rate schedule one epoch and apply it to
        both optimizers (ref: Solver.py:52-57)."""
        factor = self.lr_schedule.step(val_loss)
        self.opt_main.learning_rate = self.base_lr_main * factor
        self.opt_vmi.learning_rate = self.base_lr_vmi * factor

    def _finalize_epoch(self, tracking, epoch, dt, train, valid, test,
                        snap: Optional[Dict] = None):
        """Step the learning-rate schedule (unless ``snap``, the state
        snapshot at the epoch's dispatch under pipelining, is given: the
        schedule was stepped then), track the best models, write the
        epoch's log line and scalar channels, and keep the checkpoint
        cadence."""
        opt = self.opt
        train_loss, train_loss_mi, train_mis, train_score = train
        (val_loss, val_mis, val_score, val_predictions, val_targets,
         val_features) = valid
        (test_loss, test_mis, test_score, test_predictions, test_targets,
         test_features) = test

        if snap is None:
            self._step_schedule(val_loss)

        # best-model tracking (ref: Solver.py:59-93); one snapshot of the
        # epoch serves both best slots and latest
        better_valid = current_result_better(
            tracking["score"][0], val_score, opt.task, opt.num_class,
            opt.dataset)
        better_test = current_result_better(
            tracking["score"][1], test_score, opt.task, opt.num_class,
            opt.dataset)
        save_latest = opt.save_latest_every > 0 and (
            epoch % opt.save_latest_every == opt.save_latest_every - 1
            or epoch == opt.epochs_num - 1)
        if snap is None and (save_latest or (
                opt.save_models and (better_valid or better_test))):
            snap = self._snapshot(epoch)
        factor = (self.lr_schedule.factor if snap is None
                  else snap["lr_schedule"]["factor"])
        if better_valid:
            log_message("Better valid score found...")
            if opt.save_models:
                tracking["valid_state"] = snap
            tracking["score"][0] = val_score
            tracking["predictions"][0] = val_predictions
            tracking["features"][0] = val_features
            tracking["score"][2] = test_score
            tracking["predictions"][2] = test_predictions
            tracking["features"][2] = test_features
            tracking["targets"][0] = val_targets
        if better_test:
            log_message("Better test score found...")
            if opt.save_models:
                tracking["test_state"] = snap
            tracking["score"][1] = test_score
            tracking["predictions"][1] = test_predictions
            tracking["features"][1] = test_features
            tracking["targets"][1] = test_targets

        sps = len(self.train_loader.ds) / max(dt, 1e-9)
        msg = self.build_message(epoch, train_loss, train_mis, train_score,
                                 val_loss, val_mis, val_score, test_loss,
                                 test_mis, test_score)
        log_message(msg + f" || {dt:.1f}s {sps:.1f} samples/s"
                    + self._memory_suffix())
        self.log_scalars(epoch, train_loss, train_mis, train_score, val_loss,
                         val_mis, val_score, test_loss, test_mis, test_score,
                         self.base_lr_main * factor)
        if save_latest:
            self.ckpt.save("latest", snap)

    def request_preemption(self, *_args) -> None:
        """Stop after the current epoch, with ``latest`` written (the
        signal handler; also callable directly). The first call puts the
        previous handlers back."""
        self._preempted = True
        self._restore_signal_handlers(self._prev_handlers)
        self._prev_handlers = None

    def _install_preemption_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            return None  # signals reach the main thread only
        prev = {sig: signal.signal(sig, self.request_preemption)
                for sig in (signal.SIGTERM, signal.SIGINT)}
        self._prev_handlers = prev
        return prev

    @staticmethod
    def _restore_signal_handlers(prev) -> None:
        for sig, handler in (prev or {}).items():
            signal.signal(sig, handler)

    def _memory_suffix(self) -> str:
        if self.device.type != "cuda":
            return ""
        gib = 1024 ** 3
        return (f" device memory {torch.cuda.max_memory_allocated(self.device) / gib:.2f}"
                f"/{torch.cuda.memory_allocated(self.device) / gib:.2f} GiB peak/live")

    def build_message(self, epoch, train_loss, train_mis, train_score,
                      val_loss, val_mis, val_score, test_loss, test_mis,
                      test_score) -> str:
        """Epoch summary line (ref: Solver.py:438-459)."""

        def block(tag, loss, mis, score):
            s = f" {tag}Loss:[{loss:.3f}]"
            s += (" " + tag + "MI_ft/fa/fv/in/st/sa/sv/cp:["
                  + "/".join(f"{m:.3f}" for m in mis) + "]")
            for key in score:
                s += f" {tag}_{key}:[{score[key]:6.3f}]"
            return s

        msg = f"Epoch:[{epoch + 1:3.0f}] ||"
        msg += block("Train", train_loss, train_mis, train_score)
        msg += " ||" + block("Val", val_loss, val_mis, val_score)
        msg += " ||" + block("Test", test_loss, test_mis, test_score)
        return msg

    def build_single_message(self, score, mode):
        return mode + "".join(f" {key}:[{score[key]:6.3f}]" for key in score)

    def log_scalars(self, epoch, train_loss, train_mis, train_score, val_loss,
                    val_mis, val_score, test_loss, test_mis, test_score, lr):
        """The reference's channel names (ref: Solver.py:467-507); ``lr``
        is the rate of the next epoch."""
        for tag, loss, mis, score in (
                ("Train", train_loss, train_mis, train_score),
                ("Val", val_loss, val_mis, val_score),
                ("Test", test_loss, test_mis, test_score)):
            self.writer.add_scalar(f"{tag}/Loss", loss, epoch)
            for name, value in zip(MI_NAMES, mis):
                self.writer.add_scalar(f"{tag}/MI_{name}", value, epoch)
            for key in score:
                self.writer.add_scalar(f"{tag}/{key}", score[key], epoch)
        self.writer.add_scalar("Lr", lr, epoch)
        self.writer.flush()

    def log_best_scores(self, best_score):
        log_message(self.build_single_message(best_score[0],
                                              "Best Valid Score \t\t"))
        log_message(self.build_single_message(best_score[2],
                                              "Test Score at Best Valid \t"))
        log_message(self.build_single_message(best_score[1],
                                              "Best Test Score \t\t"))

    def save_results(self, best_predictions, best_targets, best_features,
                     best_valid_state: Optional[Dict],
                     best_test_state: Optional[Dict]):
        """(ref: Solver.py:514-531) The ``best_valid`` and ``best_test``
        slots hold the training state of their epoch; ``Predictor`` loads
        the model from them."""
        for name, array in (
                ("predictions_val", best_predictions[0]),
                ("predictions_test", best_predictions[1]),
                ("predictions_test_for_valid", best_predictions[2]),
                ("targets_val", best_targets[0]),
                ("targets_test", best_targets[1])):
            np.save(os.path.join(self.task_path, f"{name}.npy"), array)
        if self.opt.save_best_features:
            for name, feats in (("features_val", best_features[0]),
                                ("features_test", best_features[1]),
                                ("features_test_for_valid", best_features[2])):
                with open(os.path.join(self.task_path, f"{name}.pkl"),
                          "wb") as f:
                    pickle.dump(feats, f)
        if best_valid_state is not None:
            self.ckpt.save("best_valid", best_valid_state)
        if best_test_state is not None:
            self.ckpt.save("best_test", best_test_state)
