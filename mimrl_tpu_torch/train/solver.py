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

``--epoch_group G`` (ref: ``mimrl_tpu/train/solver.py:699-1140``), on
``--epoch_scan``: epoch 0 runs on the per-epoch path (its bank is empty),
then every G epochs are enqueued at once with no wait for the device
between them. The G train plans (and AVEC's token plans of each split) are
drawn as G per-epoch passes would draw them and uploaded once; each epoch
replays the rung's step graphs, then the selection of ``train/steps.py``
(``selection_metric``) keeps the best-valid and best-test models on the
device, replaced under a device flag (a captured graph on the card); under
``--lr_decrease plateau`` the schedule steps on the device
(``train/optim.py::PlateauState``). One copy per group brings the
per-epoch results to the host, while the next group runs; the host then
replays the device's decisions into the same log lines, ``scalars.jsonl``
records and best-model bookkeeping as per-epoch runs write. A run that
cannot be grouped (no ``--epoch_scan``, ``--check_gradient``,
``--profile_dir``) logs JAX's warning and runs per epoch.

The single-device tools (ref: ``mimrl_tpu/train/solver.py``):

- ``--custom_loss module:factory``: the hook of ``train/custom.py``,
  resolved once here, added to stage 2's objective and the eval loss on
  every path (the rungs' graphs capture it);
- ``--check_gradient``: after each critic step and each stage-2 step with
  MI, ``_log_gradients`` logs every non-BERT parameter's name, sum and
  gradient sum (``steps.grad_debug_step``, :1143-1157). It runs the epochs
  per batch, as JAX does (``scan_mode``, :1359);
- ``--profile_dir``: a ``torch.profiler`` trace (CPU and CUDA activities)
  of epoch ``start_epoch + 1``, written as chrome-trace JSON by
  ``tensorboard_trace_handler`` (:1371-1373, :1419-1422); the run is not
  pipelined, so the trace holds exactly that epoch.

The mesh (ref: ``mimrl_tpu/train/solver.py:169-209``,
``parallel/mesh.py``): with a ``torch.distributed`` group of more than one
rank (``cli/main.py`` starts one rank per visible card, or joins
torchrun's group under ``--distributed``), a mesh request
(``--mesh_data``, default -1 = every rank, ``--mesh_model``,
``--mesh_pipe``, ``--mesh_dcn``) builds the ``(dcn, data, pipe, model)``
mesh over the ranks. Each rank holds its rows of every batch's model
inputs (the same shuffle on every rank: the loaders draw from ``seed +
passes``), the global labels and sample mask, and the whole host state:
outputs and
features are gathered, so scores, model selection, the bank and the
checkpoint cadence are the same on every rank. Rank 0 alone writes the
log, the scalars, the predictions and the slots; a slot holds whole
tensors (``core/checkpoint.py::whole_slot``). ``--flash_attn auto`` means
the plain attention on a mesh, as in JAX (``:79-88``), ``on`` is
honoured, and ``--seq_shard`` takes the plain route and runs BERT
sequence parallel over ``model`` (``parallel/mesh.py``): its activations
between products are time slices (not on a ``pipe`` axis, and not with
``--quant``, which raises). The ``--epoch_scan``
steps are captured with their collectives under NCCL; gloo's collectives
cannot be captured, so on a gloo group they run eagerly
(``train/graphs.py``). On a ``pipe`` axis (``--mesh_pipe``,
``--pipe_microbatches``, ``--pipe_virtual``, ``--pipe_remat``) BERT's
layers run as ``parallel/pipeline.py``'s schedule; every rank holds every
parameter, and the steps run eagerly under either backend.
``--epoch_group`` groups on a ``dcn x data`` mesh; a ``pipe`` or
``model`` axis runs per epoch (``_group_mesh_ok``). A mesh request with
one rank logs JAX's warning and runs unsharded.

``--ckpt_backend orbax`` writes the same ``.pt`` slots as ``msgpack``, on
a background thread (``core/checkpoint.py``); the run waits for the last
write before it returns or stops, as ``mimrl_tpu``'s does. ``--resume``
reads this package's slot, else ``mimrl_tpu``'s msgpack or orbax slot.
"""

from __future__ import annotations

import functools
import os
import pickle
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mimrl_tpu_torch.core.checkpoint import (SLOT_FORMAT, CheckpointManager,
                                             is_full_slot, local_slot,
                                             WholeShapes, whole_slot)
from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.core.logging import ScalarWriter, log_message, set_logger
from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.data.pipeline import prefetch
from mimrl_tpu_torch.data.tokenizer import build_tokenizer
from mimrl_tpu_torch.data.universal import (get_data_loader,
                                            get_label_from_datas,
                                            uses_raw_text)
from mimrl_tpu_torch.device import resolve_device
from mimrl_tpu_torch.eval.metrics import (current_result_better,
                                          get_score_from_result)
from mimrl_tpu_torch.models.bert import load_bert_weights
from mimrl_tpu_torch.models.convert import (bank_state_from_jax,
                                            optimizer_states_from_jax,
                                            state_dict_from_jax_slot)
from mimrl_tpu_torch.models.model import (MODEL_INPUTS, build_model,
                                          init_weights)
from mimrl_tpu_torch.parallel.mesh import (BATCH_AXES, MODEL_AXIS, PIPE_AXIS,
                                           Mesh, make_mesh, shard_batch,
                                           shard_params)
from mimrl_tpu_torch.parallel.pipeline import check_schedule
from mimrl_tpu_torch.train import steps
from mimrl_tpu_torch.train.custom import load_custom_loss
from mimrl_tpu_torch.train.graphs import StepGraphs
from mimrl_tpu_torch.train.optim import (LRScheduler, PlateauState,
                                         make_main_optimizer,
                                         make_vmi_optimizer, partition_params)

MI_NAMES = ("ft", "fa", "fv", "in", "spec_t", "spec_a", "spec_v", "comp")


def wants_mesh(opt: MimrlConfig) -> bool:
    """A mesh is requested (ref: mimrl_tpu/train/solver.py:172-173): an
    explicit ``--mesh_data 1`` still builds one when another axis is
    asked for."""
    return (opt.mesh_data != 1 or opt.mesh_model > 1 or opt.mesh_pipe > 1
            or opt.mesh_dcn > 1)


class _NoScalars:
    """The scalar writer of a mesh rank other than 0."""

    def add_scalar(self, *_args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


_GROUP_WARNING = (  # ref: mimrl_tpu/train/solver.py:1352-1357
    "WARNING: --epoch_group requires --epoch_scan + a "
    "device-shuffle-capable (or AVEC raw-text) loader, a "
    "data-parallel-only mesh (pipe=model=1), and no "
    "check_gradient/profiling; falling back to per-epoch "
    "dispatch.")


def _host_kind(dtype: torch.dtype):
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        return np.float32
    if dtype == torch.bool:
        return np.bool_
    return np.float64 if dtype.is_floating_point else np.int64


class _Fetch:
    """Device tensors brought to the host in one copy, started when made:
    on the card into page-locked memory behind an event, so the host can
    enqueue more work before ``wait()``. The values travel as float64,
    which holds every float32, bfloat16, integer and boolean value
    exactly; ``wait()`` gives each back as numpy in its own kind (float32
    for float32 and bfloat16), and None stays None."""

    def __init__(self, tensors: Dict[str, Optional[torch.Tensor]]):
        self.specs, parts = [], []
        for name, t in tensors.items():
            if t is None:
                self.specs.append((name, None, None))
                continue
            self.specs.append((name, tuple(t.shape), _host_kind(t.dtype)))
            parts.append(t.detach().reshape(-1).to(torch.float64))
        flat = (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.float64))
        self.event = None
        self.host = flat
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=torch.float64,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> Dict[str, Optional[np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        flat, out, at = self.host.numpy(), {}, 0
        for name, shape, kind in self.specs:
            if shape is None:
                out[name] = None
                continue
            size = int(np.prod(shape))
            out[name] = flat[at:at + size].reshape(shape).astype(kind)
            at += size
        return out


def _readback(t: torch.Tensor, where: str) -> np.ndarray:
    """A device tensor as float32 numpy: a wait of the host on the device,
    in the span ``sync/<where>``."""
    with span("sync/" + where):
        return t.float().cpu().numpy()


def _part(values: Dict, prefix: str) -> Dict:
    """The entries of ``values`` under ``prefix/``, without the prefix."""
    head = prefix + "/"
    return {k[len(head):]: v for k, v in values.items() if k.startswith(head)}


class _DeviceBest:
    """A best model that ``--epoch_group`` keeps on the device (JAX: the
    ``best_v`` / ``best_t`` carry, ``mimrl_tpu/train/solver.py:1042-1061``):
    the training state's tensors by slot path (with ``--save_models``), the
    eval features of the splits it keeps (with ``--save_best_features``),
    its epoch and its selection metric, float32, seeded from the host's
    best score (or the worst value). ``update`` replaces them where a
    device flag is set. ``epoch_host`` is the epoch that the host's replay
    of the flags found."""

    def __init__(self, live: Dict[str, torch.Tensor], metric: float,
                 device):
        self.tensors = {k: torch.empty_like(v) for k, v in live.items()}
        self.feats: Dict[str, torch.Tensor] = {}
        self.metric = torch.full((), metric, dtype=torch.float32,
                                 device=device)
        self.epoch = torch.full((), -1, dtype=torch.int64, device=device)
        self.epoch_host: Optional[int] = None

    def reserve(self, feats: Dict[str, torch.Tensor]) -> None:
        """Room for the features (outside any graph capture)."""
        for k, v in feats.items():
            if k not in self.feats:
                self.feats[k] = torch.empty_like(v)

    @torch.no_grad()
    def update(self, better: torch.Tensor, metric: torch.Tensor,
               epoch: torch.Tensor, live: Dict[str, torch.Tensor],
               feats: Dict[str, torch.Tensor]) -> None:
        pairs = [(self.metric, metric), (self.epoch, epoch)]
        pairs += [(self.tensors[k], v) for k, v in live.items()]
        pairs += [(self.feats[k], v) for k, v in feats.items()]
        for dst, src in pairs:  # in place: no temporary the size of dst
            torch.where(better, src, dst, out=dst)


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

    ``mesh``: a connected ``parallel/mesh.py::Mesh`` to run on, in place of
    the one the mesh flags request over the process group (the checks use
    it for a mesh of one rank).
    """

    def __init__(self, opt: MimrlConfig, device=None, graphs: bool = True,
                 mesh: Optional[Mesh] = None):
        self.opt = opt
        self.device = resolve_device(device if device is not None
                                     else opt.device)
        # (ref: mimrl_tpu/train/solver.py:169-209) one device per rank
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        if mesh is None and wants_mesh(opt) and n_dev > 1:
            mesh = make_mesh(opt.mesh_data, opt.mesh_model, opt.mesh_pipe,
                             opt.mesh_dcn)
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0
        self.task_path, self.writer, self.ckpt = self.prepare_checkpoint_log()
        log_message(str(opt))
        log_message("Making logger and dataset...")

        self.raw_text = uses_raw_text(opt)  # else dense text, no BERT
        self.tokenizer = build_tokenizer(opt.bert_vocab)
        (self.train_loader, self.valid_loader, self.test_loader,
         self.d_t, self.d_a, self.d_v) = get_data_loader(opt, self.tokenizer)

        log_message("Making model and optimizer...")
        if wants_mesh(opt) and mesh is None:
            log_message(
                f"WARNING: --mesh_data/--mesh_model/--mesh_pipe requested "
                f"but only {n_dev} device is visible — running unsharded.")
        if opt.seq_shard and opt.mesh_model <= 1:
            log_message("WARNING: --seq_shard requires --mesh_model > 1 — "
                        "sequence parallelism is disabled.")
        if opt.fusion == "moe" and opt.moe_experts > 1 and opt.mesh_model <= 1:
            log_message("WARNING: --fusion moe with --mesh_model 1: experts "
                        "run unsharded (no expert parallelism).")
        # --custom_loss, resolved once (ref: mimrl_tpu/train/steps.py:192-195)
        self.custom_loss = load_custom_loss(opt.custom_loss, opt)
        # --check_gradient runs the epochs per batch (ref: solver.py:1359)
        self.scan_mode = opt.epoch_scan and not opt.check_gradient
        torch.manual_seed(opt.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(opt.seed)
        # gloo's collectives cannot be captured in a CUDA graph, and the
        # pipeline's steps run eagerly
        self.graphs = StepGraphs(self.device, [self.generator],
                                 enabled=graphs and (mesh is None or (
                                     mesh.capturable
                                     and mesh.shape[PIPE_AXIS] == 1)))
        seq = (mesh is not None and opt.seq_shard
               and mesh.shape[MODEL_AXIS] > 1)
        model_opt = opt
        if mesh is not None and (opt.flash_attn == "auto" or seq):
            # 'auto' is the plain attention on a mesh (ref: solver.py:79-88),
            # and the plain route serves --seq_shard (ref: bert.py:136)
            model_opt = opt.replace(flash_attn="off")
        self.model = build_model(model_opt, self.tokenizer.vocab_size,
                                 self.d_a, self.d_v, self.device, d_t=self.d_t,
                                 raw_text=self.raw_text)
        init_weights(self.model, torch.Generator().manual_seed(opt.seed))
        if opt.bert_weights and self.raw_text:
            load_bert_weights(opt.bert_weights, self.model.bertmodel)
            log_message(f"Loaded BERT weights from {opt.bert_weights}")
        self.model_blocks: List[str] = []
        if mesh is not None:
            mesh.set_batch(opt.batch_size)
            mesh.set_pipeline(opt.pipe_microbatches, opt.pipe_virtual,
                              opt.pipe_remat)
            mesh.set_sequence(seq)
            if mesh.seq_shard and opt.quant != "none":
                raise ValueError(
                    "--seq_shard with --quant: the row-parallel products "
                    "would quantise over one rank's block of their input "
                    "axis, which the unsharded product does not")
            if mesh.shape[PIPE_AXIS] > 1 and self.raw_text:
                check_schedule(opt.bert_layers, mesh.shape[PIPE_AXIS],
                               opt.pipe_microbatches, opt.pipe_virtual,
                               opt.batch_size, mesh.size(BATCH_AXES))
            self.model_blocks = shard_params(mesh, self.model)
            rows = (f"{mesh.local_batch} rows of {opt.batch_size} per rank"
                    if mesh.sharded else f"all {opt.batch_size} rows on "
                    "every rank")
            pipe = ("off" if mesh.shape[PIPE_AXIS] == 1 else
                    f"{mesh.shape[PIPE_AXIS]} stages x "
                    f"{opt.pipe_microbatches} microbatches, virtual "
                    f"{mesh.n_virtual}, remat "
                    f"{'on' if opt.pipe_remat else 'off'}")
            log_message(f"Mesh: {mesh!r}, {mesh.n_ranks} ranks; batch: "
                        f"{rows}; {len(self.model_blocks)} parameters held as "
                        f"blocks over model; sequence sharding "
                        f"{'on' if mesh.seq_shard else 'off'}; pipeline {pipe}; "
                        f"attention {model_opt.flash_attn}; step graphs "
                        f"{'on' if self.graphs.capture else 'off'}")
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
        self.opt_main.mesh = self.opt_vmi.mesh = mesh
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
        # --epoch_group: the device's best models, the plateau schedule on
        # the device, and per grouped epoch what its slot takes from the
        # host (schedule, loader passes, generators)
        self._best: Dict[str, _DeviceBest] = {}
        self._plateau: Optional[PlateauState] = None
        self._group_meta: Dict[int, Dict] = {}
        self._eval_masks: Dict[str, List] = {}  # the eval splits' host masks

        self.start_epoch = 0
        self._preempted = False
        self._prev_handlers = None
        if opt.resume:
            self._resume(opt.resume)

    # ------------------------------------------------------------------ #
    def prepare_checkpoint_log(self):
        """The run directory, its log, scalar writer and checkpoints; a
        mesh rank other than 0 writes none of them."""
        task_path = os.path.join(self.opt.task_dir, self.opt.task_name)
        if not self.is_writer:
            set_logger(None)
            return task_path, _NoScalars(), CheckpointManager(
                task_path, write=False, backend=self.opt.ckpt_backend)
        os.makedirs(task_path, exist_ok=True)
        set_logger(os.path.join(task_path, "Running.log"))
        writer = ScalarWriter(task_path)
        ckpt = CheckpointManager(task_path, backend=self.opt.ckpt_backend)
        ckpt.save_config(self.opt.to_json())
        return task_path, writer, ckpt

    def _host(self, batch: Dict):
        """Host batch -> (CPU tensors and labels, page-locked on the card's
        runs, host labels, host sample mask); on a mesh the model inputs
        are this rank's rows."""
        with span("data/copy"):
            labels = np.asarray(get_label_from_datas(self.opt, batch))
            if self.mesh is not None and self.mesh.sharded:
                batch = dict(batch, **shard_batch(self.mesh, {
                    k: batch[k] for k in MODEL_INPUTS if k in batch}))
            tensors = steps.host_tensors(batch, labels, self.opt.task,
                                         pin=self.device.type == "cuda")
        return tensors, labels, batch["sample_mask"]

    def _to_device(self, host):
        """``_host``'s result -> (device batch, device labels, host labels,
        host sample mask), copied in stream order."""
        (model_batch, labels), labels_np, mask = host
        with span("data/copy"):
            return ({k: v.to(self.device, non_blocking=True)
                     for k, v in model_batch.items()},
                    labels.to(self.device, non_blocking=True), labels_np, mask)

    def _prep(self, batch: Dict):
        """Host batch -> (device batch, device labels, host labels)."""
        return self._to_device(self._host(batch))[:3]

    def _snapshot(self, epoch: int) -> Dict:
        """The whole training state after ``epoch``, as a slot holds it
        (``core/checkpoint.py``): copies, so the steps cannot change it;
        on a mesh with model-sharded parameters, gathered whole (every
        rank takes part)."""
        snap = {"format": SLOT_FORMAT, "epoch": epoch,
               "model": {k: v.detach().clone()
                         for k, v in self.model.state_dict().items()},
               "opt_main": self.opt_main.state_dict(),
               "opt_vmi": self.opt_vmi.state_dict(),
               "bank": self.bank.state_dict(), "have_bank": self.have_bank,
               "lr_schedule": self.lr_schedule.state_dict(),
               "loader_passes": self.train_loader.passes,
               "rng": self._rng_state()}
        if self.model_blocks:
            snap = whole_slot(self.mesh, self.model, self._optimizers(), snap)
        return snap

    def _optimizers(self) -> Dict:
        return {"opt_main": self.opt_main, "opt_vmi": self.opt_vmi}

    def _rng_state(self) -> Dict[str, torch.Tensor]:
        """The three generators' states (host reads: nothing waits)."""
        rng = {"solver": self.generator.get_state(),
               "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return rng

    def _resume(self, resume_dir: str) -> None:
        """Continue from the ``latest`` slot of ``resume_dir``: the next
        epoch runs as it would have in the run that wrote the slot."""
        mgr = CheckpointManager(resume_dir)
        state = mgr.restore("latest", map_location="cpu")
        if state is None:
            path = mgr.jax_slot_path("latest")
            if path is None:
                log_message(f"No latest checkpoint in {resume_dir}; fresh "
                            "start")
                return
            state = self._slot_from_jax(mgr.restore_jax("latest"), path)
        if not is_full_slot(state):
            raise ValueError(f"{resume_dir}: the latest slot holds the model "
                             "alone, not a training state to resume")
        rng = state["rng"]
        if ("cuda" in rng) != (self.device.type == "cuda"):
            raise ValueError(f"{resume_dir}: the latest slot was written on "
                             f"another device type than {self.device.type}")
        if self.model_blocks:  # a slot holds whole tensors: take this rank's
            state = local_slot(self.mesh, self.model, self._optimizers(),
                               state)
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

    def _passes_through(self, epoch: int) -> int:
        """The train loader's passes at the end of ``epoch`` in a run of
        this config: one a stage-2 pass, and from epoch 1 on, per batch,
        ``stage1_n`` stage-1 passes before it (one under
        ``--fast_stage1``); the ``--epoch_scan`` rung draws one an
        epoch."""
        if self.scan_mode:
            return epoch + 1
        stage1 = 1 if self.opt.fast_stage1 else self.opt.stage1_n
        return epoch + 1 + epoch * stage1

    def _slot_from_jax(self, slot: Dict, path: str) -> Dict:
        """A ``mimrl_tpu`` ``latest``, msgpack or orbax (``core/checkpoint.py``
        of the JAX package: the three parameter groups, both optax states, the
        bank, ``lr_factor``, ``global_step``, ``epoch``) as this package's
        slot: parameters by ``models/convert.py::state_dict_from_jax``,
        optax's count, mu and nu onto the flat moments in their dtypes, the
        bank (present). JAX saves neither the loader's pass counter nor the
        schedule's epoch (nor, under plateau, its best and bad epochs) nor
        any generator state: the passes and the schedule's epoch are what
        this run would have reached at the slot's epoch, the plateau state
        starts empty and the generators keep their seeded states; one log
        line names each."""
        epoch = int(slot["epoch"])
        schedule = {"kind": self.lr_schedule.kind,
                    "factor": float(slot["lr_factor"]), "epoch": epoch + 1}
        derived = {"loader_passes": self._passes_through(epoch),
                   "schedule epoch": epoch + 1}
        if self.lr_schedule.kind == "plateau":
            schedule.update(best=None, bad_epochs=0)
            derived.update({"plateau best": None, "plateau bad epochs": 0})
        derived["generators"] = f"seeded from --seed {self.opt.seed}"
        log_message(f"{path} is a mimrl_tpu slot; state it does not hold: "
                    + ", ".join(f"{k} = {v}" for k, v in derived.items()))
        view = (WholeShapes(self.mesh, self.model) if self.model_blocks
                else self.model)  # a slot of whole tensors, as a port slot
        return {"format": SLOT_FORMAT, "epoch": epoch,
                "model": state_dict_from_jax_slot(slot, view),
                **optimizer_states_from_jax(slot, view, self._optimizers()),
                "bank": bank_state_from_jax(slot, self.bank),
                "have_bank": True, "lr_schedule": schedule,
                "loader_passes": derived["loader_passes"],
                "rng": self._rng_state()}

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
        with span("solver/stage1"):
            if epoch > 0 and self.have_bank:
                passes = self._stage1()
                for mi_losses in passes:
                    with span("sync/stage1_loss"):
                        pass_loss = float(torch.stack(mi_losses).sum())
                    running_loss_mi += pass_loss
                    self.stage1_pass_losses.append(pass_loss / n)
            with span("sync/stage1_end"):
                self._synchronize()
        t_stage2 = time.time()
        log_message(f"  stage1: {t_stage2 - t_stage1:.2f}s" + "".join(
            f" pass{i + 1}:[{l:.4f}]"
            for i, l in enumerate(self.stage1_pass_losses)))

        # Stage 2
        with span("solver/stage2"):
            use_mi = self.have_bank
            self.new_bank.zero_()
            offset = 0
            step_losses, step_mis, outs, masks, targets = [], [], [], [], []
            host_batches = map(self._host, self.train_loader)
            if opt.num_workers > 0:  # ref: mimrl_tpu/train/solver.py:559-560
                host_batches = prefetch(host_batches, 2)
            for host in host_batches:
                (model_batch, labels_dev, labels_np,
                 sample_mask) = self._to_device(host)
                loss, mis, out = steps.train_step(
                    self.model, self.opt_main, opt, model_batch, labels_dev,
                    self.bank, self.new_bank, offset, self.generator, use_mi,
                    custom_loss=self.custom_loss)
                if opt.check_gradient and use_mi:
                    self._log_gradients(model_batch, labels_dev, 2)
                # device tensors are kept; converting here would
                # synchronise the host on every step
                step_losses.append(loss)
                step_mis.append(mis)
                outs.append(out)
                masks.append(np.asarray(sample_mask) > 0.5)
                targets.append(labels_np)
                offset += opt.batch_size
            with span("sync/stage2_end"):
                self._synchronize()
            log_message(f"  stage2: {time.time() - t_stage2:.2f}s")

            with span("sync/train_readback"):
                running_loss = float(torch.stack(step_losses).sum())
            mis_sum = _readback(torch.stack(step_mis).sum(dim=0),
                                "train_readback")
            self.bank.copy_(self.new_bank)
            self.have_bank = True
            predictions = np.concatenate(
                [_readback(o, "train_readback")[m]
                 for o, m in zip(outs, masks)])
            targets = np.concatenate([t[m] for t, m in zip(targets, masks)])
            train_score = get_score_from_result(
                predictions, targets, opt.dataset, opt.task, opt.num_class)
        return (running_loss / n, running_loss_mi / n,
                (mis_sum / n).tolist(), train_score)

    def _stage1(self) -> List[List[torch.Tensor]]:
        """Stage 1's critic updates: their losses, as device tensors, per
        pass over the train split."""
        opt = self.opt
        if opt.fast_stage1:
            # one forward per batch, stage1_n critic updates on the
            # cached features (ref: mimrl_tpu/train/solver.py:511-530)
            cached = []
            for batch in self.train_loader:
                model_batch, labels_dev, _ = self._prep(batch)
                cached.append((steps.features_step(
                    self.model, model_batch, self.generator), labels_dev))
            return [[steps.critic_update(
                self.model, self.opt_vmi, opt, feats, labels_dev,
                self.bank, self.generator)[0]
                for feats, labels_dev in cached]
                for _ in range(opt.stage1_n)]
        passes = []
        for _ in range(opt.stage1_n):
            mi_losses = []
            for batch in self.train_loader:
                model_batch, labels_dev, _ = self._prep(batch)
                loss, _mis = steps.critic_step(
                    self.model, self.opt_vmi, opt, model_batch,
                    labels_dev, self.bank, self.generator)
                mi_losses.append(loss)
                if opt.check_gradient:
                    self._log_gradients(model_batch, labels_dev, 1)
            passes.append(mi_losses)
        return passes

    def _log_gradients(self, model_batch, labels_dev, stage: int) -> None:
        """--check_gradient: per-parameter name, parameter-sum and
        gradient-sum lines in sorted name order, BERT skipped
        (ref: mimrl_tpu/train/solver.py:1143-1157, Utils.py:11-19)."""
        sums = steps.grad_debug_step(self.model, self.opt, model_batch,
                                     labels_dev, self.bank, self.generator,
                                     stage)
        for name in sorted(sums):
            with span("sync/check_gradient"):
                p_sum, g_sum = (float(t) for t in sums[name])
            log_message(f"-->name: {name}")
            log_message(f"-->para: {p_sum:.6f}")
            log_message(f"-->grad_value: {g_sum:.6f}")
            log_message("=" * 25)

    def evaluate(self, loader):
        """No-grad eval pass (ref: Solver.py:250-270)."""
        with span("solver/eval"):
            opt = self.opt
            use_mi = self.have_bank
            losses, mis_list, outs, masks, targets, features = (
                [], [], [], [], [], [])
            for batch in loader:
                model_batch, labels_dev, labels_np = self._prep(batch)
                loss, mis, out, feats = steps.eval_step(
                    self.model, opt, model_batch, labels_dev, self.bank,
                    self.generator, use_mi, custom_loss=self.custom_loss)
                losses.append(loss)
                mis_list.append(mis)
                outs.append(out)
                masks.append(batch["sample_mask"] > 0.5)
                targets.append(labels_np)
                if opt.save_best_features:
                    features.append(feats)

            n = len(loader)
            predictions = np.concatenate(
                [_readback(o, "eval_readback")[m]
                 for o, m in zip(outs, masks)])
            targets = np.concatenate([t[m] for t, m in zip(targets, masks)])
            if opt.save_best_features:
                features = [[_readback(f, "eval_readback")[m] for f in fl]
                            for fl, m in zip(features, masks)]
            score = get_score_from_result(predictions, targets, opt.dataset,
                                          opt.task, opt.num_class)
            with span("sync/eval_readback"):
                avg_loss = float(torch.stack(losses).sum()) / n
            avg_mis = (_readback(torch.stack(mis_list).sum(dim=0),
                                 "eval_readback") / n).tolist()
            return (avg_loss, avg_mis, score, predictions, targets,
                    features if opt.save_best_features else None)

    # ------------------------------------------------------------------ #
    # --epoch_scan (ref: mimrl_tpu/train/solver.py:300-494, :595-697)
    def _flat_tensors(self, loader) -> Dict[str, torch.Tensor]:
        """The loader's dataset-order tensors on the device, uploaded once
        (AVEC's random-word tokens, drawn each pass, are not among them)."""
        if loader not in self._flats:
            fields = [("audio", loader._audio), ("video", loader._video)]
            if loader._text_feat is not None:
                fields.append(("text", loader._text_feat))
            if loader._tokens is not None:
                fields += zip(MODEL_INPUTS[:3], loader._tokens)
            self._flats[loader] = {k: torch.from_numpy(v).to(self.device)
                                   for k, v in fields}
        return self._flats[loader]

    def _epoch_plan(self, loader):
        """Begin a pass of ``loader`` (the seed ``seed + passes``; ``passes``
        advances by one) and return its plan on the host: ([NB, bs] row ids,
        [NB, bs] sample mask, the pass's tokens, [NB, bs] labels in the
        task's dtype, labels per batch, masks per batch)."""
        idx_plan, mask_plan, tokens = loader.next_epoch()
        ds_labels = [np.asarray(lab) for lab in loader.ds.labels]
        labels_np = [np.asarray(get_label_from_datas(
            self.opt, {"labels": [lab[i] for lab in ds_labels]}))
            for i in idx_plan]
        labels = np.stack(labels_np).astype(
            np.int64 if self.opt.task == "classification" else np.float32)
        return (idx_plan, mask_plan, tokens, labels, labels_np,
                [m > 0.5 for m in mask_plan])

    def _gather(self, loader, idx, mask, tokens=None) -> Dict:
        """The epoch's [NB, bs, ...] model inputs and sample mask on the
        device, gathered by the row ids ``idx`` ([NB, bs], on the device)
        from the dataset-order tensors and, for AVEC's random words, the
        pass's ``tokens``. On a mesh the model inputs are this rank's rows
        of each batch; the sample mask stays whole."""
        flats = self._flat_tensors(loader)
        if tokens is not None:
            flats = dict(flats, **dict(zip(MODEL_INPUTS[:3], tokens)))
        rows = idx
        if self.mesh is not None and self.mesh.sharded:
            m = self.mesh
            rows = idx[:, m.row_lo:m.row_lo + m.local_batch]
        batches = {k: v[rows] for k, v in flats.items()}
        batches["sample_mask"] = mask
        return batches

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
        self._warn_replicated()
        idx_plan, mask_plan, tokens, labels, labels_np, masks = (
            self._epoch_plan(loader))

        def up(a):
            return torch.from_numpy(a).to(self.device)

        with span("data/copy"):
            batches = self._gather(
                loader, up(idx_plan), up(mask_plan),
                None if loader.static_tensors else [up(t) for t in tokens])
            result = (batches, up(labels), labels_np, masks)
        if not loader.shuffle and loader.static_tensors:
            self._stacks[loader] = result
        return result

    def _warn_replicated(self) -> None:
        """JAX's warning (solver.py:364-375), once, when the mesh's batch
        axes do not divide the batch: every rank then runs it whole."""
        m = self.mesh
        n_data = 1 if m is None else m.size(BATCH_AXES)
        if n_data == 1 or m.sharded or getattr(self, "_warned_replicated",
                                                 False):
            return
        self._warned_replicated = True
        log_message(
            f"WARNING: --epoch_scan batch dim {self.opt.batch_size} "
            f"is not divisible by mesh data axis {n_data}; "
            f"replicating the epoch stack to all devices.")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device; on the card from page-locked memory
        without waiting for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stack_group(self, loader, g: int) -> List[Callable]:
        """``g`` epochs of ``loader`` for ``--epoch_group``: one function per
        epoch that returns what ``_stack_epoch`` returns. The plans are
        drawn as ``g`` calls of ``_stack_epoch`` would draw them (``passes``
        advances by ``g``), each after the one before, and uploaded in one
        copy each; an epoch's batches are gathered when its function is
        called. Unshuffled loaders of fixed tensors give their one stack."""
        if loader in self._stacks or (not loader.shuffle
                                      and loader.static_tensors):
            stacked = self._stack_epoch(loader)
            return [lambda: stacked] * g
        self._warn_replicated()
        plans = [self._epoch_plan(loader) for _ in range(g)]
        with span("data/copy"):
            idx, mask, labels = (self._upload(np.stack([p[j] for p in plans]))
                                 for j in (0, 1, 3))
            tokens = None
            if not loader.static_tensors:
                tokens = [self._upload(np.stack([p[2][j] for p in plans]))
                          for j in range(3)]

        def epoch(i):
            with span("data/copy"):
                batches = self._gather(loader, idx[i], mask[i], None if tokens
                                       is None else [t[i] for t in tokens])
            return batches, labels[i], plans[i][4], plans[i][5]

        return [functools.partial(epoch, i) for i in range(g)]

    def _enqueue_train(self, epoch: int, batches, labels) -> Dict:
        """Enqueue the epoch's stage 1 and stage 2 on its stacked batches
        and swap the banks; returns the device values that ``_train_result``
        reads."""
        opt = self.opt
        nb = labels.shape[0]
        pass_sums = None
        if epoch > 0 and self.have_bank:
            with span("solver/stage1"):
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
        with span("solver/stage2"):
            losses, mis, outs = steps.train_epoch(
                self.model, self.opt_main, opt, batches, labels, self.bank,
                self.new_bank, self.generator, use_mi, run=self.graphs,
                custom_loss=self.custom_loss)
        self.bank.copy_(self.new_bank)
        self.have_bank = True
        return {"pass_sums": pass_sums, "loss_sum": losses.sum(),
                "mis_sum": mis.sum(dim=0), "outs": outs}

    def _train_result(self, vals: Dict, labels_np, masks, nb: int):
        """What ``train`` returns, from ``_enqueue_train``'s values on the
        host (and the stage-1 log line)."""
        opt = self.opt
        sums = [] if vals["pass_sums"] is None else vals["pass_sums"].tolist()
        self.stage1_pass_losses = [x / nb for x in sums]
        log_message("  stage1:" + "".join(
            f" pass{i + 1}:[{l:.4f}]"
            for i, l in enumerate(self.stage1_pass_losses)))
        predictions = np.concatenate(
            [o[m] for o, m in zip(vals["outs"], masks)])
        targets = np.concatenate([t[m] for t, m in zip(labels_np, masks)])
        score = get_score_from_result(predictions, targets, opt.dataset,
                                      opt.task, opt.num_class)
        return (float(vals["loss_sum"]) / nb, sum(sums) / nb,
                (vals["mis_sum"] / nb).tolist(), score)

    def _enqueue_eval(self, batches, labels):
        """Enqueue one split's eval; returns (the device values that
        ``_eval_result`` reads, the four feature stacks)."""
        with span("solver/eval"):
            losses, mis, outs, feats = steps.eval_epoch(
                self.model, self.opt, batches, labels, self.bank,
                self.generator, self.have_bank, run=self.graphs,
                custom_loss=self.custom_loss)
        return ({"loss_sum": losses.sum(), "mis_sum": mis.sum(dim=0),
                 "outs": outs}, feats)

    @staticmethod
    def _features_host(feats, masks) -> List:
        """[[F, T, A, V] rows of the real samples] per batch."""
        return [[f[i][m] for f in feats] for i, m in enumerate(masks)]

    def _eval_result(self, vals: Dict, labels_np, masks, n: int):
        """What ``evaluate`` returns, from ``_enqueue_eval``'s values on the
        host; the features when ``vals`` holds them (feat0..feat3)."""
        opt = self.opt
        predictions = np.concatenate(
            [o[m] for o, m in zip(vals["outs"], masks)])
        targets = np.concatenate([t[m] for t, m in zip(labels_np, masks)])
        score = get_score_from_result(predictions, targets, opt.dataset,
                                      opt.task, opt.num_class)
        features = None
        if "feat0" in vals:
            features = self._features_host(
                [vals[f"feat{j}"] for j in range(4)], masks)
        return (float(vals["loss_sum"]) / n,
                (vals["mis_sum"] / n).tolist(), score, predictions, targets,
                features)

    def _train_epoch_scan_dispatch(self, epoch: int):
        """Enqueue the epoch's stages; returns ``finalize()``, which waits
        for them and returns what ``train`` returns."""
        batches, labels, labels_np, masks = self._stack_epoch(self.train_loader)
        t0 = time.time()
        vals = self._enqueue_train(epoch, batches, labels)
        log_message(f"  train dispatch: {time.time() - t0:.2f}s")

        def finalize():
            with span("sync/train_fetch"):
                got = _Fetch(vals).wait()
            return self._train_result(got, labels_np, masks, labels.shape[0])

        return finalize

    def _evaluate_epoch_scan_dispatch(self, loader):
        """Enqueue one split's eval; returns ``finalize()``, which returns
        what ``evaluate`` returns."""
        batches, labels, labels_np, masks = self._stack_epoch(loader)
        vals, feats = self._enqueue_eval(batches, labels)
        if self.opt.save_best_features:
            vals.update((f"feat{j}", f) for j, f in enumerate(feats))

        def finalize():
            with span("sync/eval_fetch"):
                got = _Fetch(vals).wait()
            return self._eval_result(got, labels_np, masks, len(loader))

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
        if self._group_supported():
            return self._solve_loop_grouped(tracking)
        if opt.epoch_group > 1:
            log_message(_GROUP_WARNING)
        # pipelined epochs (ref: mimrl_tpu/train/solver.py:1343-1446): epoch
        # e's host work overlaps epoch e + 1's device work; the schedule is
        # stepped at dispatch, so it must not read the valid metric; a
        # profiled run is not pipelined, so its trace holds one epoch
        pipelined = (self.scan_mode and opt.pipeline_epochs
                     and not self.lr_schedule.needs_metric
                     and not opt.profile_dir)
        pending = None  # (epoch, t0, the three finalize()s, snapshot)
        profiler = None
        for epoch in range(self.start_epoch, opt.epochs_num):
            if opt.profile_dir and epoch == self.start_epoch + 1:
                # the first epoch after the warm-up one (ref: :1371-1373)
                profiler = self._start_profiler(opt.profile_dir)
            t0 = time.time()
            if self.scan_mode:
                fins = self._epoch_scan_dispatch(epoch)
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
            if profiler is not None:
                with span("sync/profile_end"):
                    self._synchronize()
                profiler.stop()  # writes the trace
                profiler = None
                log_message(f"Profiler trace written to {opt.profile_dir}")
            if self._preempted:
                self._stop_preempted(epoch, self._snapshot(epoch))
                break
        if pending is not None:
            p_epoch, p_t0, p_fins, p_snap = pending
            self._finalize_epoch(tracking, p_epoch, time.time() - p_t0,
                                 *(f() for f in p_fins), snap=p_snap)
            if self._preempted:
                self._stop_preempted(p_epoch, p_snap)
        return self._finish(tracking)

    def _epoch_scan_dispatch(self, epoch: int):
        """Enqueue one ``--epoch_scan`` epoch: the finalize()s of its train
        stages and of the valid and test evals."""
        return (self._train_epoch_scan_dispatch(epoch),
                self._evaluate_epoch_scan_dispatch(self.valid_loader),
                self._evaluate_epoch_scan_dispatch(self.test_loader))

    def _finish(self, tracking):
        log_message("Training complete.")
        self.writer.close()
        if tracking["score"][0] is not None:
            self.log_best_scores(tracking["score"])
        self.save_results(tracking["predictions"], tracking["targets"],
                          tracking["features"], tracking["valid_state"],
                          tracking["test_state"])
        # (ref: mimrl_tpu/train/solver.py:1579-1580) the background saves
        # are durable before the run returns
        self.ckpt.wait_until_finished()
        return tracking["score"]

    # ------------------------------------------------------------------ #
    # --epoch_group (ref: mimrl_tpu/train/solver.py:699-1140)
    def _selection_rule(self):
        """(the device's rule, the score's key): the rule of
        ``eval/metrics.current_result_better`` (JAX: ``_group_sel`` and
        ``_group_sel_key``, solver.py:700-712)."""
        if self.opt.task == "classification":
            return "acc", f"{self.opt.num_class}-class_acc"
        rule = "ccc" if self.opt.dataset == "avec2019" else "mae"
        return rule, rule

    def _group_supported(self) -> bool:
        """JAX's ``_group_supported`` (solver.py:733-744). Every loader of
        this package qualifies (fixed tensors, or AVEC's raw-text words,
        whose plans ``_stack_group`` draws up front) and every task has a
        rule."""
        opt = self.opt
        return (opt.epoch_scan and opt.epoch_group > 1
                and not opt.check_gradient and not opt.profile_dir
                and self._group_mesh_ok())

    def _group_mesh_ok(self) -> bool:
        """Grouped dispatch takes a pure data-parallel mesh (dcn x data);
        a pipe or model axis keeps the per-epoch path (JAX:
        ``_group_mesh_ok``, solver.py:714-723)."""
        m = self.mesh
        return m is None or (m.shape[PIPE_AXIS] == 1
                             and m.shape[MODEL_AXIS] == 1)

    def _live_state(self) -> Dict[str, torch.Tensor]:
        """The training state's tensors by slot path (``model/<name>``,
        ``opt_main/mu``, ``bank/F``, ...): the tensors themselves, which
        the steps update in place."""
        live = {f"model/{k}": v for k, v in self.model.state_dict().items()}
        for name in ("opt_main", "opt_vmi"):
            live.update((f"{name}/{part}", t) for part, t in zip(
                ("count", "mu", "nu"), getattr(self, name).state()))
        live.update((f"bank/{f}", getattr(self.bank, f))
                    for f in steps.FeatureBank.FIELDS + ("valid",))
        return live

    def _select(self, epoch: int, valid, test):
        """Enqueue epoch ``epoch``'s model selection on the device: each
        eval split's selection metric, whether it beats that split's best,
        and the best models replaced where it does (JAX: the scan body's
        ``_select_tree``, steps.py:784-800). ``valid``, ``test``: (outputs,
        labels, sample mask, feature stacks). Returns the two device
        flags; on the card the body is one captured graph."""
        sel = self._selection_rule()[0]
        live = self._live_state() if self.opt.save_models else {}
        best_v, best_t = self._best["valid"], self._best["test"]
        feats = {}
        if self.opt.save_best_features:
            feats = {f"{split}{j}": f for split, (_, _, _, fs) in
                     (("valid", valid), ("test", test))
                     for j, f in enumerate(fs)}
            best_v.reserve(feats)
            best_t.reserve({k: v for k, v in feats.items()
                            if k.startswith("test")})

        def body(epoch, v_outs, v_labels, v_mask, t_outs, t_labels, t_mask,
                 feats):
            flags = []
            for best, outs, labels, mask, keep in (
                    (best_v, v_outs, v_labels, v_mask, feats),
                    (best_t, t_outs, t_labels, t_mask,
                     {k: v for k, v in feats.items()
                      if k.startswith("test")})):
                metric = steps.selection_metric(sel, outs, labels, mask)
                better = steps.selection_better(sel, metric, best.metric)
                best.update(better, metric, epoch, live, keep)
                flags.append(better)
            return torch.stack(flags)

        return self.graphs(
            "select", body,
            epoch=torch.full((), epoch, dtype=torch.int64,
                             device=self.device),
            v_outs=valid[0], v_labels=valid[1], v_mask=valid[2],
            t_outs=test[0], t_labels=test[1], t_mask=test[2], feats=feats)

    def _dispatch_epoch_group(self, e0: int, g: int) -> Dict:
        """Enqueue epochs ``e0`` .. ``e0 + g - 1`` with no wait for the
        device (JAX: ``_dispatch_epoch_group``, solver.py:746-894). The
        plans of the ``g`` epochs are drawn and uploaded first; each epoch
        then runs stage 1 on its rung, stage 2, the bank swap, both evals
        and the selection, and steps the schedule: on the device under
        plateau, else on the host between epochs, as the pipelined
        per-epoch loop does. The kernels, generator draws and rates are
        those of ``g`` per-epoch epochs. Returns the group's record, whose
        fetch of the per-epoch results is started last."""
        t0 = time.time()
        loader = self.train_loader
        passes0 = loader.passes
        trains = self._stack_group(loader, g)
        drawn = loader.passes - passes0
        valids = self._stack_group(self.valid_loader, g)
        tests = self._stack_group(self.test_loader, g)
        values, meta = {}, []
        for i in range(g):
            epoch = e0 + i
            batches, labels, labels_np, masks = trains[i]()
            train = self._enqueue_train(epoch, batches, labels)
            evals = {}
            for split, stacked in (("valid", valids[i]()),
                                   ("test", tests[i]())):
                v_batches, v_labels, v_labels_np, v_masks = stacked
                vals, feats = self._enqueue_eval(v_batches, v_labels)
                evals[split] = (vals, (vals["outs"], v_labels,
                                       v_batches["sample_mask"], feats),
                                (v_labels_np, v_masks))
            better = self._select(epoch, evals["valid"][1],
                                  evals["test"][1])
            record = {"train": train, "valid": evals["valid"][0],
                      "test": evals["test"][0]}
            lr_state = None
            if self._plateau is not None:
                factor = self._plateau.step(evals["valid"][0]["loss_sum"],
                                            len(self.valid_loader))
                self.opt_main.learning_rate_from(factor * self.base_lr_main)
                self.opt_vmi.learning_rate_from(factor * self.base_lr_vmi)
                self.lr_schedule.epoch += 1  # the rest is synced at the end
                record["plateau"] = self._plateau.values()
            else:
                self._step_schedule(None)
                lr_state = self.lr_schedule.state_dict()
            values.update((f"{i}/{split}/{k}", v)
                          for split, vals in record.items()
                          for k, v in vals.items())
            values[f"{i}/better"] = better
            meta.append(dict(
                epoch=epoch, labels_np=labels_np, masks=masks,
                hosts={s: evals[s][2] for s in ("valid", "test")},
                slot=dict(lr_schedule=lr_state,
                          loader_passes=passes0 + min(i + 1, drawn),
                          rng=self._rng_state()),
                schedule_epoch=self.lr_schedule.epoch))
        log_message(f"  group dispatch, epochs {e0 + 1}-{e0 + g}: "
                    f"{time.time() - t0:.2f}s")
        return dict(e0=e0, g=g, meta=meta, fetch=_Fetch(values))

    def _finalize_group(self, tracking, group: Dict, dt: float) -> None:
        """The host half of a group (JAX: ``_finalize_group``,
        solver.py:896-995): wait for its one copy of results, then per
        epoch the scores, the replay of the device's selection flags into
        the best-model bookkeeping, and the log line and scalars that
        ``_finalize_epoch`` writes; then ``latest`` when the group's end
        is due one."""
        with span("solver/finalize"):
            with span("sync/group_fetch"):
                got = group["fetch"].wait()
            g = group["g"]
            nb = len(self.train_loader)
            nv, nt = len(self.valid_loader), len(self.test_loader)
            for i, m in enumerate(group["meta"]):
                epoch = m["epoch"]
                if self._plateau is not None:
                    m["slot"]["lr_schedule"] = self._plateau.state_dict(
                        _part(got, f"{i}/plateau"), m["schedule_epoch"])
                self._group_meta[epoch] = m["slot"]
                self._eval_masks = {s: m["hosts"][s][1] for s in m["hosts"]}
                train = self._train_result(_part(got, f"{i}/train"),
                                           m["labels_np"], m["masks"], nb)
                valid = self._eval_result(_part(got, f"{i}/valid"),
                                          *m["hosts"]["valid"], nv)
                test = self._eval_result(_part(got, f"{i}/test"),
                                         *m["hosts"]["test"], nt)
                better_valid, better_test = (bool(b)
                                             for b in got[f"{i}/better"])
                if better_valid:
                    self._best["valid"].epoch_host = epoch
                if better_test:
                    self._best["test"].epoch_host = epoch
                self._track(tracking, better_valid, better_test, valid, test,
                            None)
                self._log_epoch(epoch, dt / g, train, valid, test,
                                m["slot"]["lr_schedule"]["factor"], group=g)
            latest = group.get("latest")
            if latest is not None:
                latest["lr_schedule"] = (
                    group["meta"][-1]["slot"]["lr_schedule"])
                self.ckpt.save("latest", latest)

    def _best_slot(self, best: _DeviceBest) -> Dict:
        """A device best as the slot that ``_snapshot`` of its epoch gives:
        its tensors, and the schedule, loader passes and generators that
        the host recorded at that epoch."""
        slot = {"format": SLOT_FORMAT, "epoch": best.epoch_host,
                "model": _part(best.tensors, "model")}
        for name in ("opt_main", "opt_vmi"):
            o = getattr(self, name)
            slot[name] = {"kind": o.kind, "sizes": list(o.sizes),
                          **_part(best.tensors, name)}
        slot.update(bank=_part(best.tensors, "bank"), have_bank=True,
                    **self._group_meta[best.epoch_host])
        return slot

    def _solve_loop_grouped(self, tracking):
        """The ``--epoch_group`` loop (JAX: ``_solve_loop_grouped``,
        solver.py:1014-1141): an epoch with an empty bank on the per-epoch
        path, then groups of G epochs, group k's host half after group
        k + 1 is enqueued; ``latest`` at the group ends that reach
        ``--save_latest_every`` (the cadence rounds to groups) and at a
        preemption, which stops the run at a group's end."""
        opt = self.opt
        e = self.start_epoch
        if not self.have_bank and e < opt.epochs_num:
            t0 = time.time()
            fins = self._epoch_scan_dispatch(e)
            self._finalize_epoch(tracking, e, time.time() - t0,
                                 *(f() for f in fins))
            e += 1
        rule, key = self._selection_rule()
        worst = np.inf if rule == "mae" else -np.inf
        live = self._live_state() if opt.save_models else {}
        self._best = {split: _DeviceBest(
            live, worst if score is None else score[key], self.device)
            for split, score in (("valid", tracking["score"][0]),
                                 ("test", tracking["score"][1]))}
        self._plateau = (PlateauState(self.lr_schedule, self.device)
                         if self.lr_schedule.needs_metric else None)
        self._group_meta = {}
        pending = None
        while e < opt.epochs_num and not self._preempted:
            g = min(opt.epoch_group, opt.epochs_num - e)
            t0 = time.time()
            group = self._dispatch_epoch_group(e, g)
            e += g
            if opt.save_latest_every > 0 and (
                    e % opt.save_latest_every == 0 or e >= opt.epochs_num):
                group["latest"] = self._snapshot(e - 1)
            if pending is not None:
                self._finalize_group(tracking, pending, t0 - pending["t0"])
            group["t0"] = t0
            pending = group
        if pending is not None:
            self._finalize_group(tracking, pending, time.time() - pending["t0"])
            if self._plateau is not None:
                # the host schedule takes the device's state
                self.lr_schedule.load_state_dict(
                    pending["meta"][-1]["slot"]["lr_schedule"])
                self._step_rates()
        if self._preempted:
            self._stop_preempted(e - 1, self._snapshot(e - 1))
        self._best_to_tracking(tracking)
        return self._finish(tracking)

    def _best_to_tracking(self, tracking) -> None:
        """The device's best models into the bookkeeping that
        ``save_results`` writes: the slots and, with
        ``--save_best_features``, the features of their epochs."""
        opt = self.opt
        for split, best in self._best.items():
            if best.epoch_host is None:
                continue  # the host's best (epoch 0) stands
            with span("sync/best_epoch"):
                epoch = int(best.epoch)
            if epoch != best.epoch_host:
                raise RuntimeError(
                    f"best {split} epoch {epoch} on the device, "
                    f"{best.epoch_host} in the host's replay")
            if opt.save_models:
                tracking[f"{split}_state"] = self._best_slot(best)
            if opt.save_best_features:
                with span("sync/best_fetch"):
                    got = _Fetch(best.feats).wait()
                feats = {s: self._features_host(
                    [got[f"{s}{j}"] for j in range(4)], self._eval_masks[s])
                    for s in ("valid", "test") if f"{s}0" in got}
                if split == "valid":
                    tracking["features"][0] = feats["valid"]
                    tracking["features"][2] = feats["test"]
                else:
                    tracking["features"][1] = feats["test"]

    def _start_profiler(self, profile_dir: str):
        """A started ``torch.profiler`` profile of the host and, on the
        card, the device, whose ``stop()`` writes a chrome-trace JSON file
        into ``profile_dir``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir))
        profiler.start()
        return profiler

    def _stop_preempted(self, epoch: int, snap: Dict) -> None:
        self.ckpt.save("latest", snap)
        self.ckpt.wait_until_finished()  # durable before the process stops
        log_message(f"Preemption requested: checkpointed at epoch {epoch}, "
                    "stopping.")

    def _step_schedule(self, val_loss: Optional[float]) -> None:
        """Advance the learning-rate schedule one epoch and apply it to
        both optimizers (ref: Solver.py:52-57)."""
        self.lr_schedule.step(val_loss)
        self._step_rates()

    def _step_rates(self) -> None:
        """Both optimizers' rates from the schedule's factor."""
        factor = self.lr_schedule.factor
        self.opt_main.learning_rate = self.base_lr_main * factor
        self.opt_vmi.learning_rate = self.base_lr_vmi * factor

    def _finalize_epoch(self, tracking, epoch, dt, train, valid, test,
                        snap: Optional[Dict] = None):
        """Step the learning-rate schedule (unless ``snap``, the state
        snapshot at the epoch's dispatch under pipelining, is given: the
        schedule was stepped then), track the best models, write the
        epoch's log line and scalar channels, and keep the checkpoint
        cadence."""
        with span("solver/finalize"):
            opt = self.opt
            val_score, test_score = valid[2], test[2]
            if snap is None:
                self._step_schedule(valid[0])

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
            self._track(tracking, better_valid, better_test, valid, test, snap)
            self._log_epoch(epoch, dt, train, valid, test, factor)
            if save_latest:
                self.ckpt.save("latest", snap)

    def _track(self, tracking, better_valid: bool, better_test: bool, valid,
               test, snap: Optional[Dict]) -> None:
        """The best-model bookkeeping of one epoch (ref: Solver.py:59-93):
        ``snap`` becomes the slot of each split it improved (with
        ``--save_models``)."""
        (_, _, val_score, val_predictions, val_targets, val_features) = valid
        (_, _, test_score, test_predictions, test_targets,
         test_features) = test
        save = self.opt.save_models
        if better_valid:
            log_message("Better valid score found...")
            if save:
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
            if save:
                tracking["test_state"] = snap
            tracking["score"][1] = test_score
            tracking["predictions"][1] = test_predictions
            tracking["features"][1] = test_features
            tracking["targets"][1] = test_targets

    def _log_epoch(self, epoch, dt, train, valid, test, factor,
                   group: Optional[int] = None) -> None:
        """The epoch's log line and scalar channels; ``dt`` is the epoch's
        seconds (a group's share under ``--epoch_group``)."""
        train_loss, _, train_mis, train_score = train
        val_loss, val_mis, val_score = valid[:3]
        test_loss, test_mis, test_score = test[:3]
        sps = len(self.train_loader.ds) / max(dt, 1e-9)
        msg = self.build_message(epoch, train_loss, train_mis, train_score,
                                 val_loss, val_mis, val_score, test_loss,
                                 test_mis, test_score)
        timing = (f" || {dt:.1f}s {sps:.1f} samples/s" if group is None
                  else f" || {dt:.2f}s {sps:.1f} samples/s (group of {group})")
        log_message(msg + timing + self._memory_suffix())
        self.log_scalars(epoch, train_loss, train_mis, train_score, val_loss,
                         val_mis, val_score, test_loss, test_mis, test_score,
                         self.base_lr_main * factor)

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
        the model from them. A mesh rank other than 0 writes nothing."""
        if not self.is_writer:
            return
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
