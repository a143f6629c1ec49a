"""The mesh step against the unsharded step (the port's counterpart of
``__graft_entry__._mesh_equality_check``, :137-282).

``equality_gap`` runs on every rank of an initialised process group: ONE
``critic_step`` + ``train_step`` from identical weights, feature bank,
batch and generator seeds, once unsharded on the rank's device and once
on the mesh (``parallel/mesh.py``: the batch's model inputs split over
the batch axes, BERT's dense kernels and the MoE experts over ``model``,
BERT's layers over ``pipe`` as ``parallel/pipeline.py``'s schedule),
then the largest absolute gap over the two losses, the MI values, the outputs, the new bank's rows and every
updated parameter (model-sharded ones gathered whole), the maximum over
the ranks, so every rank returns the same number.

Forms, as in JAX: SGD with dropout off in float32 (the update is linear in
the gradient, so a small gap certifies the gradient), dropout on (each
rank draws its rows of the single-process masks), and Adam in float64
(``float64=True``: the model, batch, bank and optimizer arithmetic in
float64; Adam's ``g / (sqrt(v) + eps)`` amplifies a float32 reduction-order
difference on a near-zero gradient up to a full step, which float64
removes). ``faults`` breaks the mesh step for the duration of that step
(``_faulty``, which patches ``parallel/mesh.py``'s and
``parallel/pipeline.py``'s code): ``skip_reduce`` (a parameter index whose
gradient average every rank but rank 0 skips), ``sum_gradients`` (the
average's division left out), ``dropout_from_zero`` (every rank but rank 0
draws its dropout rows from row 0); on a pipe mesh ``no_pipe_sum`` (BERT's
gradients not summed over ``pipe``), ``output_sum`` (the last stage's
cotangent of the shared output summed over ``pipe``) and ``bank_late``
(stage 0 runs a tick's unit before the tick's bank, so a unit that takes
the activation banked in its own tick (M = S) reads the bank before it is
written); under ``--seq_shard`` ``scatter_no_sum`` (the row-parallel
products' reduce-scatter without its sum).

``split_batch_step`` is the control that sets a limit on the card: the
unsharded step with the batch's forward in two row blocks, whose
gradients are summed in the other order; ``microbatch_step`` is the
pipeline's: the unsharded step with BERT's stack run on M row blocks one
after the other; ``ksplit_step`` is ``--seq_shard``'s: BERT's second
products summed over blocks of their input axis in float32. ``run_ranks`` starts the ranks
of a group as processes (gloo or NCCL) and returns rank 0's result; ``critic_scores_gap`` holds a critic's
``[bs, bs]`` scores from data-sharded features against the unsharded
scores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.models.bert import BertConfig
from mimrl_tpu_torch.models.model import MODEL_INPUTS, build_model
from mimrl_tpu_torch.parallel import mesh as pmesh
from mimrl_tpu_torch.parallel import pipeline
from mimrl_tpu_torch.parallel.mesh import (BATCH_AXES, PIPE_AXIS, Mesh,
                                           all_reduce, gather_blocks,
                                           gather_rows, shard_batch,
                                           shard_dim, shard_params)
from mimrl_tpu_torch.train import optim, steps
from mimrl_tpu_torch.train.optim import (make_main_optimizer,
                                         make_vmi_optimizer, partition_params)

BANK_FIELDS = ("C", "F", "T", "A", "V")


def _to_float64(model: torch.nn.Module) -> None:
    """Parameters and BERT's compute dtype in float64."""
    model.double()
    for m in model.modules():
        if isinstance(getattr(m, "config", None), BertConfig):
            m.config = dataclasses.replace(m.config, dtype=torch.float64)


def build(cfg: MimrlConfig, vocab: int, d_a: int, d_v: int,
          state: Dict[str, torch.Tensor], device, float64: bool = False
          ) -> torch.nn.Module:
    """The port's model for ``cfg`` with ``state`` loaded."""
    model = build_model(cfg, vocab, d_a, d_v, device)
    model.load_state_dict(state, strict=True)
    if float64:
        _to_float64(model)
    return model


def one_step(model, cfg: MimrlConfig, batch: Dict[str, np.ndarray],
             labels: np.ndarray, bank: Dict[str, np.ndarray], n_valid: int,
             device, seed: int = 0,
             anchors: Optional[Sequence[Dict[str, np.ndarray]]] = None,
             mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One ``critic_step`` and one ``train_step`` (with MI) of ``model``
    on the host ``batch`` (model inputs, ``sample_mask``) and ``labels``
    from the bank ``bank`` (fields C, F, T, A, V), the generators seeded
    with ``seed``; on ``mesh`` the model is placed on it first and the
    model inputs are this rank's rows. ``anchors``: the two steps' kNN
    anchor rows. Returns every value the gap reads (parameters whole)."""
    dtype = next(model.parameters()).dtype
    if mesh is not None:
        mesh.set_batch(cfg.batch_size)
        mesh.set_pipeline(cfg.pipe_microbatches, cfg.pipe_virtual,
                          cfg.pipe_remat)
        mesh.set_sequence(cfg.seq_shard)
        shard_params(mesh, model)
    main, bert, vmi = partition_params(model)
    opt_main = make_main_optimizer(cfg, main, bert)
    opt_vmi = make_vmi_optimizer(cfg, vmi)
    opt_main.mesh = opt_vmi.mesh = mesh
    grads: Dict[str, torch.Tensor] = {}
    for opt, names in ((opt_main, list(main) + list(bert)), (opt_vmi, list(vmi))):
        opt.step = _recording(opt, names, grads, mesh)

    def up(a):
        t = torch.from_numpy(np.asarray(a))
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    inputs = {k: v for k, v in batch.items() if k in MODEL_INPUTS}
    if mesh is not None and mesh.sharded:
        inputs = shard_batch(mesh, inputs)
    dev_batch = {k: up(v) for k, v in inputs.items()}
    dev_batch["sample_mask"] = up(batch["sample_mask"])
    dev_labels = up(labels)
    kw = dict(n_bank=bank["C"].shape[0], n_valid=n_valid,
              d_common=bank["T"].shape[1], d_fused=bank["F"].shape[1],
              dtype=dtype, device=device)
    old, new = steps.FeatureBank(**kw), steps.FeatureBank(**kw)
    for f in BANK_FIELDS:
        getattr(old, f).copy_(up(bank[f]))
    torch.manual_seed(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    anchor = [None, None] if anchors is None else [
        {k: torch.from_numpy(v).to(device) for k, v in a.items()}
        for a in anchors]
    l1, mis1 = steps.critic_step(model, opt_vmi, cfg, dev_batch, dev_labels,
                                 old, generator, anchor[0])
    l2, mis2, out = steps.train_step(model, opt_main, cfg, dev_batch,
                                     dev_labels, old, new, 0, generator, True,
                                     anchor[1])
    got = {"critic_loss": l1, "critic_mis": mis1, "loss": l2, "mis": mis2,
           "out": out}
    got.update((f"bank/{f}", getattr(new, f)) for f in BANK_FIELDS)
    got.update(grads)
    for name, p in model.named_parameters():
        d = shard_dim(p)
        got[f"model/{name}"] = (p.detach() if d is None
                                else gather_blocks(p.detach(), mesh, d))
    return {k: v.detach().double().cpu() for k, v in got.items()}


def _recording(opt, names: Sequence[str], grads: Dict, mesh):
    """``opt.step`` that first keeps the gradients it is given (after the
    mesh's average, before the clip) as ``grad/<name>``, whole."""
    step = opt.step

    def record(g):
        for name, p, t in zip(names, opt.params, g):
            d = shard_dim(p)
            grads[f"grad/{name}"] = (t.detach().clone() if d is None else
                                     gather_blocks(t.detach(), mesh, d))
        return step(g)

    return record


def _split_forward(order: Sequence[int], n_micro: int = 0):
    """``forward_batch`` with the batch's rows run as ``len(order)`` blocks,
    in ``order``, and concatenated: each block draws its rows of the whole
    batch's dropout masks (the generators are rewound to the same state
    before each block, as every rank draws them). With ``n_micro`` each
    block's BERT stack runs on that many microbatches of its rows
    (``pipeline.bert_forward_microbatched``): the order of a rank of a
    ``data x pipe`` mesh."""

    def forward(model, batch, return_features=True, generator=None):
        inputs = [batch.get(k) for k in MODEL_INPUTS[:5]] + [batch.get("text")]
        bs = next(x.shape[0] for x in inputs if x is not None)
        block = bs // len(order)
        mesh = Mesh({"data": len(order)})
        mesh.set_batch(bs)
        cuda = torch.cuda.is_initialized()
        states = (torch.get_rng_state(),
                  torch.cuda.get_rng_state_all() if cuda else None,
                  None if generator is None else generator.get_state())
        blocks = {}
        for b in order:
            torch.set_rng_state(states[0])
            if cuda:
                torch.cuda.set_rng_state_all(states[1])
            if generator is not None:
                generator.set_state(states[2])
            mesh.row_lo = b * block
            for m in model.modules():
                m.mesh = mesh
            try:
                rows = [None if x is None else x[b * block:(b + 1) * block]
                        for x in inputs]
                hidden = None
                if n_micro and model.raw_text and rows[5] is None:
                    hidden = pipeline.bert_forward_microbatched(
                        model.bertmodel, mesh, *rows[:3],
                        n_microbatches=n_micro, generator=generator)
                blocks[b] = model(*rows[:5], return_features=return_features,
                                  generator=generator, text_features=rows[5],
                                  text_hidden=hidden)
            finally:
                for m in model.modules():
                    m.mesh = None
        return tuple(torch.cat([blocks[b][i] for b in range(len(order))])
                     for i in range(len(blocks[order[0]])))

    return forward


def split_batch_step(model, cfg: MimrlConfig, batch: Dict[str, np.ndarray],
                     labels: np.ndarray, bank: Dict[str, np.ndarray],
                     n_valid: int, device, seed: int = 0, anchors=None,
                     order: Sequence[int] = (1, 0)) -> Dict[str, torch.Tensor]:
    """The control for the order of summation: ``one_step`` of the
    unsharded model with every forward run as row blocks in ``order``
    (``_split_forward``), so each parameter's gradient is the sum of the
    blocks' gradients, summed in another order than the mesh's; nothing
    else changes. Its gap to the unsharded step is what splitting the
    batch alone moves."""
    return _step_with(_split_forward(order), model, cfg, batch, labels,
                      bank, n_valid, device, seed, anchors)


def _step_with(forward: Callable, *args) -> Dict[str, torch.Tensor]:
    """``one_step(*args)`` with ``forward`` as ``steps.forward_batch``."""
    saved = steps.forward_batch
    steps.forward_batch = forward
    try:
        return one_step(*args)
    finally:
        steps.forward_batch = saved


def _ksplit_output(parts: int):
    """``BertSelfOutput.forward`` with its product's input axis in
    ``parts`` blocks: each block's partial sums a float32 ``F.linear`` of
    the inputs rounded to the compute dtype, added in float32 with the
    bias and rounded once, on one rank (the arithmetic that
    ``--seq_shard``'s reduce-scatter does, written apart from
    ``models/bert.py``'s)."""
    from mimrl_tpu_torch.models import bert

    def forward(self, h, residual, time=None):
        c = self.config
        n = h.shape[-1] // parts
        h = h.to(c.dtype).float()
        w = self.dense.weight.to(c.dtype).float()
        total = sum(F.linear(h[..., i * n:(i + 1) * n],
                             w[:, i * n:(i + 1) * n]) for i in range(parts))
        total = total + self.dense.bias.to(c.dtype).float()
        h = self.dropout(total.to(c.dtype))
        return bert._layer_norm(self.LayerNorm, h + residual, c.dtype)

    return forward


def ksplit_step(model, cfg: MimrlConfig, batch: Dict[str, np.ndarray],
                labels: np.ndarray, bank: Dict[str, np.ndarray],
                n_valid: int, device, seed: int = 0, anchors=None
                ) -> Dict[str, torch.Tensor]:
    """``--seq_shard``'s control for the order of summation: ``one_step``
    of the unsharded model with BERT's second products (the attention
    output dense, the FFN down-projection) summed over ``cfg.mesh_model``
    blocks of their input axis in float32 (``_ksplit_output``), the
    arithmetic that the row-parallel products and their reduce-scatter
    change; nothing else changes."""
    from mimrl_tpu_torch.models import bert

    saved = bert.BertSelfOutput.forward
    bert.BertSelfOutput.forward = _ksplit_output(cfg.mesh_model)
    try:
        return one_step(model, cfg, batch, labels, bank, n_valid, device,
                        seed, anchors)
    finally:
        bert.BertSelfOutput.forward = saved


def _micro_forward(n_micro: int):
    """``forward_batch`` with BERT's stack run on ``n_micro`` row blocks
    one after the other with the pipeline's draws
    (``pipeline.bert_forward_microbatched``, the modules placed on a mesh
    of one rank for its duration) and the model on the whole batch after
    it."""

    def forward(model, batch, return_features=True, generator=None):
        inputs = [batch.get(k) for k in MODEL_INPUTS[:5]]
        mesh = Mesh({})
        mesh.set_batch(inputs[3].shape[0])
        for m in model.modules():
            m.mesh = mesh
        try:
            hidden = None
            if model.raw_text and batch.get("text") is None:
                hidden = pipeline.bert_forward_microbatched(
                    model.bertmodel, mesh, *inputs[:3],
                    n_microbatches=n_micro, generator=generator)
            return model(*inputs, return_features=return_features,
                         generator=generator,
                         text_features=batch.get("text"), text_hidden=hidden)
        finally:
            for m in model.modules():
                m.mesh = None

    return forward


def microbatch_step(model, cfg: MimrlConfig, batch: Dict[str, np.ndarray],
                    labels: np.ndarray, bank: Dict[str, np.ndarray],
                    n_valid: int, device, seed: int = 0, anchors=None
                    ) -> Dict[str, torch.Tensor]:
    """The pipeline's control for the order of summation: ``one_step`` of
    the unsharded model with BERT's stack run on ``cfg.pipe_microbatches``
    row blocks one after the other (``_micro_forward``), so each layer's
    products run on a pipeline unit's rows and its gradient is the sum of
    the blocks'; the random draws and everything else are the unsharded
    step's."""
    return _step_with(_micro_forward(cfg.pipe_microbatches), model, cfg,
                      batch, labels, bank, n_valid, device, seed, anchors)


def max_gap(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """{key: largest absolute difference}."""
    return {k: float((ref[k] - got[k]).abs().max()) if ref[k].numel() else 0.0
            for k in ref}


def absolute_gap(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{"abs": the largest absolute difference over the losses, MI values,
    outputs, bank rows and updated parameters (the gradients are read by
    ``relative_gaps``)}."""
    del start
    return {"abs": max(v for k, v in max_gap(ref, got).items()
                       if not k.startswith("grad/"))}


def relative_gaps(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor], floor: float = 1e-3
                  ) -> Dict[str, float]:
    """The gate's three readings in bf16, where absolute gaps mean nothing:
    ``forward``, the largest difference of each forward value (losses, MI
    values, outputs, the new bank's rows) relative to that value's largest
    magnitude; ``gradient``, of each parameter's gradient as the optimizer
    took it, relative to its largest magnitude, or to ``floor`` times the
    largest of all where its own is smaller (a gradient that is zero in
    exact arithmetic is rounding noise); ``update``, of each parameter's
    update (``got - start`` against ``ref - start``), likewise (resolved
    no finer than the parameter's float32 last place)."""
    forward, gradient, update = 0.0, 0.0, 0.0
    steps_ = {k: ref[k] - start[k[len("model/"):]] for k in ref
              if k.startswith("model/")}
    top = _finite(max(float(d.abs().max()) for d in steps_.values()
                      if d.numel()))
    top_g = _finite(max([float(ref[k].abs().max()) for k in ref
                         if k.startswith("grad/") and ref[k].numel()],
                        default=0.0))
    for k, want in ref.items():
        if not want.numel():
            continue
        if k.startswith("grad/"):
            scale = max(float(want.abs().max()), floor * top_g, 1e-30)
            gradient = max(gradient, _finite(
                float((got[k] - want).abs().max()) / scale))
        elif k.startswith("model/"):
            d_ref = steps_[k]
            d_got = got[k] - start[k[len("model/"):]]
            scale = max(float(d_ref.abs().max()), floor * top, 1e-30)
            update = max(update, _finite(float((d_got - d_ref).abs().max())
                                         / scale))
        else:
            scale = max(float(want.abs().max()), 1e-30)
            forward = max(forward, _finite(float((got[k] - want).abs().max())
                                           / scale))
    return {"forward": forward, "gradient": gradient, "update": update}


def _finite(x: float) -> float:
    """``x``, or infinity for NaN (which ``max`` would drop)."""
    return x if math.isfinite(x) else math.inf


def equality_gap(cfg: MimrlConfig, mesh: Mesh, state: Dict[str, torch.Tensor],
                 batch: Dict[str, np.ndarray], labels: np.ndarray,
                 bank: Dict[str, np.ndarray], n_valid: int, *, vocab: int,
                 d_a: int, d_v: int, device, seed: int = 0,
                 anchors=None, float64: bool = False,
                 faults: Optional[Dict] = None,
                 reference: Optional[Dict[str, torch.Tensor]] = None,
                 measure: Callable = absolute_gap):
    """(each of ``measure``'s readings, the largest over every rank; the
    mesh step's values; the unsharded step's values). ``measure(ref, got,
    start)`` gives named readings (``absolute_gap``: the largest absolute
    difference; ``relative_gaps``). ``reference``: the unsharded step's
    values when they are known already (same inputs). Collective: every
    rank calls it."""
    if reference is None:
        reference = one_step(build(cfg, vocab, d_a, d_v, state, device,
                                   float64), cfg, batch, labels, bank,
                             n_valid, device, seed, anchors)
    with _faulty(mesh, faults or {}):
        got = one_step(build(cfg, vocab, d_a, d_v, state, device, float64),
                       cfg, batch, labels, bank, n_valid, device, seed,
                       anchors, mesh)
    start = {k: v.double() for k, v in state.items()}
    readings = measure(reference, got, start)
    names = sorted(readings)
    worst = torch.tensor([readings[n] for n in names], dtype=torch.float64)
    if mesh.backend == "nccl":
        worst = worst.to(device)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return dict(zip(names, worst.tolist())), got, reference


@contextlib.contextmanager
def _faulty(mesh: Mesh, faults: Dict):
    """The fault controls, in force until the block ends: the gradient
    average that ``train/optim.py`` calls is replaced by one that sums
    (``sum_gradients``), that keeps parameter ``skip_reduce``'s own
    gradient on every rank but rank 0, or that sums no gradient over
    ``pipe`` (``no_pipe_sum``); ``mesh.set_batch`` moves the first
    dropout row of every rank but rank 0 to row 0 (``dropout_from_zero``:
    ``row_lo`` is read by the dropouts alone here, the batch's rows are
    taken by ``shard_batch``); the pipeline's output cotangent is summed
    over ``pipe`` (``output_sum``); each tick's ops run unit first
    (``bank_late``); under ``--seq_shard`` the reduce-scatter takes this
    rank's slice of its own partial sums, not of their total
    (``scatter_no_sum``)."""
    reduce, set_batch = optim.reduce_gradients, mesh.set_batch
    scatter_sum = pmesh._scatter_sum
    cotangent, ticks = pipeline._output_cotangent, pipeline.rank_ticks
    skip = faults.get("skip_reduce")

    def faulty_reduce(m, grads, params=None):
        out = reduce(m, grads, None if faults.get("no_pipe_sum") else params)
        if faults.get("sum_gradients"):
            out = [g * m.size(BATCH_AXES) for g in out]
        if skip is not None and m.rank != 0:
            out[skip] = grads[skip]
        return out

    def faulty_set_batch(n):
        set_batch(n)
        if mesh.rank != 0:
            mesh.row_lo = 0

    def late_bank(*args):
        return [ops[::-1] for ops in ticks(*args)]

    if (skip is not None or faults.get("sum_gradients")
            or faults.get("no_pipe_sum")):
        optim.reduce_gradients = faulty_reduce
    if faults.get("dropout_from_zero"):
        mesh.set_batch = faulty_set_batch
    if faults.get("output_sum"):
        pipeline._output_cotangent = (
            lambda g, m: all_reduce(g, m, (PIPE_AXIS,)))
    if faults.get("bank_late"):
        pipeline.rank_ticks = late_bank
    if faults.get("scatter_no_sum"):
        pmesh._scatter_sum = lambda x, m: x
    try:
        yield
    finally:
        pmesh._scatter_sum = scatter_sum
        optim.reduce_gradients = reduce
        pipeline._output_cotangent, pipeline.rank_ticks = cotangent, ticks
        if "set_batch" in vars(mesh):
            del mesh.set_batch


@torch.no_grad()
def critic_scores_gap(mesh: Mesh, critic: torch.nn.Module, x: torch.Tensor,
                      y: torch.Tensor) -> float:
    """The largest gap between a critic's ``[bs, bs]`` scores of the whole
    ``x``, ``y`` and its scores of this rank's rows, gathered over the
    batch axes (``tests/test_distributed.py::
    test_sharded_critic_scores_are_global`` for JAX)."""
    mesh.set_batch(x.shape[0])
    want = critic(x, y)
    rows = shard_batch(mesh, {"x": x, "y": y})
    got = critic(gather_rows(rows["x"], mesh), gather_rows(rows["y"], mesh))
    if got.shape != (x.shape[0], x.shape[0]):
        raise ValueError(f"scores of shape {tuple(got.shape)}")
    return float((want - got).abs().max())


def _rank_main(rank: int, world: int, init: str, backend: str,
               devices: Sequence[str], fn: Callable, args, result: str
               ) -> None:
    device = devices[rank]
    if device.startswith("cpu"):
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        out = fn(rank, device, *args)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn: Callable, args=(), backend: str = "gloo",
              devices: Optional[Sequence[str]] = None,
              store_dir: Optional[str] = None):
    """Start ``world`` processes as the ranks of one group (``backend``;
    rendezvous through a file under ``store_dir`` or a temporary
    directory, so no port is fixed), run ``fn(rank, device, *args)`` on
    each (``devices[rank]``, default the CPU) and return rank 0's result.
    A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    devices = list(devices or ["cpu"] * world)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init = "file://" + os.path.join(tmp, "store")
        result = os.path.join(tmp, "result.pt")
        mp.start_processes(_rank_main, args=(world, init, backend, devices,
                                             fn, args, result),
                           nprocs=world, join=True, start_method="spawn")
        return torch.load(result, weights_only=False)
