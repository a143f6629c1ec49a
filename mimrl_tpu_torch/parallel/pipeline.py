"""Pipeline parallelism for the BERT text tower: GPipe and interleaved
schedules (PyTorch port of ``mimrl_tpu.parallel.pipeline``).

BERT's L layers are split over the mesh's ``pipe`` axis of S stages, and
a rank's rows of the batch stream through the stages in M microbatches.

- ``n_virtual=1`` (GPipe): stage s holds layers ``[s L/S, (s+1) L/S)``.
  The schedule runs M + S - 1 ticks, S - 1 of them a bubble on each stage.
- ``n_virtual=v>1`` (interleaved, Megatron's layer assignment): stage s
  holds the v chunks ``{s, S+s, ..., (v-1)S+s}`` of L/(S v) layers each,
  and each microbatch goes round the ring of stages v times: v M + S - 1
  ticks of 1/v-sized units. Stage 0 banks the activations that come back
  from stage S-1 until their next round (``mimrl_tpu/parallel/
  pipeline.py:161-192``), which needs M >= S and L % (S v) == 0.
- ``remat``: the forward keeps each unit's input only; the backward runs
  the chunk again.

A tick on a rank (``rank_ticks``): stage 0's bank, the rank's unit of the
tick (none in a bubble), then the hop of the unit's output (zeros in a
bubble) to the next stage (``parallel/mesh.py::hop``). Every rank joins
every hop, bubble ticks included, so the collectives stay in step. The
last stage's outputs are summed over ``pipe`` (the other stages add
zeros), so every stage holds the stack's output of its rows and runs the
model after the stack alike.

The backward is the reverse schedule. The critics' ``[bs, bs]`` scores
take the whole batch, so every microbatch's cotangent arrives at once and
no 1F1B interleaving is possible (``mimrl_tpu/parallel/pipeline.py:
28-35``). One ``autograd.Function`` wraps the stack; its backward walks
the ticks in reverse on every rank in the same order (the hops back, the
banks' cotangents) and enters autograd once per unit. Autograd's own
traversal of a graph through the hops could order the collectives
differently on two ranks. The last stage takes the output's cotangent as
it is: every stage computes the same loss from the same output, and a
sum over ``pipe`` would give S times the gradient. The gradients of the
layers and of the embeddings are then non-zero on their owning stage
only, and ``parallel/mesh.py::reduce_gradients`` sums them over ``pipe``.

Random draws equal the sequential stack's. Before the schedule, every
rank draws what the sequential stack draws, in its order: each layer's
attention seed from the caller's generator, and each layer's two hidden
dropout masks over this rank's rows from the device's default generator
(``parallel/mesh.py::Dropout.draw``, the same draw as a dropout of the
sequential stack makes; a rank keeps the masks of its own chunks only).
A unit's dropouts apply its microbatch's rows of those masks, and its
attention mask takes the microbatch's rows of the global batch
(``attention_batch_offset``). So a pipelined step with dropout on equals
the sequential step, every later draw from either generator included, and
``remat`` re-runs a chunk with the same masks. (JAX's pipelined masks,
``fold_in(key, t)`` per tick, differ from its sequential stack's.)

Layout contract (``mimrl_tpu/parallel/pipeline.py:42-48``): every rank
holds the whole parameter set, so the optimizer, the slots,
``--bert_weights`` and ``Predictor`` need no change; a rank runs only its
chunks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.device import widen
from mimrl_tpu_torch.models.bert import attention_seed
from mimrl_tpu_torch.parallel.mesh import (BATCH_AXES, PIPE_AXIS, Dropout,
                                           Mesh, Microbatch, all_reduce, hop,
                                           hop_back)


def chunk_layers(n_layers: int, n_stages: int, n_virtual: int = 1
                 ) -> np.ndarray:
    """``[v, S, L/(S v)]`` layer indices: chunk ``c = r S + d`` (round r,
    stage d) holds the contiguous layers ``[c L/(S v), (c+1) L/(S v))``,
    the order of JAX's ``stack_layer_params`` and its ``[v, S, ...]``
    reshape (``pipeline.py:59-67, 131-135``)."""
    per = n_layers // (n_stages * n_virtual)
    return np.arange(n_layers).reshape(n_virtual, n_stages, per)


def check_schedule(n_layers: int, n_stages: int, n_microbatches: int,
                   n_virtual: int, batch_size: int, n_data: int) -> None:
    """JAX's three ``ValueError``s (``pipeline.py:97-110``) for a schedule
    the layers, the global batch or the microbatches cannot take."""
    L, S, M, v = n_layers, n_stages, n_microbatches, max(n_virtual, 1)
    if L % (S * v) != 0:
        raise ValueError(
            f"bert_layers={L} not divisible by pipe*virtual={S}*{v}")
    if M < 1 or batch_size % (M * n_data) != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by "
            f"pipe_microbatches*mesh_data={M}*{n_data}")
    if v > 1 and M < S:
        raise ValueError(
            f"interleaved schedule needs pipe_microbatches>={S} "
            f"(got {M}): ring-wraparound activations must arrive "
            f"before they are consumed")


def rank_ticks(n_stages: int, n_microbatches: int, n_virtual: int,
               stage: int) -> List[List[Tuple]]:
    """The ops of each of the ``v M + S - 1`` ticks on ``stage``, in order:
    ``("bank", m)``, stage 0 keeps the activation that arrived from stage
    S-1 (unit ``t - S``) as microbatch m's input to its next round; and
    ``("unit", m, r, emit)``, the chunk of round r on microbatch m (unit
    ``t - stage``), ``emit`` when it is the last stage's final round. A
    tick without a unit is this stage's bubble."""
    S, M, v = n_stages, n_microbatches, max(n_virtual, 1)
    n_units = v * M
    ticks = []
    for t in range(n_units + S - 1):
        ops: List[Tuple] = []
        if stage == 0 and 0 <= t - S < n_units:
            ops.append(("bank", (t - S) % M))
        u = t - stage
        if 0 <= u < n_units:
            ops.append(("unit", u % M, u // M,
                        stage == S - 1 and u // M == v - 1))
        ticks.append(ops)
    return ticks


def _output_cotangent(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The cotangent that the last stage takes of the output it shared
    over ``pipe`` (every stage calls it; the others read none): its own,
    every stage holds the same one."""
    del mesh
    return g


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    return b if a is None else a if b is None else a + b


class _Run:
    """One pipelined forward of BERT's layers on this rank and, when a
    gradient is taken, its backward."""

    def __init__(self, mesh: Mesh, bert: nn.Module, bias: torch.Tensor,
                 seeds: Optional[List[torch.Tensor]],
                 masks: Dict[nn.Module, torch.Tensor], n_microbatches: int,
                 n_virtual: int, remat: bool):
        S = mesh.shape[PIPE_AXIS]
        self.mesh, self.M, self.remat = mesh, n_microbatches, remat
        self.stage = mesh.coords[PIPE_AXIS]
        self.last = self.stage == S - 1
        self.ticks = rank_ticks(S, n_microbatches, n_virtual, self.stage)
        ids = chunk_layers(bert.config.num_hidden_layers, S,
                           n_virtual)[:, self.stage]
        self.chunks = [[(int(i), bert.encoder.layer[int(i)]) for i in row]
                       for row in ids]
        self.params = [[p for _, layer in chunk for p in layer.parameters()
                        if p.requires_grad] for chunk in self.chunks]
        self.bias = bias.split(bias.shape[0] // n_microbatches)
        self.seeds, self.masks = seeds, masks
        self.saved = {}

    def chunk(self, r: int, x: torch.Tensor, m: int) -> torch.Tensor:
        """Round r's chunk of layers on microbatch m."""
        self.mesh.micro = Microbatch(m, self.M, self.masks)
        try:
            for i, layer in self.chunks[r]:
                x = layer(x, self.bias[m],
                          seed=None if self.seeds is None else self.seeds[i])
        finally:
            self.mesh.micro = None
        return x

    def unit(self, t: int, m: int, r: int, x: torch.Tensor, graph: bool
             ) -> torch.Tensor:
        if not graph:
            return self.chunk(r, x, m)
        if self.remat:
            self.saved[t] = x
            return self.chunk(r, x, m)
        with torch.enable_grad():
            leaf = x.detach().requires_grad_()
            y = self.chunk(r, leaf, m)
        self.saved[t] = (leaf, y)
        return y.detach()

    def forward(self, x: torch.Tensor, graph: bool) -> torch.Tensor:
        """The stack's output of this rank's rows ``x`` [rows, T, H], the
        same on every stage; ``graph``: keep what the backward needs."""
        inputs = x.split(x.shape[0] // self.M)
        zero = torch.zeros_like(inputs[0])
        state, buf, outputs = zero, [zero] * self.M, [zero] * self.M
        for t, ops in enumerate(self.ticks):
            y = zero
            for op in ops:
                if op[0] == "bank":
                    buf[op[1]] = state
                    continue
                _, m, r, emit = op
                src = ((inputs[m] if r == 0 else buf[m]) if self.stage == 0
                       else state)
                y = self.unit(t, m, r, src, graph)
                if emit:
                    outputs[m] = y
            if t + 1 < len(self.ticks):
                state = hop(y, self.mesh)
        out = torch.cat(outputs) if self.last else torch.zeros_like(x)
        with span("pipe_output"):
            return all_reduce(out, self.mesh, (PIPE_AXIS,))

    def unit_back(self, t: int, m: int, r: int, g_y: torch.Tensor,
                  acc: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The cotangent of unit t's input; its chunk's parameter
        gradients added to ``acc``."""
        if self.remat:
            with torch.enable_grad():
                leaf = self.saved.pop(t).detach().requires_grad_()
                y = self.chunk(r, leaf, m)
        else:
            leaf, y = self.saved.pop(t)
        grads = torch.autograd.grad(y, [leaf] + self.params[r], g_y,
                                    allow_unused=True)
        for j, g in enumerate(grads[1:]):
            acc[j] = _add(acc[j], g)
        return grads[0]

    def backward(self, g_out: torch.Tensor):
        """(the cotangent of the stack's input, None off stage 0; the
        gradients of ``self.params``, flat)."""
        rows = g_out.shape[0] // self.M
        zero = g_out.new_zeros((rows,) + tuple(g_out.shape[1:]))
        g_outputs = _output_cotangent(g_out, self.mesh).split(rows)
        acc = [[None] * len(ps) for ps in self.params]
        g_buf, g_in = [None] * self.M, [None] * self.M
        g_state = None
        n = len(self.ticks)
        for t in reversed(range(n)):
            g_y = (hop_back(zero if g_state is None else g_state, self.mesh)
                   if t + 1 < n else None)
            g_state = None
            for op in reversed(self.ticks[t]):
                if op[0] == "bank":
                    g_state = _add(g_state, g_buf[op[1]])
                    g_buf[op[1]] = None
                    continue
                _, m, r, emit = op
                if emit:
                    g_y = _add(g_y, g_outputs[m])
                g_x = self.unit_back(t, m, r, zero if g_y is None else g_y,
                                     acc[r])
                if self.stage != 0:
                    g_state = _add(g_state, g_x)
                elif r == 0:
                    g_in[m] = g_x
                else:
                    g_buf[m] = _add(g_buf[m], g_x)
        self.saved, self.masks = {}, {}
        g_x = (torch.cat([zero if g is None else g for g in g_in])
               if self.stage == 0 else None)
        flat = [torch.zeros_like(p) if g is None else g
                for ps, gs in zip(self.params, acc) for p, g in zip(ps, gs)]
        return g_x, flat


class _Stack(torch.autograd.Function):
    """The pipelined stack: forward ``_Run.forward``, backward the reverse
    schedule (``_Run.backward``)."""

    @staticmethod
    def forward(ctx, run: _Run, x: torch.Tensor, *params):
        ctx.run = run
        return run.forward(x, graph=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g_x, g_params = ctx.run.backward(g)
        ctx.run = None
        return (None, g_x, *g_params)


def _draws(bert: nn.Module, mesh: Mesh, x: torch.Tensor,
           generator: Optional[torch.Generator], n_virtual: int):
    """(each layer's attention seed, or None in eval mode or without
    attention dropout; {dropout: mask} of this rank's layers): the
    sequential stack's draws, in its order (a layer's attention seed, then
    its dropouts in the order of its modules, which is their order in its
    forward)."""
    c = bert.config
    attention = bert.training and c.attention_probs_dropout_prob > 0.0
    mine = set(chunk_layers(c.num_hidden_layers, mesh.shape[PIPE_AXIS],
                            n_virtual)[:, mesh.coords[PIPE_AXIS]].reshape(-1)
               .tolist())
    seeds, masks = [], {}
    for i, layer in enumerate(bert.encoder.layer):
        if attention:
            seeds.append(attention_seed(generator, x.device))
        for d in layer.modules():
            if isinstance(d, Dropout):
                mask = d.draw(x.shape, x.dtype, x.device)
                if mask is not None and i in mine:
                    masks[d] = mask
    return (seeds if attention else None), masks


def bert_forward_microbatched(bert: nn.Module, mesh: Mesh,
                              input_ids: torch.Tensor,
                              token_type_ids: torch.Tensor,
                              attention_mask: torch.Tensor, *,
                              n_microbatches: int,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """The sequential stack on ``n_microbatches`` row blocks one after the
    other, with the pipeline's draws (``_draws``) and no collective: what
    the pipeline computes, in the sequential order (the control for the
    order of summation in ``parallel/check.py::microbatch_step``). Every
    module of ``bert`` must be placed on ``mesh`` (``Mesh.set_batch``
    set)."""
    c = bert.config
    x = bert.embeddings(input_ids, token_type_ids)
    bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
    seeds, masks = _draws(bert, mesh, x, generator, 1)
    outs = []
    for m, (h, b) in enumerate(zip(x.chunk(n_microbatches),
                                   bias.chunk(n_microbatches))):
        mesh.micro = Microbatch(m, n_microbatches, masks)
        try:
            for i in range(c.num_hidden_layers):
                h = bert.encoder.layer[i](
                    h, b, seed=None if seeds is None else seeds[i])
        finally:
            mesh.micro = None
        outs.append(h)
    return widen(torch.cat(outs))


def bert_forward_pipelined(bert: nn.Module, mesh: Mesh,
                           input_ids: torch.Tensor,
                           token_type_ids: torch.Tensor,
                           attention_mask: torch.Tensor, *,
                           n_microbatches: int, n_virtual: int = 1,
                           remat: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """``bert`` (a ``models/bert.py::BertModel``) on this rank's rows over
    the mesh's ``pipe`` axis: last_hidden_state ``[rows, T, H]`` float32,
    the same on every stage, the counterpart of ``BertModel.forward`` (and
    of ``mimrl_tpu.parallel.pipeline.bert_forward_pipelined``). The mesh's
    batch must be set (``Mesh.set_batch``). ``generator`` feeds the
    attention dropout seeds in training mode."""
    c = bert.config
    S = mesh.shape[PIPE_AXIS]
    n_data = mesh.size(BATCH_AXES)
    rows = input_ids.shape[0]
    if rows != mesh.local_batch:
        raise ValueError(f"{rows} rows of input on a mesh whose batch "
                         f"(Mesh.set_batch) gives {mesh.local_batch} a rank")
    check_schedule(c.num_hidden_layers, S, n_microbatches, n_virtual,
                   rows * (n_data if mesh.sharded else 1), n_data)
    x = bert.embeddings(input_ids, token_type_ids)
    # additive bias in float32: 0 for valid keys, -1e9 for padding
    bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
    seeds, masks = _draws(bert, mesh, x, generator, n_virtual)
    run = _Run(mesh, bert, bias, seeds, masks, n_microbatches, n_virtual,
               remat)
    params = [p for ps in run.params for p in ps]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return widen(_Stack.apply(run, x, *params))
    return widen(run.forward(x, graph=False))
