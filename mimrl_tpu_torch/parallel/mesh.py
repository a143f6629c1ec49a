"""Device-mesh construction, sharding rules and the collectives of the
parallel training path (PyTorch port of ``mimrl_tpu.parallel.mesh``).

The JAX package lays its devices out as a ``(dcn, data, pipe, model)``
mesh and lets GSPMD insert the collectives. Here every rank of a
``torch.distributed`` group is one process on one device, ``Mesh`` lays
the ranks out in the same order (``model`` innermost, ``dcn`` outermost),
and the collectives are written out:

- the batch dimension is split over the batch axes (``dcn`` x ``data``,
  ``batch_axes``): rank b of them holds rows ``[b * bs / N, (b + 1) * bs /
  N)`` of the global batch (``shard_batch``; a leaf whose leading
  dimension does not divide stays whole on every rank, as in JAX);
- the model's outputs and the four summary features of those rows are
  gathered over the batch axes (``gather_rows``), so the task loss, the
  critics' ``[bs, bs]`` score matrices, the six kNN samples and the
  feature bank are those of the global batch, identical on every rank
  (as ``mimrl_tpu/parallel/mesh.py:10-15`` says of GSPMD);
- large 2-D kernels of BERT hold a column shard on each rank of ``model``
  (``param_sharding_rule``, ``shard_params``): the product runs on the
  shard and its output columns are gathered over ``model``; the MoE
  experts are split over ``model`` and their gated sum is completed there.
- ``--seq_shard`` (``Mesh.set_sequence``; a ``model`` axis, no ``pipe``)
  is Megatron's sequence parallelism on BERT (Korthikanti et al. 2022):
  between products a rank holds its time slice ``[b, T / m, H]``, on
  which the LayerNorms, the hidden dropouts (``Dropout`` draws the whole
  tensor's mask and keeps the slice's) and the residual adds run, so
  autograd keeps slices for them. The sequence is gathered over ``model``
  before each layer's first products (``seq_gather``: the fused QKV and
  the FFN up-projection, column blocks: this rank's heads and hidden
  units); the second products (the attention output dense and the FFN
  down-projection) hold row blocks (``shard_dim`` 1) and their partial
  sums are reduce-scattered back to the slice (``seq_scatter``). Every
  other BERT parameter is held whole and used on a slice or on a block
  of itself, so its gradient is partial and is summed over ``model``
  (``model_summed``, in ``reduce_gradients``). JAX constrains the same
  activations to ``P(data, model, None)`` between layers
  (``mimrl_tpu/models/bert.py:109-115``).

Every collective is an all-reduce (sum) over a subgroup: an all-gather is
the all-reduce of a zero buffer that holds this rank's block, which is
exact and which both NCCL and gloo take on CUDA tensors (gloo has no
all-gather of CUDA tensors); a reduce-scatter is the all-reduce followed
by this rank's block (exact; only the transient buffer is whole).
Low-precision tensors are summed in float32.

The gradient. Every rank computes the same global loss ``L`` from the
gathered tensors. The backward of ``gather_rows`` sums the gathered
tensor's gradient over the batch axes and takes this rank's rows: each of
the N batch ranks holds the same ``dL/dX``, so rank b's rows receive
``N * dL/dX_b``, and a parameter before the gather gets ``N`` times its
rows' share of the single-process gradient. A parameter after the gather
(the critics) gets its whole gradient on every rank. ``reduce_gradients``
AVERAGES every gradient over the batch axes, before the optimizer clips
it: ``(1/N) sum_b N g_b = g`` for the first kind and ``(1/N) N g = g``
for the second, so every parameter gets the single-process gradient. The
task loss is the masked mean over the global batch (``sample_mask``
included), computed once from the gathered outputs, so padded rows need
no other care. Summing instead of averaging (DDP's default without its
division) gives ``N g``; ``parallel/check.py``'s fault controls show that
the equality gate catches it. On a ``model`` axis the column gathers take
this rank's columns in their backward (the gradient downstream is the
same on every rank of ``model``), the inputs of a sharded product sum
their partial gradients over ``model`` (``copy_to``), and a sharded
parameter is averaged over the batch axes alone.

Dropout (``Dropout``, and the attention's Philox mask through its batch
offset): a rank draws the single-process mask of the global batch and
keeps its rows, so a data-parallel step with dropout on equals the
single-process step; every rank draws from the same generators in the
same order, so they stay in step.

The ``pipe`` axis (``parallel/pipeline.py``): every rank holds every
parameter, as in JAX (``mimrl_tpu/parallel/pipeline.py:42-48``), and runs
only its stage's chunks of BERT's layers on microbatches of its rows. The
activations move between stages by ``hop`` (the counterpart of
``lax.ppermute(y, PIPE_AXIS, [(i, (i + 1) % S)])``, an all-reduce of a
zero ``[S, ...]`` buffer as every collective here), and the last stage's
output is summed over ``pipe`` so every stage holds it. BERT's gradients
are then non-zero on their owning stage only: ``shard_params`` marks
BERT's parameters (``pipe_summed``) and ``reduce_gradients`` sums them over
``pipe`` in the same all-reduce that averages them over the batch axes;
the parameters after the stack get the same gradient on every stage and
are averaged over the batch axes alone. BERT's four dense kernels stay
whole on a pipe mesh (JAX's ``shard_map`` takes each stage's layers whole
on every rank of ``model``, ``pipeline.py:200-206``). Inside a microbatch
(``Mesh.micro``) the dropouts apply the microbatch's rows of the masks
that the pipeline drew ahead, in the sequential stack's order, and the
attention's Philox rows are the microbatch's rows of the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mimrl_tpu_torch.core.spans import span

DCN_AXIS = "dcn"
DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
AXES = (DCN_AXIS, DATA_AXIS, PIPE_AXIS, MODEL_AXIS)
BATCH_AXES = (DCN_AXIS, DATA_AXIS)


@dataclasses.dataclass
class Microbatch:
    """The microbatch that a pipeline unit runs: ``index`` of ``count``,
    and the masks of this rank's rows that the pipeline drew ahead for
    the dropouts of its layers (``Dropout.draw``), by dropout."""

    index: int
    count: int
    masks: Dict[nn.Module, torch.Tensor]


class Mesh:
    """The ranks ``0 .. n - 1`` of the default process group laid out as
    a ``(dcn, data, pipe, model)`` array, row-major. ``rank`` is this
    process's rank. ``connect()`` creates the subgroups of the batch axes,
    of ``pipe``, of ``model`` and of the batch axes with ``pipe`` and with
    ``model`` (every rank must call it, in the same order); a mesh that is not connected
    holds the layout only (the sharding rules read nothing else).

    ``set_batch(n)`` fixes the run's global batch size: it is split over
    the batch axes when it divides (``sharded``), else every rank holds
    it whole. ``set_pipeline(M, v, remat)`` fixes the pipeline's schedule
    (``parallel/pipeline.py``); ``micro`` is the ``Microbatch`` that a
    pipeline unit runs, None outside one."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.dims = tuple(self.shape[a] for a in AXES)
        self.ranks = np.arange(int(np.prod(self.dims))).reshape(self.dims)
        if not 0 <= rank < self.ranks.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.ranks.size}")
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in
                                      np.unravel_index(rank, self.dims))))
        self.backend: Optional[str] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.set_batch(None)
        self.set_pipeline()
        self.set_sequence(False)
        self.micro: Optional[Microbatch] = None

    def __repr__(self) -> str:
        return ("Mesh(" + " x ".join(f"{a} {self.shape[a]}" for a in AXES)
                + f", rank {self.rank}, backend {self.backend})")

    @property
    def n_ranks(self) -> int:
        return int(self.ranks.size)

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def members(self, axes: Sequence[str]) -> List[int]:
        """The ranks that share every coordinate but ``axes`` with this
        rank, in the order of their coordinates on ``axes``."""
        index = tuple(slice(None) if a in axes else self.coords[a]
                      for a in AXES)
        return [int(r) for r in self.ranks[index].reshape(-1)]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position among ``members(axes)``."""
        return self.members(axes).index(self.rank)

    def connect(self) -> "Mesh":
        """Create the subgroups (collective: every rank calls it)."""
        if not dist.is_initialized():
            raise RuntimeError("Mesh.connect needs an initialised process "
                               "group (torch.distributed)")
        world = dist.get_world_size()
        if world != self.n_ranks:
            raise ValueError(f"{self!r} needs a group of {self.n_ranks} "
                             f"ranks, the group has {world}")
        self.backend = dist.get_backend()
        for axes in (BATCH_AXES, (PIPE_AXIS,), (MODEL_AXIS,),
                     BATCH_AXES + (PIPE_AXIS,), BATCH_AXES + (MODEL_AXIS,)):
            others = [a for a in AXES if a not in axes]
            seen = set()
            for r in range(self.n_ranks):
                coords = np.unravel_index(r, self.dims)
                key = tuple(int(coords[AXES.index(a)]) for a in others)
                if key in seen:
                    continue
                seen.add(key)
                index = tuple(slice(None) if a in axes
                              else int(coords[AXES.index(a)]) for a in AXES)
                ranks = [int(x) for x in self.ranks[index].reshape(-1)]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = group
        return self

    def group(self, axes: Sequence[str]):
        axes = tuple(axes)
        if axes not in self._groups:
            raise RuntimeError(f"{self!r} is not connected (Mesh.connect)")
        return self._groups[axes]

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may capture this mesh's collectives: NCCL's
        can be captured, gloo's cannot."""
        return self.backend == "nccl"

    def set_batch(self, n: Optional[int]) -> None:
        """The run's global batch size ``n``: ``sharded`` when the batch
        axes divide it, ``local_batch`` rows from ``row_lo`` on this rank."""
        n_batch = self.size(BATCH_AXES)
        self.global_batch = n
        self.sharded = n is not None and n_batch > 1 and n % n_batch == 0
        self.local_batch = n // n_batch if self.sharded else n
        self.row_lo = (self.index(BATCH_AXES) * self.local_batch
                       if self.sharded else 0)

    def set_pipeline(self, n_microbatches: int = 1, n_virtual: int = 1,
                     remat: bool = False) -> None:
        """The run's pipeline schedule (``--pipe_microbatches``,
        ``--pipe_virtual``, ``--pipe_remat``), read where the model's
        forward runs BERT over ``pipe``."""
        self.n_microbatches = int(n_microbatches)
        self.n_virtual = max(int(n_virtual), 1)
        self.remat = bool(remat)

    def set_sequence(self, seq_shard: bool) -> None:
        """``--seq_shard``: BERT's activations held as time slices over
        ``model`` (``seq_shard``), on a ``model`` axis without ``pipe``
        (the pipeline's stages hold whole sequences, as JAX's
        ``shard_map`` does)."""
        self.seq_shard = (bool(seq_shard) and self.shape[MODEL_AXIS] > 1
                          and self.shape[PIPE_AXIS] == 1)


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, dcn: int = 1,
              n_ranks: Optional[int] = None, rank: Optional[int] = None
              ) -> Mesh:
    """Build a (dcn, data, pipe, model) mesh over ``n_ranks`` ranks (the
    default group's size, or 1 without a group). ``data=-1`` uses all
    remaining ranks; the other axes take 1 for a size of 0 or less (the
    rules of ``mimrl_tpu/parallel/mesh.py:30-58``). With a process group
    the mesh is connected; ``rank`` defaults to this process's rank."""
    grouped = dist.is_initialized()
    n = n_ranks if n_ranks is not None else (
        dist.get_world_size() if grouped else 1)
    model = model if model > 0 else 1
    pipe = pipe if pipe > 0 else 1
    dcn = dcn if dcn > 0 else 1
    if data <= 0:
        data = n // (model * pipe * dcn)
    assert data * model * pipe * dcn <= n, (
        f"mesh {dcn}x{data}x{pipe}x{model} needs "
        f"{data * model * pipe * dcn} devices, have {n}"
    )
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    mesh = Mesh({DCN_AXIS: dcn, DATA_AXIS: data, PIPE_AXIS: pipe,
                 MODEL_AXIS: model}, rank)
    if grouped and n_ranks is None:
        mesh.connect()
    return mesh


def batch_axes(mesh: Mesh):
    """The mesh axes the batch dimension shards over: (dcn, data) on a
    multi-slice mesh, plain 'data' otherwise."""
    if mesh.shape[DCN_AXIS] > 1:
        return (DCN_AXIS, DATA_AXIS)
    return DATA_AXIS


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every tensor or array leaf of a batch (dicts,
    lists and tuples are walked): leaves whose leading dimension the batch
    axes divide are split over them, the others stay whole."""
    n_batch = mesh.size(BATCH_AXES)
    b = mesh.index(BATCH_AXES)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % n_batch == 0:
            n = x.shape[0] // n_batch
            return x[b * n:(b + 1) * n]
        return x

    return place(batch)


# ---------------------------------------------------------------------- #
# Sharding rules (mimrl_tpu/parallel/mesh.py:96-133)


def param_sharding_rule(mesh: Mesh, min_size: int = 2048):
    """Return ``rule(path, shape) -> spec``, JAX's rule on a flax leaf:
    ``path`` the leaf's path string, ``shape`` its flax shape, ``spec`` a
    tuple of axis names or None per dimension (``()`` = replicated).

    - MoE expert weights (under a ``moe_*`` module, not the router, a
      leading expert axis divisible by ``model``) shard expert-wise;
    - 2-D kernels whose output axis divides and that hold at least
      ``min_size`` elements shard their output axis over ``model``;
      embedding tables stay replicated;
    - everything else is replicated (all of it with ``model=1``)."""
    n_model = mesh.shape[MODEL_AXIS]

    def rule(path: str, shape: Sequence[int]) -> Tuple:
        if n_model > 1:
            ndim = len(shape)
            if ("moe_" in path and "router" not in path and ndim >= 2
                    and shape[0] % n_model == 0):
                return (MODEL_AXIS,) + (None,) * (ndim - 1)
            if (ndim == 2 and shape[1] % n_model == 0
                    and math.prod(shape) >= min_size
                    and not path.endswith("embedding")):
                return (None, MODEL_AXIS)
        return ()

    return rule


def flax_views(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{parameter name: (path, shape)} of the flax leaf that each of the
    port's parameters stands for (``models/convert.py`` maps the trees):
    ``nn.Linear`` and recurrent weights transposed, Conv1d kernels as
    ``[3, in, out]``, BERT's query/key/value weights as the fused QKV
    kernel ``[H, 3H]`` (and bias ``[3H]``), the fusions' attention
    projections as ``DenseGeneral`` kernels ``[d, H, hd]`` / ``[H, hd,
    d]`` (biases ``[H, hd]``), embedding tables under a path ending in
    ``embedding``; the rest as they are."""
    from mimrl_tpu_torch.models.bert import BertSelfAttention
    from mimrl_tpu_torch.models.fusion import MultiHeadAttention

    parents = {name: mod for name, mod in model.named_modules()}
    views = {}
    for mod_name, mod in model.named_modules():
        parent = parents.get(mod_name.rpartition(".")[0])
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            shape, path = tuple(p.shape), name
            if isinstance(mod, nn.Embedding):
                path = mod_name + ".embedding"
            elif isinstance(parent, BertSelfAttention):
                shape = ((shape[1], 3 * shape[0]) if pname == "weight"
                         else (3 * shape[0],))
            elif isinstance(parent, MultiHeadAttention):
                heads = parent.num_heads
                d = shape[-1]
                if mod_name.endswith(".out"):
                    shape = ((heads, d // heads, d) if pname == "weight"
                             else shape)
                else:
                    shape = ((d, heads, d // heads) if pname == "weight"
                             else (heads, shape[0] // heads))
            elif isinstance(mod, nn.Conv1d) and pname == "weight":
                shape = tuple(reversed(shape))
            elif (isinstance(mod, (nn.Linear, nn.RNNBase))
                  and len(shape) == 2):
                shape = (shape[1], shape[0])
            views[name] = (path, shape)
    return views


def param_specs(mesh: Mesh, model: nn.Module) -> Dict[str, Tuple]:
    """``param_sharding_rule``'s spec (flax layout) of every parameter."""
    rule = param_sharding_rule(mesh)
    return {name: rule(path, shape)
            for name, (path, shape) in flax_views(model).items()}


ROW_PARALLEL = ("attention.output.dense.weight", "output.dense.weight")


def _sharded_forward(name: str, pipelined: bool = False) -> bool:
    """Parameters whose layer has a sharded forward here: BERT's four
    dense kernels (fused QKV, attention output, FFN up and down), but not
    on a pipe mesh (``pipelined``), and the MoE experts."""
    parts = name.split(".")
    if "moe_" in name and parts[-1] in ("w1", "b1", "w2", "b2"):
        return True
    return (not pipelined and "encoder" in parts and "layer" in parts
            and parts[-1] == "weight"
            and any(name.endswith(s) for s in (
                "attention.self.query.weight", "attention.self.key.weight",
                "attention.self.value.weight", "attention.output.dense.weight",
                "intermediate.dense.weight", "output.dense.weight")))


def shard_dim(p: torch.Tensor) -> Optional[int]:
    """The dimension of a parameter that ``shard_params`` split over
    ``model`` (0: a block of output rows, 1: under ``--seq_shard`` the
    second products' block of input columns), or None for a whole one."""
    return getattr(p, "mimrl_shard_dim", None)


def model_summed(p: torch.Tensor) -> bool:
    """Whether ``shard_params`` marked a whole parameter whose gradient a
    rank computes in part, to be summed over ``model`` (BERT's under
    ``--seq_shard``)."""
    return getattr(p, "mimrl_model_sum", False)


def shard_params(mesh: Mesh, model: nn.Module) -> List[str]:
    """Place ``model`` on the mesh: every module gets ``mesh`` (the
    dropouts, BERT, the MoE blocks and ``forward_batch`` read it), and
    each parameter that the rule shards and whose layer has a sharded
    forward (``_sharded_forward``) is replaced by this rank's block of its
    sharded axis (torch's output dimension 0 for a ``Linear`` weight, the
    expert axis for the experts; under ``mesh.seq_shard`` the attention
    output dense and the FFN down-projection take their input dimension
    1, row parallel, and every other BERT parameter is marked
    ``model_summed``). The other parameters the rule shards (the critics'
    MLPs, ``W_t``, the GRUs, CubeMLP at large widths) are held whole on
    every rank, which computes the same values. On a pipe mesh BERT's
    parameters are marked for the sum over ``pipe`` (``pipe_summed``).
    Returns the names held sharded."""
    from mimrl_tpu_torch.models.bert import BertModel

    n_model = mesh.shape[MODEL_AXIS]
    m = mesh.coords[MODEL_AXIS]
    pipelined = mesh.shape[PIPE_AXIS] > 1
    for mod in model.modules():
        mod.mesh = mesh
        if pipelined and isinstance(mod, BertModel):
            for p in mod.parameters():
                p.mimrl_pipe_sum = True
    held = []
    if n_model == 1:
        return held
    owners = dict(model.named_modules())
    for name, spec in param_specs(mesh, model).items():
        if MODEL_AXIS not in spec or not _sharded_forward(name, pipelined):
            continue
        mod_name, _, pname = name.rpartition(".")
        owner = owners[mod_name]
        p = getattr(owner, pname)
        dim = 1 if mesh.seq_shard and name.endswith(ROW_PARALLEL) else 0
        if p.shape[dim] % n_model:
            continue
        block = p.shape[dim] // n_model
        shard = nn.Parameter(
            p.detach().narrow(dim, m * block, block).clone(),
            requires_grad=p.requires_grad)
        shard.mimrl_shard_dim = dim
        setattr(owner, pname, shard)
        held.append(name)
    if mesh.seq_shard:
        for mod in model.modules():
            if isinstance(mod, BertModel):
                for p in mod.parameters():
                    if shard_dim(p) is None:
                        p.mimrl_model_sum = True
    return held


def pipe_summed(p: torch.Tensor) -> bool:
    """Whether ``shard_params`` marked a parameter for the sum over
    ``pipe`` (BERT's, on a pipe mesh)."""
    return getattr(p, "mimrl_pipe_sum", False)


def mesh_of(module: nn.Module) -> Optional[Mesh]:
    """The mesh that ``shard_params`` placed ``module`` on, or None."""
    return getattr(module, "mesh", None)


# ---------------------------------------------------------------------- #
# Collectives (all-reduce only; autograd-aware)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def all_reduce(t: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """The sum of ``t`` over ``axes`` (a new tensor in ``t``'s dtype;
    low-precision tensors are summed in float32)."""
    buf = t.detach().to(_acc_dtype(t.dtype), copy=True).contiguous()
    dist.all_reduce(buf, group=mesh.group(axes))
    return buf.to(t.dtype)


def _gather_dim(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
                dim: int) -> torch.Tensor:
    n, i = mesh.size(axes), mesh.index(axes)
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = n * width
    buf = torch.zeros(shape, dtype=_acc_dtype(x.dtype), device=x.device)
    buf.narrow(dim, i * width, width).copy_(x)
    dist.all_reduce(buf, group=mesh.group(axes))
    return buf.to(x.dtype)


def _block(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
           dim: int) -> torch.Tensor:
    n, i = mesh.size(axes), mesh.index(axes)
    width = x.shape[dim] // n
    return x.narrow(dim, i * width, width).contiguous()


@torch.no_grad()
def gather_blocks(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """A tensor that ``shard_params`` split over ``model``, whole."""
    return _gather_dim(t, mesh, (MODEL_AXIS,), dim)


def take_block(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of a whole tensor (the inverse of
    ``gather_blocks``)."""
    return _block(t, mesh, (MODEL_AXIS,), dim)


def _shift(x: torch.Tensor, mesh: Mesh, step: int) -> torch.Tensor:
    """Rank i's ``x`` on rank ``(i + step) % S`` of ``pipe``: rank i writes
    slot ``(i + step) % S`` of a zero ``[S, ...]`` buffer, the buffer is
    summed over ``pipe`` and rank j reads slot j (exact)."""
    n, i = mesh.size((PIPE_AXIS,)), mesh.index((PIPE_AXIS,))
    buf = torch.zeros((n,) + tuple(x.shape), dtype=_acc_dtype(x.dtype),
                      device=x.device)
    buf[(i + step) % n].copy_(x)
    with span("pipe_hop"):
        dist.all_reduce(buf, group=mesh.group((PIPE_AXIS,)))
    return buf[i].to(x.dtype)


class _Hop(torch.autograd.Function):
    """Forward: the value of the previous rank of ``pipe`` (rank i's ``x``
    on rank ``(i + 1) % S``). Backward: the reverse hop."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, -1), None


class _GatherRows(torch.autograd.Function):
    """Forward: the global batch from every batch rank's rows. Backward:
    the gradient summed over the batch axes, this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_dim(x, mesh, BATCH_AXES, 0)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return _block(all_reduce(g, mesh, BATCH_AXES), mesh, BATCH_AXES,
                      0), None


class _Gather(torch.autograd.Function):
    """Forward: blocks of ``dim`` gathered over ``axes``. Backward: this
    rank's block (the gradient is the same on every rank of ``axes``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """Forward: this rank's block of ``dim``. Backward: the blocks'
    gradients gathered over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: identity. Backward: the partial gradients of the ranks of
    ``axes`` summed (the input of a sharded product)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Forward: the ranks' partial values summed over ``axes``. Backward:
    identity (the gradient is the same on every rank of ``axes``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _scatter_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial sums' total over ``model`` (the reduce in
    ``seq_scatter``)."""
    return all_reduce(x, mesh, (MODEL_AXIS,))


class _SeqGather(torch.autograd.Function):
    """Forward: the time slices ``[b, T / m, ...]`` gathered to ``[b, T,
    ...]`` over ``model``. Backward: the reduce-scatter: the ranks'
    partial gradients (each from its own heads or hidden units) summed,
    this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_dim(x, mesh, (MODEL_AXIS,), 1)

    @staticmethod
    def backward(ctx, g):
        return _block(all_reduce(g, ctx.mesh, (MODEL_AXIS,)), ctx.mesh,
                      (MODEL_AXIS,), 1), None


class _SeqScatter(torch.autograd.Function):
    """Forward: the reduce-scatter of a row-parallel product's partial
    sums ``[b, T, ...]``: their total, this rank's time slice. Backward:
    the slices' gradients gathered over ``model``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(_scatter_sum(x, mesh), mesh, (MODEL_AXIS,), 1)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.mesh, (MODEL_AXIS,), 1), None


def seq_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SeqGather.apply(x, mesh)


def seq_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SeqScatter.apply(x, mesh)


def time_slice(mesh: Mesh, t: int) -> Tuple[int, int]:
    """(first step, steps) of this rank's slice of a sequence of ``t``
    steps under ``--seq_shard``; raises where ``model`` does not divide
    ``t``."""
    n = mesh.shape[MODEL_AXIS]
    if t % n:
        raise ValueError(f"--seq_shard: a sequence of {t} steps does not "
                         f"split into {n} equal slices over model "
                         "(--time_len must divide by --mesh_model)")
    return mesh.coords[MODEL_AXIS] * (t // n), t // n


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows -> the global batch (a no-op when the batch is not
    split)."""
    if mesh is None or not mesh.sharded:
        return x
    return _GatherRows.apply(x, mesh)


def hop(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``lax.ppermute(x, PIPE_AXIS, [(i, (i + 1) % S)])``, differentiable."""
    return _Hop.apply(x, mesh)


def hop_back(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The transpose of ``hop``: rank j's ``g`` on rank ``(j - 1) % S``."""
    return _shift(g, mesh, -1)


def gather(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
           dim: int) -> torch.Tensor:
    return _Gather.apply(x, mesh, tuple(axes), dim)


def split(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
          dim: int) -> torch.Tensor:
    return _Split.apply(x, mesh, tuple(axes), dim)


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, tuple(axes))


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
                ) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, tuple(axes))


def gather_columns(y: torch.Tensor, mesh: Mesh, parts: int = 1
                   ) -> torch.Tensor:
    """The output of a column-sharded product, ``[..., parts * n / M]`` on
    each rank of ``model`` holding its block of each of ``parts``
    concatenated outputs (BERT's q, k, v), gathered to ``[..., parts *
    n]`` in the single-process column order."""
    n_model = mesh.shape[MODEL_AXIS]
    full = gather(y, mesh, (MODEL_AXIS,), y.dim() - 1)
    if parts == 1:
        return full
    lead = full.shape[:-1]
    block = y.shape[-1] // parts
    return (full.reshape(*lead, n_model, parts, block).transpose(-3, -2)
            .reshape(*lead, n_model * parts * block))


def reduce_gradients(mesh: Optional[Mesh], grads: List[torch.Tensor],
                     params: Optional[Sequence[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """Every gradient averaged over the batch axes (the module docstring
    says why the average gives the single-process gradient), in one
    all-reduce of the flat gradients; on a pipe mesh the gradients of the
    ``params`` that ``pipe_summed`` marks (BERT's, non-zero on their
    owning stage only) are summed over ``pipe`` in the same all-reduce, a
    second one over the batch axes and ``pipe``; under ``--seq_shard`` the
    gradients of those that ``model_summed`` marks (a rank's part: its
    time slice, its block of heads or hidden units) are summed over
    ``model``, one more over the batch axes and ``model``."""
    if mesh is None or not grads:
        return grads
    kinds = ([(False, False)] * len(grads) if params is None
             else [(pipe_summed(p), model_summed(p)) for p in params])
    out = list(grads)
    for kind in ((False, False), (True, False), (False, True)):
        axes = (BATCH_AXES + ((PIPE_AXIS,) if kind[0] else ())
                + ((MODEL_AXIS,) if kind[1] else ()))
        picked = [i for i, k in enumerate(kinds) if k == kind]
        if not picked:
            continue
        part = [grads[i] for i in picked]
        flat = torch.cat([g.reshape(-1).to(
            torch.float32 if g.dtype != torch.float64 else g.dtype)
            for g in part])
        if mesh.size(axes) > 1:
            with span("grad_reduce"):
                dist.all_reduce(flat, group=mesh.group(axes))
        flat = flat / mesh.size(BATCH_AXES)
        for i, f, g in zip(picked, flat.split([g.numel() for g in part]),
                           part):
            out[i] = f.view(g.shape).to(g.dtype)
    return out


# ---------------------------------------------------------------------- #
# Dropout over the global batch


def _fused_scale(dropout_p: float) -> float:
    """The scale that torch's fused CUDA dropout applies in its forward,
    ``float32(1 / float32(1 - p))`` (its backward takes ``1 / (1 - p)``)."""
    keep = float(torch.tensor(1.0 - dropout_p, dtype=torch.float32))
    return float(torch.tensor(1.0 / keep, dtype=torch.float32))


def _global_scratch(x: torch.Tensor, n: int) -> torch.Tensor:
    """An empty tensor of the global batch's shape ``[n, ...]`` with the
    strides of ``x``, the layout the single-process ``F.dropout`` draws
    its mask in (``empty_like`` of the whole batch). ``x`` must be dense
    with its batch dimension outermost, as every dropout input of the
    model is (CubeMLP's are permuted inside a row)."""
    inner = [(st, sz) for st, sz in zip(x.stride()[1:], x.shape[1:]) if sz > 1]
    size = 1
    for st, sz in sorted(inner):
        if st != size:
            break
        size *= sz
    if size != math.prod(x.shape[1:]) or x.stride(0) != size:
        raise ValueError(f"Dropout on a mesh: strides {x.stride()} of shape "
                         f"{tuple(x.shape)} are not dense with the batch "
                         "outermost")
    return torch.empty_strided((n,) + tuple(x.shape[1:]), x.stride(),
                               dtype=x.dtype, device=x.device)


class _FusedMaskDropout(torch.autograd.Function):
    """CUDA: a mask of torch's fused dropout applied as the fused kernel
    applies it (``native_dropout_backward``: ``x * mask * scale`` in
    float32, one rounding); the backward is the fused backward's own
    kernel on the 1-byte mask."""

    @staticmethod
    def forward(ctx, x, mask, dropout_p):
        ctx.save_for_backward(mask)
        ctx.scale = 1.0 / (1.0 - dropout_p)
        return torch.ops.aten.native_dropout_backward(
            x, mask, _fused_scale(dropout_p))

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return (torch.ops.aten.native_dropout_backward(g, mask, ctx.scale),
                None, None)


class Dropout(nn.Dropout):
    """``nn.Dropout``, whose mask on a data-parallel mesh is this rank's
    rows of the single-process mask of the global batch, so that a mesh
    step with dropout on equals the single-process step. Without a mesh,
    or with the batch whole on every rank, it is ``F.dropout`` (torch's
    fused kernel on the card). On a split batch (``Mesh.row_lo``) the rank
    draws the global batch's mask as ``F.dropout`` would, in the same
    layout (``_global_scratch``): on the card the fused kernel's
    (``native_dropout`` over a scratch tensor of the global shape with
    ``x``'s dtype and strides: the draw depends on the element count, the
    dtype, the layout and the alignment, not on the values), on the CPU
    ``F.dropout``'s noise tensor in ``x``'s dtype, divided by ``1 - p``;
    both apply it with ``F.dropout``'s arithmetic, bit for bit
    (``_FusedMaskDropout`` on the card). ``draw`` takes the same draw
    ahead of the input: inside a pipeline's microbatch (``Mesh.micro``)
    the dropout applies the microbatch's rows of the mask that the
    pipeline drew for it. ``mesh`` is set by ``shard_params``."""

    mesh: Optional[Mesh] = None

    def _draw(self, scratch: torch.Tensor, lo: int, rows: int
              ) -> torch.Tensor:
        """Rows ``[lo, lo + rows)`` of the mask that ``F.dropout`` draws on
        ``scratch`` (the 1-byte mask on the card, the scaled noise on the
        CPU)."""
        if scratch.device.type == "cuda":
            return torch.native_dropout(scratch, self.p, True)[1][lo:lo + rows]
        noise = scratch.bernoulli_(1.0 - self.p)
        return noise[lo:lo + rows].div_(1.0 - self.p)

    def _apply_mask(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda":
            return _FusedMaskDropout.apply(x, mask, self.p)
        return x * mask

    def draw(self, shape: Sequence[int], dtype: torch.dtype, device
             ) -> Optional[torch.Tensor]:
        """The mask that ``forward`` would draw now for a dense input of
        ``shape`` (this rank's rows), or None where it draws none (p 0 or
        1, eval mode)."""
        if not self.training or not 0.0 < self.p < 1.0:
            return None
        mesh = self.mesh
        rows = shape[0]
        n, lo = ((mesh.global_batch, mesh.row_lo)
                 if mesh is not None and mesh.sharded else (rows, 0))
        scratch = torch.empty((n,) + tuple(shape[1:]), dtype=dtype,
                              device=device)
        return self._draw(scratch, lo, rows)

    def forward(self, x: torch.Tensor,
                time: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``time``: (first step, whole length) when ``x`` is a time slice
        ``[b, T / m, ...]`` (``--seq_shard``): the mask is the slice's part
        of the whole tensor's, which is drawn in its dense layout."""
        mesh = self.mesh
        if not self.training or self.p == 0.0 or x.numel() == 0:
            return F.dropout(x, self.p, self.training)
        if self.p >= 1.0:
            return x * torch.zeros((), dtype=x.dtype, device=x.device)
        if time is not None:
            rows = x.shape[0]
            n, lo = ((mesh.global_batch, mesh.row_lo) if mesh.sharded
                     else (rows, 0))
            scratch = torch.empty((n, time[1]) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=x.device)
            mask = self._draw(scratch, lo, rows).narrow(1, time[0], x.shape[1])
            return self._apply_mask(x, mask.contiguous())
        micro = None if mesh is None else mesh.micro
        if micro is not None:
            rows = x.shape[0]
            return self._apply_mask(
                x, micro.masks[self].narrow(0, micro.index * rows, rows))
        if mesh is None or not mesh.sharded:
            return F.dropout(x, self.p, self.training)
        if x.shape[0] != mesh.local_batch:
            raise ValueError(
                f"Dropout on a mesh: a leading dimension of {x.shape[0]}, "
                f"this rank holds {mesh.local_batch} rows")
        scratch = _global_scratch(x, mesh.global_batch)
        return self._apply_mask(x, self._draw(scratch, mesh.row_lo,
                                              x.shape[0]))


def attention_batch_offset(module: nn.Module) -> int:
    """The global row of this rank's first batch row in the attention's
    Philox dropout mask (0 without a split batch), inside microbatch m of
    a pipeline ``row_lo + m * mb``."""
    mesh = mesh_of(module)
    if mesh is None:
        return 0
    if mesh.micro is None:
        return mesh.row_lo
    return mesh.row_lo + mesh.micro.index * (mesh.local_batch
                                             // mesh.micro.count)
