"""Configuration system (the port's own copy of ``mimrl_tpu.core.config``).

Reproduces the full ~50-flag CLI surface of the reference
(ref: Parameters.py:4-74) — same flag names, same defaults, same string
DSLs — as a typed dataclass that the rest of the framework consumes.

The field set, defaults and validation are those of the JAX package, so
a ``config.json`` written by ``mimrl_tpu`` loads here unchanged. Fields
that only the JAX package acts on (mesh shape, scan schedules, RNG
implementation, checkpoint backend) are carried so such files round-trip;
the port reads the ones its slice implements. Invalid values raise
``ValueError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional

from mimrl_tpu_torch.utils.parsers import str2bools, str2floats, str2listoffints


@dataclass
class MimrlConfig:
    # --- Names, paths, logs (ref: Parameters.py:8) ---
    task_name: str = "test"

    # --- Data parameters (ref: Parameters.py:11-23) ---
    dataset: str = "mosi_SDK"
    normalize: List[bool] = field(default_factory=lambda: [False, False, False])
    log_scale: List[bool] = field(default_factory=lambda: [False, False, False])
    text: str = "text"
    audio: str = "covarep"
    video: str = "facet41"
    batch_size: int = 16
    num_workers: int = 4
    # torch-DataLoader knobs accepted for CLI parity (ref:
    # Parameters.py); no-ops here — batches are static device arrays
    persistent_workers: bool = False
    pin_memory: bool = False
    drop_last: bool = False
    task: str = "regression"  # classification | regression
    num_class: int = 1

    # --- Model parameters (ref: Parameters.py:26-38) ---
    d_common: int = 128
    encoders: str = "gru"  # gru | lstm | conv
    features_compose_t: str = "mean"  # mean | sum | cat
    features_compose_k: str = "mean"  # mean | sum | cat
    activate: str = "gelu"
    time_len: int = 100
    d_hiddens: List[List[int]] = field(
        default_factory=lambda: [[10, 2, 128], [5, 2, 128]]
    )
    d_outs: List[List[int]] = field(default_factory=lambda: [[10, 2, 128], [5, 2, 128]])
    dropout_mlp: List[float] = field(default_factory=lambda: [0.5, 0.5, 0.5])
    dropout: List[float] = field(default_factory=lambda: [0.5, 0.5, 0.5, 0.5])
    bias: bool = False
    ln_first: bool = False
    res_project: List[bool] = field(default_factory=lambda: [True, True])

    # --- VMI estimation (ref: Parameters.py:41-51) ---
    critic_type: str = "separate"  # separate | concat
    baseline_type: str = "constant"  # constant | unnormalized | gaussain [sic]
    bound_type: str = "infonce"  # dv mine tuba nwj infonce js js_fgan smile interpolate
    loss_mi_coefficient1: List[float] = field(default_factory=lambda: [0.1] * 11)
    loss_mi_coefficient2: List[float] = field(default_factory=lambda: [0.1] * 8)
    mi_lr_rate: float = 1.0
    cmi_lr_rate: float = 1.0  # parsed but unused by Solver (ref: Solver.py:140-142)
    k_neighbor: int = 2
    radius: float = 1.0
    cmi_last_acticate: str = "sigmoid"  # hardtanh | sigmoid  [sic spelling]
    stage1_n: int = 1

    # --- Training and optimization (ref: Parameters.py:54-70) ---
    seed: int = 0
    loss: str = "MAE"  # Focal CE BCE RMSE MSE SIMSE MAE CCC
    gradient_clip: float = 1.0
    epochs_num: int = 2
    optm: str = "Adam"  # SGD | SAM | Adam
    learning_rate: float = 4e-3
    bert_freeze: str = "no"  # part | no | all
    bert_lr_rate: float = -1.0
    weight_decay: float = 0.0
    lr_decrease: str = "step"  # multi_step | step | exp | plateau
    lr_decrease_iter: str = "60"
    lr_decrease_rate: float = 0.1
    save_best_features: bool = False
    # write the best_valid/best_test model checkpoints at run end
    # (ref: Solver.py:530-531). --no_save_models skips them — for
    # measurement/sweep runs where the ~GB-scale device->host pulls and
    # disk writes are pure overhead.
    save_models: bool = True
    print_params: bool = False
    check_gradient: bool = False
    # accepted for CLI parity; no-ops on TPU (the reference's de-facto
    # mandatory DataParallel flag and CUDA id string, ref: Parameters.py)
    parallel: bool = False
    cuda: str = "0"

    # --- TPU-native extensions (new in mimrl_tpu) ---
    mesh_data: int = -1  # -1 = all visible devices on the data axis
    mesh_model: int = 1  # tensor-parallel axis size
    # multi-slice data parallelism: leading mesh axis mapped to the slice
    # boundary — batch shards over dcn x data, params replicate per
    # slice, so only the gradient all-reduce crosses the data-center
    # network (pipe/model traffic stays on intra-slice ICI). 1 = off.
    mesh_dcn: int = 1
    # pipeline parallelism: split the BERT stack into this many stages on
    # a dedicated mesh axis (parallel/pipeline.py); 1 = off
    mesh_pipe: int = 1
    pipe_microbatches: int = 4
    # interleaved pipeline schedule (Megatron interleaved-1F1B layer
    # assignment): each device holds this many non-contiguous layer
    # chunks and microbatches traverse the ring that many times; the
    # pipeline bubble shrinks ~v-fold at equal microbatches. Needs
    # bert_layers % (mesh_pipe * pipe_virtual) == 0 and
    # pipe_microbatches >= mesh_pipe. 1 = plain GPipe.
    pipe_virtual: int = 1
    # rematerialize each pipeline chunk in the backward: activations
    # stored by the forward shrink to chunk INPUTS only (~8x less than
    # storing every per-layer intermediate), for ~1/3 more FLOPs
    pipe_remat: bool = False
    # Megatron-style sequence parallelism: shard the [bs, T, H] BERT
    # activations' time axis over the `model` axis between layers (GSPMD
    # inserts the gather/scatter collectives); only meaningful with
    # mesh_model > 1, and mutually exclusive with mesh_pipe > 1
    seq_shard: bool = False
    compute_dtype: str = "float32"  # float32 | bfloat16 (matmul inputs)
    # int8 quantized BERT dense GEMMs (ops/quant.py): none | int8_fwd
    # (forward only) | int8 (+ int8 weight grads) | int8_all (+ int8
    # activation grads). Every int8 product is the hand-written CUDA GEMM
    # of ops/int8_matmul.py on the card (its plain version on the CPU);
    # what the modes cost there is measured in PERF.md.
    quant: str = "none"
    # the fused CubeMLP axis-MLP kernel (ops/cubemlp_kernel.py) for all
    # three axes; the flag keeps the JAX package's name
    use_pallas: bool = False
    # fused Pallas attention: 'on' | 'off' | 'auto' (= on for TPU
    # training, off on CPU/under --seq_shard; +3.2% at T=100, +31.5%
    # at T=150 — see models/bert.py::BertConfig.flash_attn and
    # docs/PERFORMANCE.md)
    flash_attn: str = "auto"
    # vmap-batch the 11 MI/CMI estimators (identical math + param names,
    # ~130 tiny GEMMs -> ~12 batched; see models/model.py
    # _all_estimates_fused). On by default; --unfused_estimators to
    # debug/compare against the sequential execution order.
    fused_estimators: bool = True
    # run the A and V recurrent towers as one fused scan per layer
    # (models/encoders.py::run_bidir_pair); --unfused_av_scan reverts to
    # the two sequential chains
    fused_av_scan: bool = True
    # single-pass fused Adam update (train/optim.py::_fused_adam_chain):
    # one elementwise kernel per leaf instead of one full-tree pass per
    # optax transform; state layout identical to the optax chain.
    # Opt-in until measured on hardware.
    fused_optim: bool = False
    data_dir: Optional[str] = None  # overrides dataset root paths
    bert_vocab: Optional[str] = None  # path to a WordPiece vocab.txt
    # pretrained BERT weights: a torch file in HuggingFace's layout
    # (pytorch_model.bin) or an .npz of flattened flax keys
    # (models/bert.py::load_bert_weights)
    bert_weights: Optional[str] = None
    bert_layers: int = 12  # BERT depth (12 = bert-base)
    # BERT-internal dropout (hidden + attention probs). 0.1 = the HF/
    # reference default baked into torch BertModel; tests set 0 for
    # deterministic-forward equivalence checks.
    bert_dropout: float = 0.1
    bert_heads: int = 12
    bert_hidden: int = 768
    bert_intermediate: Optional[int] = None  # FFN width (None = 4*hidden)
    resume: Optional[str] = None  # run dir whose latest slot the run continues
    task_dir: str = "./TaskRuning"  # run dir root [sic spelling, ref: Solver.py:108]
    jit_backend: Optional[str] = None  # force a jax platform (tests use 'cpu')
    bank_dtype: str = "float32"
    # Adam first-moment / SGD momentum accumulator dtype. bfloat16 cuts
    # the optimizer's HBM traffic (the update step is bandwidth-bound:
    # it streams params + grads + moments); second moments stay float32
    # (they need the precision near convergence). Default bfloat16 since
    # round 5: +2.6% on the bench window, convergence-verified across
    # 3 seeds at MOSI scale — every seed inside the exact schedule's
    # seed envelope, mean delta +0.5 sigma of exact's own seed spread
    # (docs/SEED_STUDY.json mosi/cached_mom). --moment_dtype float32
    # restores bit-level optax parity with the reference chain.
    moment_dtype: str = "bfloat16"
    profile_dir: Optional[str] = None  # jax.profiler trace output dir
    # perf mode: compute stage-1 features once per batch and reuse them
    # across the stage1_n critic passes (the model is frozen in stage 1,
    # so features only differ by dropout resampling; default off = exact
    # reference behavior of a fresh forward per pass)
    fast_stage1: bool = False
    # multi-host: call jax.distributed.initialize() before building the
    # mesh (one process per host on a TPU pod slice)
    distributed: bool = False
    # 'latest' checkpoint cadence in epochs (0 = only at the end). Each
    # save pulls the full state (params + both optimizer moments) to the
    # host, which is expensive on tunneled/remote devices.
    save_latest_every: int = 5
    # run each training/eval stage as ONE scanned XLA program per epoch
    # (host stacks the epoch's batches and dispatches once). Dispatch
    # fusion ONLY: stage-1 semantics stay reference-exact (fresh forward
    # per critic pass) unless --fast_stage1 / --stage1_cached opt into
    # feature reuse. (Through round 2, epoch_scan implied fast_stage1
    # semantics; the flags are orthogonal since round 3.)
    epoch_scan: bool = False
    # deepest stage-1 perf mode (requires --epoch_scan): train critics on
    # the epoch-stale feature bank written by the previous epoch's stage-2
    # forwards — stage 1 then runs NO model forward at all. One step past
    # fast_stage1 on the reuse ladder (one dropout draw, one epoch stale);
    # the kNN contrast samples already come from the same stale bank.
    stage1_cached: bool = False
    # pipelined epoch loop (default on, --no_pipeline_epochs to disable):
    # under --epoch_scan, epoch e+1's device programs are dispatched
    # BEFORE epoch e's host work (metric battery, TB/log writes, best-
    # model bookkeeping, checkpoint pulls) so the host trails the device
    # instead of stalling it between epochs. Bit-identical trajectories —
    # same dispatch order, same RNG stream, same LR application points;
    # only host sync ordering changes. Auto-disabled when the LR schedule
    # needs the epoch's valid loss (plateau) or when profiling.
    pipeline_epochs: bool = True
    # --epoch_group G (with --epoch_scan): G whole epochs (stage 1, stage
    # 2, valid and test eval, the best models kept on the device) enqueued
    # at once, with no wait for the device between them
    # (train/solver.py). The same steps, generator draws and rates as the
    # per-epoch scan path, bit for bit (tests/test_torch_solver.py). Runs
    # with --check_gradient or --profile_dir fall back to per-epoch
    # dispatch with a warning. The selection is decided on the device
    # (float32 masked MAE / accuracy / CCC) and replayed by the host, so a
    # near-tie below 1e-7 can in principle resolve otherwise than the
    # host's comparison: same rule, same inputs.
    epoch_group: int = 1
    # fusion encoder family (README.md:13: the fusion encoder is
    # replaceable): cubemlp (reference) | transformer | tfn
    fusion: str = "cubemlp"
    fusion_layers: int = 2
    fusion_heads: int = 4
    # 'moe' fusion: expert count and router top-k (experts shard over the
    # `model` mesh axis = expert parallelism)
    moe_experts: int = 4
    moe_topk: int = 2
    # PRNG bit-generator: 'rbg' uses the hardware RngBitGenerator for
    # dropout masks (+24% train throughput at canonical MOSI shapes on
    # v5e — threefry mask generation is that expensive); 'threefry' is
    # jax's default, stable across backends/versions
    rng_impl: str = "rbg"
    # checkpoint storage: both write this package's .pt slots; 'orbax'
    # writes them on a background thread (mimrl_tpu: async orbax saves)
    ckpt_backend: str = "msgpack"
    # failure containment: skip the optimizer update (params and opt
    # state unchanged) whenever any gradient is NaN/Inf, instead of
    # poisoning the weights (SURVEY.md §5.3: the reference has none)
    skip_nonfinite_updates: bool = False
    # user loss extension point, 'module.path:factory' (the functional
    # counterpart of the reference's get_customized_loss placeholder,
    # ref: Customization.py:40-41): factory(cfg) returns a jittable
    # fn(out, labels, feats) -> scalar added to the stage-2 objective
    custom_loss: Optional[str] = None

    # --- the port's one addition ---
    # where the entry points run: None = CUDA (they raise without a card),
    # 'cpu' = the plain PyTorch path on the CPU, as the tests ask for
    device: Optional[str] = None

    # Derived/validation -----------------------------------------------------
    def __post_init__(self):
        def check(value, name, allowed):
            if value not in allowed:
                raise ValueError(
                    f"invalid --{name} {value!r}; choose from {allowed}")

        def require(ok, message):
            if not ok:
                raise ValueError(message)

        check(self.encoders, "encoders", ("lstm", "gru", "conv"))
        check(self.features_compose_t, "features_compose_t",
              ("mean", "cat", "sum"))
        check(self.features_compose_k, "features_compose_k",
              ("mean", "cat", "sum"))
        check(self.task, "task", ("classification", "regression"))
        check(self.critic_type, "critic_type", ("separate", "concat"))
        check(self.baseline_type, "baseline_type",
              ("constant", "unnormalized", "gaussain"))
        check(self.bound_type, "bound_type",
              ("dv", "mine", "tuba", "nwj", "infonce", "js", "js_fgan",
               "smile", "interpolate", "club"))
        check(self.cmi_last_acticate, "cmi_last_acticate",
              ("hardtanh", "sigmoid"))
        check(self.rng_impl, "rng_impl", ("rbg", "threefry"))
        check(self.flash_attn, "flash_attn", ("auto", "on", "off"))
        check(self.quant, "quant", ("none", "int8_fwd", "int8", "int8_all"))
        check(self.bank_dtype, "bank_dtype", ("float32", "bfloat16"))
        check(self.moment_dtype, "moment_dtype", ("float32", "bfloat16"))
        check(self.ckpt_backend, "ckpt_backend", ("msgpack", "orbax"))
        require(not (self.seq_shard and self.mesh_pipe > 1),
                "--seq_shard and --mesh_pipe are mutually exclusive: the "
                "pipelined BERT path bypasses the in-module layer stack where "
                "the sequence-sharding constraints live, so sequence "
                "parallelism would be a silent no-op")
        require(self.moe_topk <= self.moe_experts,
                f"--moe_topk {self.moe_topk} cannot exceed --moe_experts "
                f"{self.moe_experts}")
        check(self.fusion, "fusion", ("cubemlp", "transformer", "tfn", "moe"))
        require(not (self.stage1_cached and not self.epoch_scan),
                "--stage1_cached requires --epoch_scan: the bank-slice critic "
                "sweep is an epoch-level scanned program (per-batch loaders "
                "may reshuffle, so batch order cannot address bank rows)")
        require(len(self.d_hiddens) == len(self.d_outs) == len(self.res_project),
                "d_hiddens, d_outs and res_project must have the same depth")
        require(len(self.loss_mi_coefficient1) == 11,
                "--loss_mi_coefficient1 needs exactly 11 values "
                f"(got {len(self.loss_mi_coefficient1)})")
        require(len(self.loss_mi_coefficient2) == 8,
                "--loss_mi_coefficient2 needs exactly 8 values "
                f"(got {len(self.loss_mi_coefficient2)})")

    # IO ---------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "MimrlConfig":
        return cls(**json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "MimrlConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kw) -> "MimrlConfig":
        return dataclasses.replace(self, **kw)


def build_arg_parser() -> argparse.ArgumentParser:
    """argparse surface identical to the reference (ref: Parameters.py:4-74),
    plus the TPU-native extension flags."""
    p = argparse.ArgumentParser()
    d = MimrlConfig()

    # Names, paths, logs
    p.add_argument("--task_name", default=d.task_name)

    # Data parameters
    p.add_argument("--dataset", default=d.dataset, type=str)
    p.add_argument("--normalize", default="0-0-0", type=str2bools)
    p.add_argument("--log_scale", default="0-0-0", type=str2bools)
    p.add_argument("--text", default=d.text, type=str)
    p.add_argument("--audio", default=d.audio, type=str)
    p.add_argument("--video", default=d.video, type=str)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--persistent_workers", action="store_true")
    p.add_argument("--pin_memory", action="store_true")
    p.add_argument("--drop_last", action="store_true")
    p.add_argument("--task", default=d.task, type=str,
                   choices=["classification", "regression"])
    p.add_argument("--num_class", default=d.num_class, type=int)

    # Model parameters
    p.add_argument("--d_common", default=d.d_common, type=int)
    p.add_argument("--encoders", default=d.encoders, type=str)
    p.add_argument("--features_compose_t", default=d.features_compose_t, type=str)
    p.add_argument("--features_compose_k", default=d.features_compose_k, type=str)
    p.add_argument("--activate", default=d.activate, type=str)
    p.add_argument("--time_len", default=d.time_len, type=int)
    p.add_argument("--d_hiddens", default="10-2-128=5-2-128", type=str2listoffints)
    p.add_argument("--d_outs", default="10-2-128=5-2-128", type=str2listoffints)
    p.add_argument("--dropout_mlp", default="0.5-0.5-0.5", type=str2floats)
    p.add_argument("--dropout", default="0.5-0.5-0.5-0.5", type=str2floats)
    p.add_argument("--bias", action="store_true")
    p.add_argument("--ln_first", action="store_true")
    p.add_argument("--res_project", default="1-1", type=str2bools)

    # VMI estimation
    p.add_argument("--critic_type", default=d.critic_type, type=str)
    p.add_argument("--baseline_type", default=d.baseline_type, type=str)
    p.add_argument("--bound_type", default=d.bound_type, type=str)
    p.add_argument("--loss_mi_coefficient1",
                   default="-".join(["0.1"] * 11), type=str2floats)
    p.add_argument("--loss_mi_coefficient2",
                   default="-".join(["0.1"] * 8), type=str2floats)
    p.add_argument("--mi_lr_rate", default=d.mi_lr_rate, type=float)
    p.add_argument("--cmi_lr_rate", default=d.cmi_lr_rate, type=float)
    p.add_argument("--k_neighbor", default=d.k_neighbor, type=int)
    p.add_argument("--radius", default=d.radius, type=float)
    p.add_argument("--cmi_last_acticate", default=d.cmi_last_acticate, type=str,
                   choices=["hardtanh", "sigmoid"])
    p.add_argument("--stage1_n", default=d.stage1_n, type=int)

    # Training and optimization
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--loss", default=d.loss,
                   choices=["Focal", "CE", "BCE", "RMSE", "MSE", "SIMSE", "MAE", "CCC"])
    p.add_argument("--gradient_clip", default=d.gradient_clip, type=float)
    p.add_argument("--epochs_num", default=d.epochs_num, type=int)
    p.add_argument("--optm", default=d.optm, type=str,
                   choices=["SGD", "SAM", "Adam"])
    p.add_argument("--learning_rate", default=d.learning_rate, type=float)
    p.add_argument("--bert_freeze", default=d.bert_freeze, type=str,
                   choices=["part", "no", "all"])
    p.add_argument("--bert_lr_rate", default=d.bert_lr_rate, type=float)
    p.add_argument("--weight_decay", default=d.weight_decay, type=float)
    p.add_argument("--lr_decrease", default=d.lr_decrease, type=str,
                   choices=["multi_step", "step", "exp", "plateau"])
    p.add_argument("--lr_decrease_iter", default=d.lr_decrease_iter, type=str)
    p.add_argument("--lr_decrease_rate", default=d.lr_decrease_rate, type=float)
    p.add_argument("--save_best_features", action="store_true")
    p.add_argument("--no_save_models", dest="save_models",
                   action="store_false", default=True)
    p.add_argument("--print_params", action="store_true")
    p.add_argument("--check_gradient", action="store_true")
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--cuda", default=d.cuda, type=str)

    # TPU-native extensions
    p.add_argument("--mesh_data", default=d.mesh_data, type=int)
    p.add_argument("--mesh_model", default=d.mesh_model, type=int)
    p.add_argument("--mesh_dcn", default=d.mesh_dcn, type=int)
    p.add_argument("--mesh_pipe", default=d.mesh_pipe, type=int)
    p.add_argument("--pipe_microbatches", default=d.pipe_microbatches,
                   type=int)
    p.add_argument("--pipe_virtual", default=d.pipe_virtual, type=int)
    p.add_argument("--pipe_remat", action="store_true")
    p.add_argument("--seq_shard", action="store_true")
    p.add_argument("--compute_dtype", default=d.compute_dtype, type=str)
    p.add_argument("--quant", default=d.quant, type=str,
                   choices=["none", "int8_fwd", "int8", "int8_all"])
    p.add_argument("--use_pallas", action="store_true")
    p.add_argument("--flash_attn", default=d.flash_attn, type=str,
                   choices=["auto", "on", "off"])
    p.add_argument("--unfused_estimators", dest="fused_estimators",
                   action="store_false")
    p.add_argument("--unfused_av_scan", dest="fused_av_scan",
                   action="store_false")
    p.add_argument("--fused_optim", action="store_true")
    p.add_argument("--data_dir", default=None, type=str)
    p.add_argument("--bert_vocab", default=None, type=str)
    p.add_argument("--bert_weights", default=None, type=str)
    p.add_argument("--bert_layers", default=d.bert_layers, type=int)
    p.add_argument("--bert_dropout", default=d.bert_dropout, type=float)
    p.add_argument("--bert_heads", default=d.bert_heads, type=int)
    p.add_argument("--bert_hidden", default=d.bert_hidden, type=int)
    p.add_argument("--bert_intermediate", default=d.bert_intermediate,
                   type=int)
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--task_dir", default=d.task_dir, type=str)
    p.add_argument("--jit_backend", default=None, type=str)
    p.add_argument("--bank_dtype", default=d.bank_dtype, type=str)
    p.add_argument("--moment_dtype", default=d.moment_dtype, type=str)
    p.add_argument("--profile_dir", default=None, type=str)
    p.add_argument("--fast_stage1", action="store_true")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--save_latest_every", default=d.save_latest_every,
                   type=int)
    p.add_argument("--epoch_scan", action="store_true")
    p.add_argument("--stage1_cached", action="store_true")
    p.add_argument("--epoch_group", default=d.epoch_group, type=int)
    p.add_argument("--no_pipeline_epochs", dest="pipeline_epochs",
                   action="store_false")
    p.add_argument("--fusion", default=d.fusion, type=str,
                   choices=["cubemlp", "transformer", "tfn", "moe"])
    p.add_argument("--fusion_layers", default=d.fusion_layers, type=int)
    p.add_argument("--fusion_heads", default=d.fusion_heads, type=int)
    p.add_argument("--moe_experts", default=d.moe_experts, type=int)
    p.add_argument("--moe_topk", default=d.moe_topk, type=int)
    p.add_argument("--rng_impl", default=d.rng_impl, type=str,
                   choices=["rbg", "threefry"])
    p.add_argument("--ckpt_backend", default=d.ckpt_backend, type=str,
                   choices=["msgpack", "orbax"])
    p.add_argument("--skip_nonfinite_updates", action="store_true")
    p.add_argument("--custom_loss", type=str, default=None,
                   help="user loss hook 'module.path:factory'; "
                        "factory(cfg) -> fn(out, labels, feats)")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda[:n]' (default; raises without a card) or 'cpu'")
    return p


def parse_args(argv=None) -> MimrlConfig:
    ns = build_arg_parser().parse_args(argv)
    return MimrlConfig.from_dict(vars(ns))
