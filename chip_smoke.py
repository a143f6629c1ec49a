#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``mimrl_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --mesh [data|seq_shard|moe|pipe ...]
                                 # the build and those mesh cases alone
                                 # (default pipe); NCCL on 2+ cards, and
                                 # on 4+ the pipelined CLI (mesh_main)

Phases, each of which raises (non-zero exit, no result line) on failure:

1. build   ``nvcc`` builds every kernel of the port from ``ops/csrc``
           (five sources, seven libraries), one process per source and
           variant, all started together.
2. kernel  each kernel against its plain PyTorch version on the card, at
           the canonical shape, at T 150, at ragged small shapes, at the
           tensor-core backward's T limits (bf16 and float32) and one past
           each, and at hd 128, with random key padding and a fully padded
           row, in bf16 and float32 (the tensor-core instances, bf16 mma
           and 3xTF32; the backward past its limit on SIMT): the attention
           forward without and with dropout (same Philox mask on both
           sides, keep rate, same seed same bits), the attention backward
           without and with dropout (two runs bit-equal); at the timed
           float32 shapes the SIMT instances timed beside them through
           their C entry points;
           the fused CubeMLP axis MLP at the six shapes of the
           canonical encoder with and without bias, each on its axis's
           instance (the D mix on tf32x3_rows, the L mix on tf32x3_cols,
           the K mix on kmix), and at one ragged shape per axis; the int8
           GEMM at the four forward shapes of a BERT layer (bf16 out), the
           four weight-gradient shapes (float32 out,
           two runs bit-equal, also timed in the operand layouts the dw
           product hands over) and two ragged shapes, bit for bit, the
           eight canonical ones on the wgmma instance, whose library must
           hold GMMA instructions (cuobjdump -sass); times with CUDA
           events (median of 25 after 5 warm-up runs, 10-20 queued launches
           per pair of events) and by the profiler's kernel records, beside
           the plain version, the one-call PyTorch equivalent (timed only,
           both ways) and the bound; the bf16 attention also at the pipe
           case's microbatch, ``[32, 12, 100, 64]`` (``pipe_kernel_shapes``).
3. serve   ``Predictor`` on the canonical MOSI config at full width
           (README quick start: bs 128, time_len 100, BERT-base
           12 x 768 x 12 heads, bi-GRU, CubeMLP 50-3-128=10-3-128, bf16)
           with seeded random weights saved as a port checkpoint, over a
           synthetic DeclareLab test split of 5 batches whose last one is
           cycle-padded. The attention kernel must launch 12 times per
           batch. The bf16 and the float32 forward through the kernel must
           match the same forward through the plain attention route. The same
           checkpoint is then served with ``use_pallas`` and ``quant int8``
           set: 12 attention, 6 axis-MLP and 48 int8 GEMM launches per
           batch, every int8 launch on the wgmma instance, every axis-MLP
           launch on its axis's instance.
4. train   ``mimrl_tpu_torch.cli.main`` trains the same config for 2
           epochs (3 train batches of 128, 1 valid, 1 test): epoch 0 is
           stage 2 without MI, epoch 1 is stage 1 (2 critic passes) and
           stage 2 with MI. Launches are counted per epoch (a train step
           12 forward + 12 backward, a critic step or an eval batch 12 + 0);
           losses and MI channels must be finite, the critic loss must fall,
           each stage must move its own parameter group only, one float32
           train step through the kernels must match the plain route in its
           loss, and in every parameter's gradient the same step with the
           backward kernel's plain version in its place, one bf16 train
           step (dropout on) must match the plain route in its loss, and
           ``Predictor`` must score the checkpoint the run wrote; one
           float32 train step as the README's quick start runs it (no
           ``--compute_dtype``) profiled: busy ms, idle share, attention
           rows; two float32 runs of one seed (a fresh Solver and two eager
           train steps each, dropout on) bit for bit equal in every
           parameter, optimizer moment and bank field, with the same two
           runs through ``nn.Embedding``'s token-type lookup stated beside
           them. Every attention launch of every counted path must take the
           tensor-core instance.
5. quant   the same run again with ``--use_pallas --quant int8``: launches
           of all four kernels per epoch (a train step 12 + 12 attention,
           6 axis-MLP, 96 int8 GEMM; a critic step or an eval batch
           12 + 0, 6, 48; every int8 launch on the wgmma instance, every
           axis-MLP launch on its axis's instance),
           finite losses and MI channels, ``Predictor`` on
           its checkpoint with the flags it recorded; one float32 train
           step through the two new kernels against the same step through
           their plain versions (bit-equal where only the int8 kernel is
           exchanged); one bf16 train step each in ``int8_fwd`` (48 int8
           launches) and ``int8_all`` (144).
6. resume  the canonical recipe (flag-free) for 3 epochs with ``latest``
           written every epoch, a learning-rate milestone at epoch 2 and
           ``--bert_weights`` pointing at a seeded BERT-base
           ``pytorch_model.bin`` written here (the Solver must hold its
           tensors bit for bit): run A goes through, A2 repeats it, B gets
           SIGTERM during epoch 1 and stops after it with ``latest`` at
           epoch 1, C resumes B for epoch 2. C's final slot (weights, both
           optimizers, the bank, the schedule) and epoch-2 loss and MI
           values are held against A's within RESUME_GAP_FACTOR times the
           A2-vs-A gap (bit-equal where A2 is), a resume with the loader's
           pass counter left at 0 must fail that gate, and every
           ``train_step`` of the resumed epoch launches 12 + 12 attention
           kernels. B runs with ``--ckpt_backend orbax``: its slots are
           written on a background thread and its ``latest`` is there when
           it stops. Slot bytes, save, read and ``_resume`` ms, the main
           thread's ms per save under each backend and the thread's write
           ms, peak memory of a save. Then a ``mimrl_tpu`` msgpack
           ``latest``: the layout
           of ``tests/fixtures/mimrl_tpu_slot`` filled from a seed, written
           in flax's format and resumed on the card and on the CPU; the
           next epoch's steps (stage 2's train steps, then a critic step;
           the same host-drawn kNN anchors) on the card within
           JAX_SLOT_TOL of the CPU's losses and MI values, and a resume
           that takes optax's nu as mu must miss that tenfold. The same
           tree as a ``mimrl_tpu`` orbax slot (``core/orbax_slot.py``'s
           writer): read back against the msgpack read bit for bit,
           resumed on the card into the same state and epoch as the
           msgpack resume (bit for bit), within JAX_SLOT_TOL of the CPU,
           and served. The committed ``tests/fixtures/mimrl_tpu_orbax``
           (written by JAX's orbax) decoded here by ``native/zstd.cpp``:
           every leaf's sha256 against ``leaves.json``; the reader's ms
           and MB/s on it, on the seeded slot and on a ``[30522, 768]``
           float32 leaf; the decoder's MB/s.
7. rungs   the canonical recipe for 3 epochs (milestone at epoch 2) on each
           ``--epoch_scan`` rung: a fresh forward per critic step,
           ``--fast_stage1`` and ``--stage1_cached``, then the flagged recipe
           with ``--epoch_scan``, so that all four kernels replay inside
           CUDA graphs. Each run with graphs (G) is held against the same
           run eagerly (E), with a second eager run (E2) as the control, by
           the resume phase's gate (weights, both optimizers, the bank, the
           generators, the last epoch's loss and MI values): bit for bit
           where E2 equals E, else within RESUME_GAP_FACTOR times their gap.
           A G run whose replays restart from the generator's state at
           capture (one dropout seed and one set of kNN anchors for every
           replay) must fail that gate. Launches of all four kernels per run
           are exact, counted through replays; a step that cannot be
           captured must raise. Per-step host ms (a synchronise on each
           side), epoch s, device busy ms and idle share of a stage-2 epoch
           and a stage-1 pass (profiler), capture s per graph and peak
           memory, for G and E; and the per-batch path's stage-2 ms per step
           with ``--num_workers`` 0 and 4, two runs each, in turns.
8. families  the dataset families and encoders of the ninth slice, each
           through ``cli.main`` for 2 epochs at its recipe's widths with
           seeded weights, on fixtures from the port's ``data/synthetic.py``
           (every split's size printed), and each run's ``best_valid`` slot
           served by ``Predictor``: ``recipes/mosi_local.sh`` (``mosi_50``,
           dense text, no BERT parameter) without and with
           ``--use_pallas``, every axis-MLP launch of one forward held
           against its plain version; ``recipes/avec2019.sh`` (selection by
           CCC; every attention launch of one train step checked; the
           stacked epochs of ``--epoch_scan`` hold the per-batch loader's
           random words of the same pass, other words each pass; one
           float32 ``--use_pallas --quant int8`` train step bit-equal with
           the int8 kernel's plain version, its launches at M 3200 each
           checked); ``recipes/pom_sdk.sh`` (the POM battery); the canonical
           recipe for 1 epoch with ``--encoders lstm`` and ``conv``, each
           encoder on the card against the same weights on the CPU; and
           ``mosi_local.sh`` with the LSTM and ``avec2019.sh`` (float32,
           as its recipe runs: G, E and E2 bit for bit equal) on
           ``--epoch_scan``, graphs against eager by the rungs gate.
           Launches per run exact; host ms per step, a train step by CUDA
           events, samples/s of the epoch and of serving, peak memory. The
           kernels at its new shapes are held against their plain versions
           and timed beside their bounds right after the kernel phase
           (float32 attention at bs 32 and 64, the axis MLP at T 50, int8
           at M 3200, bit for bit). The loaders must pad through
           ``native/`` (its calls counted), and at MOSI's 1284/229/686
           split the host library (padding and a vocab.txt WordPiece) is
           held against the numpy forms bit for bit, with the host ms of
           each.

9. fusions the canonical recipe in float32 (README quick start) with
           ``--fusion transformer``, ``tfn`` (``--bound_type club``) and
           ``moe`` at the default widths (2 layers, 4 heads,
           4 experts, top 2; fusion dropout 0.1), each through ``cli.main``
           for 2 epochs and served by ``Predictor`` from its ``best_valid``
           slot: launches exact (all attention on the tensor-core
           instance), finite scores; the card's eval forward of the whole
           model within FUSION_CPU_TOL of the CPU's on the same weights and
           rows; one train step's fusion-parameter gradients within
           FUSION_GRAD_TOL of the CPU's from the same fusion input and
           output gradient; device busy ms of a train step and of the
           fusion's forward and backward alone (the fusion's share). Then
           the transformer with ``--bound_type nwj``, stated: where its
           critic losses leave float32's range.
10. hooks  the canonical recipe for 2 epochs with ``--custom_loss``
           (``feature_decorrelation``), ``--check_gradient`` and
           ``--profile_dir``: 9 check-gradient blocks of finite sums over
           every non-BERT parameter, a chrome-trace file of epoch 1 with
           CUDA kernel events, and each built-in hook's value added to an
           eval loss within HOOK_TOL (``l2_output``'s, above the loss's
           last place, within a tenth of itself); then the hook on ``--epoch_scan`` for 3
           epochs, captured in the CUDA graphs (launches exact through the
           replays, finite values), with the epoch of the first captures
           profiled.
11. group  ``--epoch_group 2`` against the per-epoch ``--epoch_scan`` path
           of the same seed at full width: the canonical bf16 recipe for 7
           epochs on the rungs' split with ``--save_best_features``, the
           flagged one (all four kernels) for 5 epochs, ``avec2019.sh`` in
           float32 (CCC) under the plateau schedule (stepped on the
           device) for 5 epochs, whose rate must decay, and
           ``mosi_local.sh`` (no BERT) for 13 epochs at MOSI's
           1284/229/686 split. Each grouped run must equal its
           per-epoch run bit for bit (the final state, both best slots,
           every scalar, every better-epoch decision, the best epochs'
           features, the loaders' passes), launch per group exactly twice
           the per-epoch run's launches of an epoch with stage 1, and
           synchronise the host inside no dispatch after its first group
           (torch's sync debug mode); a grouped canonical run with the
           selection rule reversed must fail that gate. The canonical and
           ``mosi_local`` pairs give the readings: epoch seconds dispatch
           to dispatch (epochs 3-4; ``mosi_local`` 3-10), host
           synchronisations and one-copy waits, the device's busy ms and
           idle share over the last two epochs (profiler, from
           a drained queue), peak memory. Then ``tools/parity.py
           --synthetic --full_scale --allow_hermetic --epochs_num 5
           --light_artifacts`` at MOSI's 1284/229/686 split, with
           ``--epoch_group 2`` and per epoch: finite scores, 8 MI channels
           of 5 values per split, samples/s, each group's launches twice an
           epoch's; ``--compare`` of the grouped report with itself passes
           and with a perturbed copy exits 1.
12. mi_bank the estimator bank batched (``--fused_estimators``, the
           default) against sequential at the canonical widths (bs 128,
           d_common 128, hidden 256, embed 128, k_neighbor 2), InfoNCE with
           a separate critic and TUBA with an unnormalized baseline: both
           stages' values within rtol 2e-5 / atol 1e-6 and every stage-1
           gradient within rtol 5e-5 / atol 1e-6 (JAX's limits), and with
           two estimators' stacked first-layer weights swapped the gate
           must fail; the bank's device busy ms and kernel launches per
           call, batched against sequential (profiler). The canonical bf16
           recipe's eager ``train_step`` and ``critic_step`` (CUDA events;
           12 + 12 and 12 attention launches, counted) and its replayed
           rung steps (busy ms, idle share), with the default flags
           against ``--unfused_estimators --unfused_av_scan``, in turns.
           The audio/video pair (``--fused_av_scan``): the two bi-GRUs on
           two streams equal the two calls in turn bit for bit, outputs and
           gradients, and each tower fed the other's lengths must differ;
           the encoders' forward and backward ms with and without streams,
           eagerly and replayed from a CUDA graph.
13. standalone ``mi/standalone.py``'s sweep on the card at rho 0.7 and
           ``tests/test_bounds.py``'s recovery settings: each of its seven
           (bound, critic, baseline) cases within (0.35, 2.5) x the true
           MI, ``js_fgan`` in (-1, 0.05], CLUB (``mean``) above 0.6 x the
           truth, an independent y (CLUB, 30 epochs, as
           ``tests/test_fusion_club.py``) below 0.4 and 0.35 x the truth,
           InfoNCE on the independent y stated; wall s each.
14. mesh   ``parallel/mesh.py::Dropout`` on a split batch against
           ``F.dropout`` of the whole batch (each rank's rows, output and
           input gradient, bit-equal); then the mesh at full width in
           three cases, as
           ``recipes/multichip.sh`` runs them: ``--mesh_data 2`` (under
           ``--flash_attn auto``, i.e. plain attention as in JAX, under
           ``on``, and under ``on --use_pallas --quant int8``),
           ``--mesh_data 1 --mesh_model 2 --seq_shard`` (sequence parallel
           BERT), and ``--fusion moe --mesh_model 2``. Each, at 2 BERT
           layers: one SGD critic_step +
           train_step on the
           mesh against the unsharded step from the same weights, bank,
           batch and seeds (``parallel/check.py``), forward values and
           each parameter's gradient within MESH_GAP_FACTOR times the
           order-only control (the unsharded step with its forward in two
           row blocks; the updates stated beside them; for the seq_shard
           case, float32 then bf16, the larger of that and its arithmetic on
           one rank, the second products' input axis in two blocks summed
           in float32, ``check.ksplit_step``; ``_PartialSums``, its bf16
           partial sums, against float32 F.linear),
           every kernel launch of the mesh step held against its plain
           version, launches per rank exact; on the data case three fault
           controls (a rank skips one parameter's gradient average; the
           average's division left out; a rank draws its dropout rows from
           row 0) and on the seq_shard case one (the reduce-scatter without
           its sum) must miss that gate tenfold. Then a 2-epoch
           ``--epoch_scan`` run per case at 1 BERT layer (the data case
           with all four kernels): finite scores
           equal on both ranks, per rank the epoch s, one eager train
           step's ms and the profiler's collective rows, the launches and
           peak memory; the seq_shard case also one eager train_step at 12
           layers without and with ``--seq_shard`` per rank: ms and peak
           memory, the peak lower with it. The pipe case (``--mesh_data 1 --mesh_pipe 2
           --pipe_microbatches 4 --flash_attn on``: GPipe, ``--pipe_virtual
           2 --pipe_remat``, GPipe with ``--use_pallas --quant int8``):
           the same gate at 4 BERT layers against the sequential stack on
           the pipeline's 32-row microbatches (``check.microbatch_step``),
           exact launches per rank (layers x microbatches, twice the
           forward's under remat), two fault controls (BERT's gradients
           not summed over pipe; the output's cotangent summed over pipe);
           then one eager train_step per schedule at 12 layers: ms, busy
           ms, the hops' and gradient sums' rows, ticks computed and idle,
           launches, peak memory. Busy ms per rank: the union of the device
           records and the rank's own records by correlation (labelled
           ``_shared`` on a shared card). Two cards or more: one rank per card
           over NCCL. One card: both ranks share it over gloo (eager: gloo
           cannot be captured; correctness only, no measure of scaling),
           and a one-rank NCCL group runs the flagged recipe 2 epochs (1
           BERT layer) with
           its step graphs capturing the NCCL gradient average. On four
           cards (``--mesh``) the seq_shard memory reading at
           ``--mesh_model 4`` over NCCL, and the four-card pipelined CLI
           run beside one card's run of the same recipe as it is, with
           its rows reordered, with BERT on microbatches and with both: the
           MAE spread of the order alone against the four-card gap.
15. decompose ``tools/decompose.py`` on the card at the canonical bf16
           shape, bf16 with ``BENCH_QUANT=int8 --use_pallas`` (all four
           kernels) and float32 at bs 64, T 150 (the manifest's shape):
           every piece eager and the four replayable steps replayed, busy
           ms, launches of all four kernels. The float32 attention kernels
           at its third shape, ``[64, 12, 150, 64]``, are held against
           their plain versions and timed beside the bound and SDPA right
           after the kernel phase (late in a run the profiler has returned
           sessions without kernel records).

Output: one JSON object per line; then the ``kernels`` line, the card's
name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits with
status 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time

# the canonical recipe's shapes and flags (3 train batches; 1 valid and 1
# test batch) and the timers, shared with tools/step_time.py and
# tools/decompose.py
from mimrl_tpu_torch.tools.step_time import (BATCH, CANONICAL_MOSI,
                                             CANONICAL_TRAIN, N_TRAIN,
                                             TIME_LEN, cuda_ms,
                                             device_busy_ms)

N_HEADS, HEAD_DIM = 12, 64
SERVE_SHAPE = (BATCH, N_HEADS, TIME_LEN, HEAD_DIM)
# timed as well: the AVEC2019 operating point of the JAX package (T 150)
AVEC_SHAPE = (BATCH, N_HEADS, 150, HEAD_DIM)
N_TEST = 4 * BATCH + 57  # 5 batches; the last one is cycle-padded
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# tensor cores (bf16, int8, TF32); FP32 pipes
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
            "tfloat32": 495e12}
# kernel vs plain: float32 differs by summation order and the online
# softmax; bf16 additionally by where P is rounded (unnormalised in the
# kernel, normalised in the plain version), one bf16 step is 2^-8
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the backward kernel vs its plain version, dq, dk, dv, relative to the
# largest magnitude of the plain result (gradients are not O(1)): float32
# by summation order and the online statistics; bf16 by the roundings of
# Pd, dS and the outputs to bf16 on both sides
BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
DROPOUT_P = 0.1
KEEP_RATE_TOL = 0.005  # measured keep rate within 0.5% of 1 - p
# float32 predictions, kernel route vs plain route, after 12 BERT layers
SERVE_F32_TOL = 1e-3
# one float32 train step, kernel route vs plain route: relative loss gap
TRAIN_F32_LOSS_TOL = 1e-4
# the bf16 main path, tensor-core kernels vs the plain attention route (same
# weights, batch and Philox masks). Both round P, Pd, dS and every layer's
# output to bf16 (2^-8 relative), in other places (the kernel rounds the
# unnormalised P of its online softmax, the plain version the normalised
# one), and twelve randomly initialised layers, the bi-GRUs and CubeMLP
# carry such differences forward: the served split's predictions (largest
# 0.23) differed by 0.069-0.079 between the two routes, as much as bf16
# differs from float32 on the plain route, and one train step's loss by
# 2.5e-3-2.8e-3 of itself. These two limits catch gross faults only; the
# fine gates are the two below.
SERVE_BF16_TOL = 0.1
TRAIN_BF16_LOSS_TOL = 5e-3
# every attention launch of the bf16 main path (the served split, one train
# step with dropout) against its plain version on the same inputs, the
# largest error relative to the plain result's largest magnitude (over dq,
# dk and dv for the backward): the two sides round P, Pd and dS to bf16 in
# other places and then round the output, so they may differ by one bf16
# step of the largest value, 2^-8 to 2^-7 of it. Read at most 7.8e-3 over
# the 84 launches on an H100 80GB HBM3 at 700 W (the inputs are seeded, so
# the reading repeats); limit 1.5 x 2^-7.
LAUNCH_BF16_TOL = 1.2e-2
# one bf16 train step's gradients through the backward kernel against the
# same step with the backward's plain version behind the same forward
# (grad_gap): read 1.14e-2 on the same card. The controls, the same step
# with every backward launch's dq, dk and dv scaled by 1 + fault, read
# 4.4e-2 at a fault of 2^-8 (one bf16 step), 0.11 at 2^-6 and 0.52 at
# 2^-4; the gate sits between the sound reading and the smallest control,
# which it must catch.
TRAIN_BF16_GRAD_TOL = 2e-2
CONTROL_FAULTS = (2.0 ** -4, 2.0 ** -6, 2.0 ** -8)
# the same step's gradients, as train_step hands them to its optimizer,
# through the backward kernel and through its plain version behind the same
# forward: each parameter's largest difference relative to its largest
# gradient, or to GRAD_FLOOR times the largest gradient of all where its
# own is below that (a gradient that is zero in exact arithmetic, an
# attention key bias, is rounding noise either way). One launch differs
# from its plain version by BWD_TOL's float32 figure; twelve layers of
# them add up through the chain rule.
TRAIN_F32_GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
QUANT_FLAGS = ["--use_pallas", "--quant", "int8"]
# the axis-MLP kernel vs its plain version (einsums), relative to the
# largest magnitude of the plain result: both float32; they differ by
# summation order, FMA contraction and the last bits of erf
AXIS_MLP_TOL = 2e-5
# the int8 kernel vs its plain version: int32 sums are exact and both sides
# compute (float(acc) * sa) * sb in float32 and round once, so 0 in
# float32 and in bf16
INT8_TOL = 0.0
# one float32 train step with the flags, kernels vs plain versions. With the
# int8 kernel alone exchanged the step must not change at all (but for the
# embedding tables, whose gradient is summed by atomics in an order that
# changes from run to run: EMBEDDING_GRAD_TOL of their largest gradient).
# With the axis-MLP kernel alone exchanged the forward changes in its last
# bits (AXIS_MLP_TOL per launch); the loss is held to TRAIN_F32_LOSS_TOL.
# The gradients are held twice. Under --use_pallas alone, where nothing
# but float32 arithmetic lies between the kernel and a gradient, to
# AXIS_MLP_GRAD_TOL of the parameter's largest gradient (floor as above):
# that is the kernel's own tolerance, times the amplification at random
# initialisation that TRAIN_F32_GRAD_TOL's note describes. Under
# --use_pallas --quant int8 to QUANT_GRAD_TOL: there the gradient that
# flows back into BERT is quantised to int8 for every weight gradient, a
# last-bit change moves single values across a rounding boundary, and one
# int8 step is 1/127 of a column's largest value.
AXIS_MLP_GRAD_TOL = 1e-3
QUANT_GRAD_TOL = 5e-2
EMBEDDING_GRAD_TOL = 1e-5
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd",
                "cubemlp_axis_mlp", "int8_matmul")
# the resume phase: 3 epochs, latest every epoch, the milestone at epoch 2,
# so the restored schedule state acts inside the run. The resumed run C is
# held against the uninterrupted run A tensor by tensor (the model's, each
# parameter's optimizer moments, the bank, the generators), with the
# epoch-2 loss and MI values, the schedule and the loader's passes. The
# repeat A2 shows what this card reproduces: C must be bit-equal wherever
# A2 is. On an H100 80GB HBM3 at 700 W A2 differed from A in one parameter
# only, BERT's token-type embedding table (its value and its moments;
# every other tensor, the bank and the epoch-2 values bit-equal), because
# torch's CUDA embedding backward sums that table's gradient over 12800
# positions of one index in an order that changes from run to run (two
# identical train steps: 9.3e-7 to 1.2e-6 of its largest value apart;
# torch's deterministic-algorithm check flags no operation of the step),
# and the bf16 cast of the embeddings hides the difference from the rest
# of the forward. There C may differ from A by RESUME_GAP_FACTOR times the
# largest A2-vs-A difference, counted in last places of each element's
# dtype: A2 read 35 and 40, C 49 and 43 in two repetitions, the resume
# that leaves the loader's pass counter at 0 1.4e7 (and 1218 other
# tensors differ).
RESUME_ARGS = ["--epochs_num", "3", "--save_latest_every", "1",
               "--lr_decrease_iter", "2-60"]
RESUME_GAP_FACTOR = 10.0
# the rungs phase: 3 epochs, the milestone at epoch 2 (so a replayed step
# reads a learning rate that changed after its capture); the three stage-1
# modes of --epoch_scan on the flag-free recipe, then the flagged recipe
RUNG_ARGS = ["--epochs_num", "3", "--lr_decrease_iter", "2-60",
             "--no_save_models", "--save_latest_every", "0"]
RUNGS = (("scan", ["--epoch_scan"]), ("fast", ["--epoch_scan", "--fast_stage1"]),
         ("cached", ["--epoch_scan", "--stage1_cached"]))
# substrings of the CUDA kernels' names in ops/csrc, for the profiler
PORT_KERNEL_SYMBOLS = ("flash_fwd", "flash_bwd", "axis_mlp", "int8_matmul")
# [bs, L, K, D], axis, d_hidden, d_out of the six AxisMLPs of the canonical
# encoder (50-3-128=10-3-128 on [128, 100, 3, 128])
AXIS_MLP_SHAPES = [
    ((BATCH, 100, 3, 128), 1, 50, 50), ((BATCH, 50, 3, 128), 2, 3, 3),
    ((BATCH, 50, 3, 128), 3, 128, 128), ((BATCH, 50, 3, 128), 1, 10, 10),
    ((BATCH, 10, 3, 128), 2, 3, 3), ((BATCH, 10, 3, 128), 3, 128, 128)]
AXIS_MLP_RAGGED = [((3, 37, 3, 50), 1, 33, 41), ((3, 7, 5, 70), 2, 9, 2),
                   ((3, 7, 5, 70), 3, 45, 130)]
AXIS_MLP_MAIN = AXIS_MLP_SHAPES[2]  # the D mix of block 0 heads the record
# the instance ops/cubemlp_kernel.py::plan must pick for each canonical axis
AXIS_MLP_INSTANCE = {1: "tf32x3_cols", 2: "kmix", 3: "tf32x3_rows"}
# (K, N) of a BERT-base layer's four dense products; M = bs * time_len
ROWS = BATCH * TIME_LEN
INT8_LAYER_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
INT8_MAIN = (ROWS, 768, 3072)
# K % 16 != 0 (mma_sync); ragged M and N with a K tail under stream-K (wgmma)
INT8_RAGGED = [(333, 1000, 77), (200, 12800 + 48, 136)]

PIPE_MICRO = 4  # --pipe_microbatches: 32-row microbatches of bs 128
# the mesh phase (parallel/mesh.py): four cases as recipes/multichip.sh
# runs them at full width, each (case flags, (variant, flags) ...); every
# variant's one-step gate runs SGD (the update is linear in the gradient, so
# a fault in it shows; under Adam a gradient scaled by 2 moves little)
MESH_CASES = {
    "data": (["--mesh_data", "2"],
             (("auto", []), ("flash", ["--flash_attn", "on"]),
              ("flagged", ["--flash_attn", "on", "--use_pallas", "--quant",
                           "int8"]))),
    # float32 first (its fault control holds there), then bf16, where any
    # reordering of a product's sums (check.ksplit_step) moves a step by a
    # few bf16 last places (2-3% forward) and the row split moves none
    "seq_shard": (["--mesh_data", "1", "--mesh_model", "2", "--seq_shard"],
                  (("float32", ["--compute_dtype", "float32"]),
                   ("bf16", []))),
    "moe": (["--mesh_data", "1", "--mesh_model", "2", "--fusion", "moe"],
            (("plain", []),)),
    # the pipeline (parallel/pipeline.py) over two stages, as
    # recipes/multichip.sh runs it with --mesh_data 1
    "pipe": (["--mesh_data", "1", "--mesh_pipe", "2", "--pipe_microbatches",
              str(PIPE_MICRO), "--flash_attn", "on"],
             (("gpipe", []), ("interleaved", ["--pipe_virtual", "2",
                                              "--pipe_remat"]),
              ("flagged", ["--use_pallas", "--quant", "int8"]))),
}
# the gates run at 2 BERT layers (full width): the host's float64 copies
# and the gloo sums of every gradient scale with the parameter count
MESH_GATE_LAYERS = 2
MESH_GATE_ARGS = ["--optm", "SGD", "--bert_layers", str(MESH_GATE_LAYERS)]
# the pipe case's gates at 4 BERT layers, the least depth that the
# interleaved schedule takes at 2 stages and 2 virtual chunks; its
# order-only control is the sequential stack on the pipeline's 32-row
# microbatches (check.microbatch_step)
PIPE_GATE_LAYERS = 4
MESH_VOCAB = 30522
# the gate: a mesh step may differ from the unsharded step (forward values
# and each parameter's update, relative: check.relative_gaps) by at most
# MESH_GAP_FACTOR times what the order-only control moves, the unsharded
# step with its forward in two row blocks whose gradients are summed in
# the other order (check.split_batch_step), and no less than that factor
# times MESH_GAP_FLOOR. A bf16 step over 64 rows need not match one over
# 128 bit for bit: cuBLAS picks other kernels, and the gradient sum runs in
# another order.
MESH_GAP_FACTOR = 4.0
MESH_GAP_FLOOR = 1e-4
# the gated readings: the forward values and each parameter's gradient as
# the optimizer takes it; the update is stated beside them (the same
# optimizer arithmetic on the gated gradient, resolved no finer than a
# parameter's float32 last place: one last place of a LayerNorm weight is
# 2% of its first SGD update)
MESH_GATED = ("forward", "gradient")
# each must miss the gate by at least tenfold: rank 1 keeps its own
# gradient of the first main parameter; the average's division left out
# (the gradient summed over the ranks); rank 1 draws its dropout rows of
# the whole batch from row 0
MESH_FAULTS = {"skip_reduce": {"skip_reduce": 0},
               "no_scaling": {"sum_gradients": True},
               "dropout_rows": {"dropout_from_zero": True}}
# the pipe case's: BERT's gradients not summed over pipe; the last stage's
# cotangent of the shared output summed over pipe (2x BERT's gradient)
PIPE_FAULTS = {"no_pipe_sum": {"no_pipe_sum": True},
               "output_sum": {"output_sum": True}}
# the seq_shard case's: the row-parallel products' reduce-scatter without
# its sum (each rank keeps its slice of its own partial sums)
SEQ_FAULTS = {"scatter_no_sum": {"scatter_no_sum": True}}
# --seq_shard's row-parallel partial sums (bf16 inputs, float32 sums)
# against the float32 product of the same values, relative to the largest
# magnitude: the sums differ only in their order; the gradients are the
# unsharded product's bf16 backward (2^-9 of rounding, plus the order)
PARTIAL_SUMS_TOL = 1e-4
PARTIAL_SUMS_GRAD_TOL = 2.0 ** -8
CASE_FAULTS = {"data": MESH_FAULTS, "pipe": PIPE_FAULTS,
               "seq_shard": SEQ_FAULTS}
# the readings: 2 epochs on --epoch_scan (train_phase's split), per rank,
# at 1 BERT layer (full width): gloo moves every collective through host
# memory (12.6 s an eager step of the model axis at full depth with two
# ranks, measured on one H100); the data case with all four kernels
MESH_READ_ARGS = ["--epoch_scan", "--epochs_num", "2", "--no_save_models",
                  "--save_latest_every", "0", "--bert_layers", "1"]
MESH_READ_FLAGS = {"data": ["--flash_attn", "on", "--use_pallas", "--quant",
                            "int8"]}
# the cases run in one group of two processes (each case builds its own
# mesh over it): each group costs a start and a CUDA context per rank
MESH_GROUPS = (("data", "seq_shard", "moe", "pipe"),)
# the pipe case's readings: one eager train_step at 12 BERT layers per
# rank, GPipe, then the interleaved schedule with remat on the same model
PIPE_READ_SCHEDULES = (("gpipe", 1, False), ("interleaved", 2, True))

def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def kernel_wrappers():
    """The four wrappers that count their launches, in KERNEL_NAMES' order."""
    from mimrl_tpu_torch.ops.cubemlp_kernel import fused_axis_mlp
    from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from mimrl_tpu_torch.ops.int8_matmul import int8_matmul

    return flash_attention, flash_attention_bwd, fused_axis_mlp, int8_matmul


def counts():
    return tuple(w.launches for w in kernel_wrappers())


def zero_counts() -> None:
    for w in kernel_wrappers():
        w.launches = 0
        for key in w.instance_launches:
            w.instance_launches[key] = 0


def attention_instances(step: str, launches) -> dict:
    """The attention launches of a counted run by instance (set to 0 with
    the counts): at the main paths' shapes (T 100, hd 64, bf16 or float32)
    every forward and every backward must have taken the tensor-core
    instance, none the SIMT one."""
    fwd, bwd = kernel_wrappers()[:2]
    instances = dict(fwd=dict(fwd.instance_launches),
                     bwd=dict(bwd.instance_launches))
    require(instances == dict(
        fwd={"tensor_core": launches[0], "simt": 0},
        bwd={"tensor_core": launches[1], "simt": 0}),
        f"{step}: attention launches by instance {instances}, want all "
        f"{launches[:2]} on tensor_core")
    return instances


def attention_instance_counts():
    """(forward, backward) launches on the tensor-core instance and on the
    SIMT one so far: ((tc, simt), (tc, simt))."""
    return tuple((w.instance_launches["tensor_core"],
                  w.instance_launches["simt"])
                 for w in kernel_wrappers()[:2])


def int8_instances(step: str, launches) -> dict:
    """The int8 launches of a counted run by instance (set to 0 with the
    counts); every one must have taken the wgmma instance."""
    instances = dict(kernel_wrappers()[3].instance_launches)
    require(instances == {"wgmma": launches[3], "mma_sync": 0},
            f"{step}: int8 launches by instance {instances}, want all "
            f"{launches[3]} on wgmma")
    return instances


def axis_mlp_instances(step: str, launches) -> dict:
    """The axis-MLP launches of a counted run by instance (set to 0 with
    the counts): a forward's six AxisMLPs are two per axis, each on its
    axis's instance of AXIS_MLP_INSTANCE."""
    instances = dict(kernel_wrappers()[2].instance_launches)
    n = launches[2] // 3
    require(launches[2] % 3 == 0
            and instances == {v: n for v in AXIS_MLP_INSTANCE.values()},
            f"{step}: axis-MLP launches by instance {instances}, want "
            f"{n} on each of {sorted(AXIS_MLP_INSTANCE.values())}")
    return instances


def sub(c1, c0):
    return tuple(a - b for a, b in zip(c1, c0))


def step_launches(kind: str, use_pallas: bool, quant: str, n: int = 1,
                  layers: int = 12):
    """Launches of the four kernels in ``n`` steps of one kind ('train',
    'critic' or 'eval') at a BERT depth of ``layers`` (the canonical 12):
    one attention forward per layer, in a train step one attention
    backward per layer; 6 axis MLPs (forward only: their backward is
    einsums); 4 int8 products per layer and forward, and in a train step
    as many again for dw ('int8') or twice as many for dw and dx
    ('int8_all')."""
    train = kind == "train"
    int8 = 0 if quant == "none" else 4 * layers * (1 + (
        {"int8_fwd": 0, "int8": 1, "int8_all": 2}[quant] if train else 0))
    return (layers * n, layers * n if train else 0,
            6 * n if use_pallas else 0, int8 * n)


def add(*cs):
    return tuple(sum(xs) for xs in zip(*cs))


def profiler_ms(fn, kernel_name=None, reps: int = 10):
    """Median device time in ms of the kernel whose name contains
    ``kernel_name`` over ``reps`` calls of fn(), from ``torch.profiler``'s
    kernel records: the kernel alone, whatever the host takes to launch it.
    With a tuple of names: the device time of the kernels whose names
    contain one of them, summed over the calls and divided by ``reps``
    (one call may launch several). Without ``kernel_name``: the same over
    all of one call's kernels. None where the profiler gives no device
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
    times = [e.device_time if hasattr(e, "device_time") else e.cuda_time
             for e in prof.events()
             if names is None or any(k in e.name for k in names)]
    times = [t for t in times if t > 0]
    if not times:
        return None
    return 1e-3 * (statistics.median(times) if isinstance(kernel_name, str)
                   else sum(times) / reps)


def profiler_names(fn) -> list:
    """The names (and device times, us) of the profiler's records of one
    call of fn(): what a kernel search that found nothing had to look at."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({(e.name[:80], e.device_time) for e in prof.events()})[:20]


def attention_inputs(bs, nh, t, hd, dtype, seed):
    """q, k, v on the card from a seeded CPU generator; random key
    padding and one batch row whose keys are all padded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bs, nh, t, hd, generator=g) for _ in range(3))
    mask = (torch.rand(bs, t, generator=g) > 0.25).float()
    mask[:, 0] = 1.0
    mask[bs - 1] = 0.0
    bias = (1.0 - mask[:, None, None, :]) * -1e9
    return [x.cuda().to(dtype) for x in (q, k, v)] + [bias.cuda()]


def simt_attention(q, k, v, bias, seed=None, dropout_p=0.0, d_out=None):
    """The float32 SIMT instance through its C entry point, the "before"
    reading beside the tensor-core instance: the forward (no shape routes
    there any longer) or, with ``d_out``, the backward (the wrapper takes it
    only past the tensor-core T limit). Counts no launch."""
    import torch

    from mimrl_tpu_torch.ops import flash_attention as fa

    bs, nh, t, hd = q.shape
    seed_ptr, drop, threshold, inv_keep, batch0 = fa._dropout_args(
        seed, dropout_p)
    tail = (bs, nh, t, hd, fa._DTYPE_CODES[q.dtype], 1.0 / hd ** 0.5, drop,
            threshold, inv_keep, batch0,
            torch.cuda.current_stream().cuda_stream)
    if d_out is None:
        out = torch.empty_like(q)
        rc = fa._entry(fa.SOURCE, "mimrl_flash_attention_fwd", 6, q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), seed_ptr, *tail)
        require(rc == 0, f"SIMT forward: CUDA error {rc}")
        return out
    require(q.dtype == torch.float32, "the SIMT backward's dq_acc is dq")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = fa._entry(fa.SOURCE_BWD, "mimrl_flash_attention_bwd", 10, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        d_out.data_ptr(), seed_ptr, dq.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *tail)
    require(rc == 0, f"SIMT backward: CUDA error {rc}")
    return dq, dk, dv


def attention_bound(q, bias, backward: bool = False):
    """(ms, 'bytes' | 'operations', ms with float32's operations on the
    FP32 pipes only (None for bf16)). Forward: q, k, v, bias read once and
    out written once at the HBM rate, against 4 * bs * nh * T^2 * hd
    operations (two products); backward: q, k, v, dO, bias read and dq,
    dk, dv written once, against 10 * bs * nh * T^2 * hd operations (five
    products). bf16 operations at the tensor cores' bf16 rate; float32 ones
    at the faster of the FP32 pipes and 3xTF32 (three TF32 products each)
    on the tensor cores, as axis_mlp_bound reads them."""
    bs, nh, t, hd = q.shape
    tensors, products = (7, 5) if backward else (4, 2)
    nbytes = (tensors * q.numel() * q.element_size()
              + bias.numel() * bias.element_size())
    ops = 2 * products * bs * nh * t * t * hd
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[dtype]
    fp32_pipes = None
    if dtype == "float32":
        fp32_pipes = 1e3 * max(t_bytes, t_ops)
        t_ops = min(t_ops, 3 * ops / PEAK_OPS["tfloat32"])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", fp32_pipes)


def rel_err(got, want) -> float:
    """Largest error relative to the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@contextlib.contextmanager
def patched(patches):
    """``patches`` ((owner, attribute, replacement), ...) in place inside."""
    saved = [(owner, attr, vars(owner)[attr]) for owner, attr, _ in patches]
    for owner, attr, replacement in patches:
        setattr(owner, attr, replacement)
    try:
        yield
    finally:
        for owner, attr, original in saved:
            setattr(owner, attr, original)


def checked_launches(errors):
    """Patches under which every attention kernel launch also runs its
    plain version on the same inputs and appends its ``rel_err`` (over dq,
    dk and dv for the backward: the largest) to ``errors['fwd']`` or
    ``errors['bwd']``. The kernels' outputs go on unchanged; the plain
    versions count no launch."""
    from mimrl_tpu_torch.ops import flash_attention as fa

    forward = fa._forward
    backward = vars(fa._FlashAttention)["backward"].__func__

    def checked_forward(q, k, v, bias, seed, dropout_p, row0=0):
        out = forward(q, k, v, bias, seed, dropout_p, row0)
        errors["fwd"].append(rel_err(out, fa.flash_attention_plain(
            q, k, v, bias, seed, dropout_p, row0)))
        return out

    def checked_backward(ctx, d_out):
        grads = backward(ctx, d_out)
        q, k, v, bias, seed = ctx.saved_tensors
        want = fa.flash_attention_bwd_plain(q, k, v, bias, seed,
                                            d_out.to(q.dtype), ctx.dropout_p,
                                            ctx.row0)
        errors["bwd"].append(max(rel_err(g, w) for g, w in zip(grads, want)))
        return grads

    return ((fa, "_forward", checked_forward),
            (fa._FlashAttention, "backward", staticmethod(checked_backward)))


def faulty_backward(fault: float):
    """A control's patch: the backward kernel's dq, dk and dv, each scaled
    by 1 + ``fault``."""
    from mimrl_tpu_torch.ops import flash_attention as fa

    backward = vars(fa._FlashAttention)["backward"].__func__

    def scaled_backward(ctx, d_out):
        grads = backward(ctx, d_out)
        return tuple(g * (1.0 + fault) for g in grads[:3]) + grads[3:]

    return ((fa._FlashAttention, "backward", staticmethod(scaled_backward)),)


def kernel_phase():
    """Both attention kernels against their plain versions; returns the
    canonical-shape records (forward, backward) for the kernels line: the
    bf16 ones, each with the float32 one under 'float32'."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops import flash_attention as fa
    from mimrl_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    main = {}
    limits = [fa.max_t_tensor_core_bwd(HEAD_DIM, d)
              for d in (torch.bfloat16, torch.float32)]
    # timed: the canonical and the AVEC shapes; then ragged ones, the
    # tensor-core backward's T limits (bf16 and float32) and one past each
    # (SIMT there), hd 128 (past float32's limit)
    shapes = [SERVE_SHAPE, AVEC_SHAPE, (3, 2, 37, 16), (2, 2, 512, HEAD_DIM),
              *[(2, 2, t, HEAD_DIM) for limit in limits
                for t in (limit, limit + 1)],
              (4, N_HEADS, TIME_LEN, 128)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            timed = shape in (SERVE_SHAPE, AVEC_SHAPE)
            q, k, v, bias = attention_inputs(*shape, dtype, seed=sum(shape))
            seed = torch.tensor([sum(shape)], device=q.device)
            bs, nh, t, hd = shape
            fwd_instance = fa._instance(dtype, t, hd, backward=False)
            bwd_instance = fa._instance(dtype, t, hd, backward=True)

            # ---- forward, without and with dropout ----
            got = flash_attention(q, k, v, bias)
            want = flash_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"non-finite output {shape} {name}")
            err = (got.float() - want.float()).abs().max().item()
            require(err <= KERNEL_TOL[name],
                    f"flash_attention_fwd {shape} {name}: max abs error "
                    f"{err} > {KERNEL_TOL[name]}")
            got_d = flash_attention(q, k, v, bias, seed, DROPOUT_P)
            again = flash_attention(q, k, v, bias, seed, DROPOUT_P)
            other = flash_attention(q, k, v, bias, seed + 1, DROPOUT_P)
            want_d = flash_attention_plain(q, k, v, bias, seed, DROPOUT_P)
            torch.cuda.synchronize()
            err_d = (got_d.float() - want_d.float()).abs().max().item()
            require(err_d <= KERNEL_TOL[name],
                    f"flash_attention_fwd dropout {shape} {name}: max abs "
                    f"error {err_d} > {KERNEL_TOL[name]}")
            require(torch.equal(got_d, again), f"same seed, other bits {shape} {name}")
            require(not torch.equal(got_d, other), f"other seed, same bits {shape} {name}")
            rec = dict(phase="kernel", kernel="flash_attention_fwd",
                       shape=list(shape), dtype=name, instance=fwd_instance,
                       max_abs_err=err, max_abs_err_dropout=err_d,
                       tol=KERNEL_TOL[name])
            if timed:
                # keep rate read off the kernel: with v = 1 in one column
                # and no padding, that column of the output is
                # sum_k keep * P / (1 - p), whose mean is 1
                rec["keep_rate"] = keep_rate(shape, dtype, seed)
                require(abs(rec["keep_rate"] - (1.0 - DROPOUT_P)) <= KEEP_RATE_TOL,
                        f"keep rate {rec['keep_rate']} at {shape} {name}")
                mask = bias.to(dtype)
                rec.update(timings(
                    lambda: flash_attention(q, k, v, bias),
                    lambda: flash_attention(q, k, v, bias, seed, DROPOUT_P),
                    lambda: flash_attention_plain(q, k, v, bias),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                    kernel_symbol("fwd", fwd_instance, name),
                    *simt_timed(q, k, v, bias, seed)))
                (rec["bound_ms"], rec["bound_by"],
                 rec["bound_ms_fp32_pipes"]) = attention_bound(q, bias)
                if shape == SERVE_SHAPE:
                    main[("fwd", name)] = rec
            emit(**rec)

            # ---- backward, without and with dropout ----
            g = torch.Generator(device=q.device).manual_seed(sum(shape))
            d_out = torch.randn(q.shape, device=q.device, generator=g).to(dtype)
            rec = dict(phase="kernel", kernel="flash_attention_bwd",
                       shape=list(shape), dtype=name, instance=bwd_instance,
                       tol=BWD_TOL[name])
            for p_drop, key in ((0.0, "max_rel_err"), (DROPOUT_P, "max_rel_err_dropout")):
                got3 = flash_attention_bwd(q, k, v, bias, seed, d_out, p_drop)
                again3 = flash_attention_bwd(q, k, v, bias, seed, d_out, p_drop)
                want3 = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, p_drop)
                torch.cuda.synchronize()
                errs = {}
                for gname, gg, aa, ww in zip(("dq", "dk", "dv"), got3, again3, want3):
                    require(bool(torch.isfinite(gg).all()),
                            f"non-finite {gname} {shape} {name} p={p_drop}")
                    require(torch.equal(gg, aa),
                            f"flash_attention_bwd {gname} {shape} {name} "
                            f"p={p_drop}: two runs differ")
                    errs[gname] = rel_err(gg, ww)
                    require(errs[gname] <= BWD_TOL[name],
                            f"flash_attention_bwd {gname} {shape} {name} "
                            f"p={p_drop}: relative error {errs[gname]} > "
                            f"{BWD_TOL[name]}")
                rec[key] = errs
                if p_drop == 0.0:
                    rec["max_abs_err"] = max(
                        (gg.float() - ww.float()).abs().max().item()
                        for gg, ww in zip(got3, want3))
            rec["bit_equal_twice"] = True
            if timed:
                qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
                out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias.to(dtype))
                rec.update(timings(
                    lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, 0.0),
                    lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, DROPOUT_P),
                    lambda: flash_attention_bwd_plain(q, k, v, bias, seed, d_out, 0.0),
                    # the backward alone: the forward's graph is built once
                    lambda: torch.autograd.grad(out, (qq, kk, vv), d_out,
                                                retain_graph=True),
                    kernel_symbol("bwd", bwd_instance, name),
                    *simt_timed(q, k, v, bias, seed, d_out)))
                del out, qq, kk, vv
                (rec["bound_ms"], rec["bound_by"],
                 rec["bound_ms_fp32_pipes"]) = attention_bound(
                    q, bias, backward=True)
                if shape == SERVE_SHAPE:
                    main[("bwd", name)] = rec
            emit(**rec)
    for kind in ("fwd", "bwd"):
        main[(kind, "bfloat16")]["float32"] = {
            k: v for k, v in main[(kind, "float32")].items()
            if k not in ("phase", "kernel", "shape", "dtype")}
    return main[("fwd", "bfloat16")], main[("bwd", "bfloat16")]


def kernel_symbol(kind: str, instance: str, dtype: str) -> str:
    """The CUDA kernel's name of an attention instance, for the profiler's
    records: ``kind`` 'fwd' or 'bwd', ``dtype`` 'bfloat16' or 'float32'."""
    if instance == "simt":
        return f"flash_{kind}_kernel"
    return f"flash_{kind}_{'tc' if dtype == 'bfloat16' else 'tf32x3'}_kernel"


def simt_timed(q, k, v, bias, seed, d_out=None):
    """For a float32 record, (simt, simt with dropout, its kernel name):
    the SIMT instance through its entry point, timed beside the tensor-core
    one in the same call; () for bf16."""
    import torch

    if q.dtype != torch.float32:
        return ()
    kind = "fwd" if d_out is None else "bwd"
    return (lambda: simt_attention(q, k, v, bias, d_out=d_out),
            lambda: simt_attention(q, k, v, bias, seed, DROPOUT_P, d_out),
            kernel_symbol(kind, "simt", "float32"))


def timings(kernel, kernel_dropout, plain, library, kernel_name, simt=None,
            simt_dropout=None, simt_name=None) -> dict:
    """The times of one attention record, ms on the device: the kernel with
    20 queued launches per pair of CUDA events ('ms', 'ms_dropout') and by
    the profiler's kernel records ('profiler_ms', 'profiler_ms_dropout', up
    to three profiler runs each, 'profiler_tries' says how many);
    one launch per pair ('ms_one_launch', which reads the wrapper's host
    time where that is longer); the plain version; the one-call PyTorch
    yardstick by the profiler ('library_ms', the device time of all of its
    kernels; queued events where the profiler gives no records) and by 20
    queued calls per pair of events ('library_events_ms', which for the
    backward reads autograd's time on the host). With ``simt``: the float32
    SIMT instance the same two ways ('ms_simt', 'profiler_ms_simt', and
    with dropout)."""
    library_events_ms = cuda_ms(library, inner=20)
    library_ms = profiler_ms(library)
    tries = []
    out = dict(
        ms=cuda_ms(kernel, inner=20),
        ms_dropout=cuda_ms(kernel_dropout, inner=20),
        profiler_ms=profiled_ms(kernel, kernel_name, tries),
        profiler_ms_dropout=profiled_ms(kernel_dropout, kernel_name, tries),
        ms_one_launch=cuda_ms(kernel),
        plain_ms=cuda_ms(plain, inner=5),
        library_ms=library_events_ms if library_ms is None else library_ms,
        library_events_ms=library_events_ms)
    if simt is not None:
        out.update(
            ms_simt=cuda_ms(simt, inner=20),
            ms_simt_dropout=cuda_ms(simt_dropout, inner=20),
            profiler_ms_simt=profiled_ms(simt, simt_name, tries),
            profiler_ms_simt_dropout=profiled_ms(simt_dropout, simt_name,
                                                 tries))
    out["profiler_tries"] = tries
    return out


def keep_rate(shape, dtype, seed) -> float:
    """The kernel's measured keep rate at ``shape``: uniform attention
    (q = 0, no padding) over v = 1 gives out = (kept keys / T) / (1 - p)."""
    import torch

    from mimrl_tpu_torch.ops.flash_attention import flash_attention

    bs, nh, t, hd = shape
    q = torch.zeros(shape, device="cuda", dtype=dtype)
    v = torch.ones(shape, device="cuda", dtype=dtype)
    bias = torch.zeros(bs, 1, 1, t, device="cuda")
    out = flash_attention(q, q, v, bias, seed, DROPOUT_P)
    return out.float().mean().item() * (1.0 - DROPOUT_P)


def axis_mlp_inputs(shape, axis, d_hidden, d_out, use_bias, seed):
    """x and the parameters of one AxisMLP on the card from a seeded CPU
    generator; the weights enter as an ``nn.Linear``'s do, as transposed
    views of ``[out, in]`` tensors."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d_in = shape[axis]
    x = torch.randn(shape, generator=g).cuda()
    fc1 = (torch.randn(d_hidden, d_in, generator=g) / d_in ** 0.5).cuda()
    fc2 = (torch.randn(d_out, d_hidden, generator=g) / d_hidden ** 0.5).cuda()
    b1 = torch.randn(d_hidden, generator=g).cuda() if use_bias else None
    b2 = torch.randn(d_out, generator=g).cuda() if use_bias else None
    return x, fc1.t(), fc2.t(), b1, b2


def axis_mlp_bound(x, w1, w2, b1, b2, axis):
    """The least time for float32-level work: x, the weights and the
    biases read once and y written once at the HBM rate, against the
    2 * positions * (d_in * d_hidden + d_hidden * d_out) operations either
    on the FP32 pipes or as 3xTF32 (three TF32 products each) on the tensor
    cores, whichever is faster. Returns (ms, 'bytes' | 'operations', the
    rate that bounds: 'hbm' | 'fp32_pipes' | 'tf32x3', and the bound with
    the operations on the FP32 pipes only, in ms)."""
    d_in, d_hidden = w1.shape
    d_out = w2.shape[1]
    positions = x.numel() // d_in
    floats = (x.numel() + positions * d_out + w1.numel() + w2.numel()
              + (0 if b1 is None else b1.numel() + b2.numel()))
    t_bytes = 4 * floats / PEAK_BYTES_PER_S
    ops = 2 * positions * (d_in * d_hidden + d_hidden * d_out)
    t_fp32 = ops / PEAK_OPS["float32"]
    t_tf32x3 = 3 * ops / PEAK_OPS["tfloat32"]
    t_ops = min(t_fp32, t_tf32x3)
    rate = ("hbm" if t_bytes >= t_ops
            else "fp32_pipes" if t_fp32 <= t_tf32x3 else "tf32x3")
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", rate,
            1e3 * max(t_bytes, t_fp32))


def axis_mlp_phase():
    """The fused axis-MLP kernel against its plain version (float32, the
    only type the encoder's input has): the six canonical shapes with and
    without bias, timed, each on its axis's instance of AXIS_MLP_INSTANCE,
    and one ragged shape per axis. Every launch must count on the instance
    ``plan`` names. Returns the record for the kernels line."""
    import math

    import torch

    from mimrl_tpu_torch.ops import cubemlp_kernel as ck
    from mimrl_tpu_torch.ops.cubemlp_kernel import (fused_axis_mlp,
                                                    fused_axis_mlp_plain)

    main, per_shape, worst = None, [], 0.0
    cases = [(c, True) for c in AXIS_MLP_SHAPES] + [(c, False) for c in AXIS_MLP_RAGGED]
    for (shape, axis, d_hidden, d_out), timed in cases:
        p = ck.plan(math.prod(shape[:axis]), shape[axis], d_hidden, d_out,
                    math.prod(shape[axis + 1:]),
                    ck._sm_count(torch.device("cuda", 0)))
        require(not timed or p.instance == AXIS_MLP_INSTANCE[axis],
                f"cubemlp_axis_mlp {shape} axis {axis}: planned "
                f"{p.instance}, want {AXIS_MLP_INSTANCE[axis]}")
        rec = dict(phase="kernel", kernel="cubemlp_axis_mlp", shape=list(shape),
                   axis=axis, d_hidden=d_hidden, d_out=d_out, dtype="float32",
                   activation="gelu", tol=AXIS_MLP_TOL, instance=p.instance,
                   vec=p.vec, grid=list(p.grid), block=list(p.block),
                   tiles=p.tiles, smem=p.smem)
        for use_bias in (True, False):
            args = axis_mlp_inputs(shape, axis, d_hidden, d_out, use_bias,
                                   seed=sum(shape) + axis)
            before = fused_axis_mlp.instance_launches[p.instance]
            got = fused_axis_mlp(*args, axis, "gelu")
            want = fused_axis_mlp_plain(*args, axis, "gelu")
            torch.cuda.synchronize()
            require(fused_axis_mlp.instance_launches[p.instance] == before + 1,
                    f"cubemlp_axis_mlp {shape} axis {axis}: did not launch "
                    f"{p.instance}")
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"cubemlp_axis_mlp {shape} axis {axis}: shape or non-finite")
            err = rel_err(got, want)
            require(err <= AXIS_MLP_TOL,
                    f"cubemlp_axis_mlp {shape} axis {axis} bias {use_bias}: "
                    f"relative error {err} > {AXIS_MLP_TOL}")
            key = "bias" if use_bias else "no_bias"
            rec[f"max_rel_err_{key}"] = err
            rec[f"max_abs_err_{key}"] = (got - want).abs().max().item()
            if timed:
                rec[f"ms_{key}"] = cuda_ms(
                    lambda: fused_axis_mlp(*args, axis, "gelu"), inner=20)
            if timed and use_bias:
                rec["ms_one_launch"] = cuda_ms(
                    lambda: fused_axis_mlp(*args, axis, "gelu"))
                rec["profiler_ms"] = profiler_ms(
                    lambda: fused_axis_mlp(*args, axis, "gelu"), "axis_mlp_")
                rec["plain_ms"] = cuda_ms(
                    lambda: fused_axis_mlp_plain(*args, axis, "gelu"), inner=20)
                (rec["bound_ms"], rec["bound_by"], rec["bound_rate"],
                 rec["bound_ms_fp32_pipes"]) = axis_mlp_bound(*args, axis)
        if timed:
            # canonical: the model's AxisMLPs have biases
            rec.update(ms=rec["ms_bias"], max_abs_err=rec["max_abs_err_bias"],
                       library_ms=None)  # no single PyTorch call computes it
            worst = max(worst, rec["max_abs_err_bias"], rec["max_abs_err_no_bias"])
            per_shape.append({k: rec[k] for k in (
                "shape", "axis", "d_hidden", "d_out", "instance", "grid",
                "ms", "ms_no_bias", "ms_one_launch", "profiler_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_rate", "bound_ms_fp32_pipes",
                "max_abs_err", "max_rel_err_bias")})
            if (shape, axis, d_hidden, d_out) == AXIS_MLP_MAIN:
                main = dict(rec)
        emit(**rec)
    main.update(max_abs_err=worst, shapes=per_shape,
                ms_six_shapes=sum(r["ms"] for r in per_shape),
                profiler_ms_six_shapes=(
                    sum(r["profiler_ms"] for r in per_shape)
                    if all(r["profiler_ms"] for r in per_shape) else None),
                plain_ms_six_shapes=sum(r["plain_ms"] for r in per_shape),
                bound_ms_six_shapes=sum(r["bound_ms"] for r in per_shape),
                bound_ms_fp32_pipes_six_shapes=sum(
                    r["bound_ms_fp32_pipes"] for r in per_shape))
    return main


def int8_inputs(m, k, n, seed):
    """Random int8 operands in the layouts the forward hands the kernel (a
    row-major, b the transposed view of a row-major [N, K]) and positive
    float32 scales, on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).cuda()
    bt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).cuda()
    sa = (torch.rand(m, 1, generator=g) * 0.02 + 0.001).cuda()
    sb = (torch.rand(1, n, generator=g) * 0.02 + 0.001).cuda()
    return a, bt.t(), sa, sb


def int8_bound(m, k, n, out_dtype):
    """(ms, 'bytes' | 'operations'): a, b, both scale vectors read once and
    out written once at the HBM rate, against 2 * M * N * K int8 operations
    at the tensor cores' int8 rate."""
    nbytes = m * k + k * n + 4 * (m + n) + m * n * out_dtype.itemsize
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2 * m * n * k / PEAK_OPS["int8"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_gmma_count() -> dict:
    """``GMMA`` instructions in the SASS of each int8 library
    (``cuobjdump -sass``): the wgmma instance must have some."""
    import os

    from mimrl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    found = {}
    for source in ("int8_matmul_wgmma.cu", "int8_matmul.cu"):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(source, "int8"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        found[source] = sum("GMMA" in line for line in sass.splitlines())
    require(found["int8_matmul_wgmma.cu"] > 0,
            f"no GMMA instruction in the wgmma library: {found}")
    return found


def layer_sum(values):
    """The sum of a layer's readings, or None where one is missing."""
    return None if None in values else sum(values)


def int8_phase():
    """The int8 GEMM kernels against their plain version, bit for bit: the
    four forward shapes of a BERT-base layer at M = 12800 with bf16 output,
    the four weight-gradient shapes (M = K_fwd, K = 12800, N = N_fwd) with
    float32 output, run twice and bit-equal, and two ragged shapes (K % 16
    != 0: the mma_sync instance; ragged M and N with a K tail under
    stream-K: wgmma) with both outputs. The eight canonical shapes must take
    the wgmma instance. Each record names its instance, plan, and the
    kernel symbols the profiler sums (the wgmma instance's reduce kernel
    runs after the main one where stream-K split tiles). ``ms_path_layout``
    times the dw shapes with the operand layouts ``ops/quant.py`` hands the
    wrapper (``q(x.T)`` column-major, ``q(g)`` row-major), so that the two
    int8 copies into the kernels' layout are included. The library column
    is ``torch._int_mm`` plus the epilogue in tensor ops, timed only.
    Returns the record for the kernels line."""
    import torch

    from mimrl_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain, plan,
                                                 schedule)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gmma = int8_gmma_count()
    cases = [("forward", (ROWS, k, n), torch.bfloat16) for k, n in INT8_LAYER_SHAPES]
    cases += [("dw", (k, ROWS, n), torch.float32) for k, n in INT8_LAYER_SHAPES]
    cases += [("ragged", shape, dtype) for shape in INT8_RAGGED
              for dtype in (torch.float32, torch.bfloat16)]
    main, per_shape, worst = None, [], 0.0
    for role, (m, k, n), out_dtype in cases:
        name = str(out_dtype).replace("torch.", "")
        a, b, sa, sb = int8_inputs(m, k, n, seed=m + k + n)
        p = plan(m, n, k, sms)
        before = dict(int8_matmul.instance_launches)
        got = int8_matmul(a, b, sa, sb, out_dtype)
        want = int8_matmul_plain(a, b, sa, sb, out_dtype)
        torch.cuda.synchronize()
        require(int8_matmul.instance_launches[p.instance]
                == before[p.instance] + 1,
                f"int8_matmul {role} {(m, k, n)}: did not launch {p.instance}")
        require(role == "ragged" or p.instance == "wgmma",
                f"int8_matmul {role} {(m, k, n)}: took {p.instance}, not wgmma")
        require(got.shape == (m, n) and got.dtype == out_dtype
                and bool(torch.isfinite(got).all()),
                f"int8_matmul {role} {(m, k, n)} {name}: shape, type or non-finite")
        err = (got.float() - want.float()).abs().max().item()
        require(torch.equal(got, want) and err <= INT8_TOL,
                f"int8_matmul {role} {(m, k, n)} {name}: differs from the "
                f"plain version by {err}")
        symbols = (("int8_matmul_wgmma_kernel", "int8_matmul_wgmma_reduce")
                   if p.instance == "wgmma" else ("int8_matmul_kernel",))
        pieces = 1
        if p.instance == "wgmma":
            pieces = max((f[2] for f in schedule(p)[1]), default=1)
        rec = dict(phase="kernel", kernel="int8_matmul", role=role,
                   shape=[m, k, n], out_dtype=name, max_abs_err=err,
                   bit_equal=True, tol=INT8_TOL, instance=p.instance,
                   grid=p.grid, stream_k=p.stream_k, splits=pieces,
                   profiler_symbols=list(symbols))
        if role == "dw":
            again = int8_matmul(a, b, sa, sb, out_dtype)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"int8_matmul dw {(m, k, n)}: two runs differ")
            rec["two_runs_bit_equal"] = True
        if role != "ragged":
            rec["ms"] = cuda_ms(lambda: int8_matmul(a, b, sa, sb, out_dtype),
                                inner=10)
            rec["ms_one_launch"] = cuda_ms(
                lambda: int8_matmul(a, b, sa, sb, out_dtype))
            # the profiler has dropped all kernel records of a profiled run
            # on this card before: up to three runs, then the symbols must
            # have been found
            for attempt in range(3):
                rec["profiler_ms"] = profiler_ms(
                    lambda: int8_matmul(a, b, sa, sb, out_dtype), symbols)
                if rec["profiler_ms"] is not None:
                    break
            rec["profiler_runs"] = attempt + 1
            require(rec["profiler_ms"] is not None,
                    f"int8_matmul {role} {(m, k, n)}: the profiler found no "
                    f"kernel named {symbols} in three runs; it saw "
                    f"{profiler_names(lambda: int8_matmul(a, b, sa, sb, out_dtype))}")
            rec["profiler_ms_by_kernel"] = {sym: profiler_ms(
                lambda: int8_matmul(a, b, sa, sb, out_dtype), (sym,))
                for sym in symbols}
            if role == "dw":
                # the layouts quant.py hands over: a = q(x.T), b = q(g)
                a_path, b_path = a.t().contiguous().t(), b.contiguous()
                require(torch.equal(int8_matmul(a_path, b_path, sa, sb,
                                                out_dtype), got),
                        f"int8_matmul dw {(m, k, n)}: path layout differs")
                rec["ms_path_layout"] = cuda_ms(lambda: int8_matmul(
                    a_path, b_path, sa, sb, out_dtype), inner=10)
                rec["profiler_ms_path_layout"] = profiler_ms(lambda: int8_matmul(
                    a_path, b_path, sa, sb, out_dtype))
                del a_path, b_path
            rec["plain_ms"] = cuda_ms(
                lambda: int8_matmul_plain(a, b, sa, sb, out_dtype), 2, 5)
            rec["library_ms"] = cuda_ms(lambda: (
                torch._int_mm(a, b).float() * sa * sb).to(out_dtype), inner=10)
            rec["library_profiler_ms"] = profiler_ms(lambda: (
                torch._int_mm(a, b).float() * sa * sb).to(out_dtype))
            rec["int_mm_only_ms"] = cuda_ms(lambda: torch._int_mm(a, b),
                                            inner=10)
            rec["bound_ms"], rec["bound_by"] = int8_bound(m, k, n, out_dtype)
            rec["tops"] = 2 * m * n * k / (1e-3 * rec["ms"]) / 1e12
            rec["tops_profiler"] = 2 * m * n * k / (1e-3 * rec["profiler_ms"]) / 1e12
            worst = max(worst, err)
            per_shape.append({key: rec.get(key) for key in (
                "role", "shape", "out_dtype", "instance", "grid", "stream_k",
                "splits", "ms", "ms_one_launch", "profiler_ms",
                "profiler_runs", "profiler_ms_by_kernel", "ms_path_layout",
                "profiler_ms_path_layout", "plain_ms", "library_ms",
                "library_profiler_ms", "int_mm_only_ms", "bound_ms",
                "bound_by", "tops", "tops_profiler", "max_abs_err")})
            if (m, k, n) == INT8_MAIN and role == "forward":
                main = dict(rec)
        emit(**rec)
    main.update(max_abs_err=worst, shapes=per_shape, dtype="int8 -> bfloat16",
                gmma_sass_count=gmma,
                ms_forward_layer=sum(r["ms"] for r in per_shape if r["role"] == "forward"),
                ms_dw_layer=sum(r["ms"] for r in per_shape if r["role"] == "dw"),
                profiler_ms_forward_layer=sum(
                    r["profiler_ms"] for r in per_shape if r["role"] == "forward"),
                profiler_ms_dw_layer=sum(
                    r["profiler_ms"] for r in per_shape if r["role"] == "dw"),
                **{f"library{kind}_ms_{role}_layer": layer_sum(
                    [r[f"library{kind}_ms"] for r in per_shape
                     if r["role"] == role])
                   for kind in ("", "_profiler") for role in ("forward", "dw")})
    return main


def write_run(root: str):
    """Synthetic Dec data, the canonical config and seeded random weights
    saved as a port run directory; returns the task_dir."""
    import torch

    from mimrl_tpu_torch.core.checkpoint import CheckpointManager
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.data.tokenizer import build_tokenizer
    from mimrl_tpu_torch.models.model import build_model, init_weights

    data, task = f"{root}/data", f"{root}/run"
    make_dec_fixture(data, "mosi", n_per_split=(32, 16, N_TEST), d_audio=5,
                     d_video=20, max_len=TIME_LEN + 1, seed=0)
    cfg = parse_args(CANONICAL_MOSI + ["--data_dir", data])
    vocab = build_tokenizer(cfg.bert_vocab).vocab_size
    model = build_model(cfg, vocab, 5, 20, "cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    ckpt = CheckpointManager(task)
    ckpt.save_config(cfg.to_json())
    ckpt.save("best_valid", model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="serve", step="run_dir", params=n_params, vocab=vocab,
         bert_layers=cfg.bert_layers, hidden=cfg.bert_hidden,
         heads=cfg.bert_heads, time_len=cfg.time_len,
         batch_size=cfg.batch_size, test_samples=N_TEST)
    return task


def timed_serve(task: str, step: str, overrides: dict, per_batch):
    """``Predictor`` over the test split, every batch timed on the host
    clock with a synchronise on each side; the four launch counts are set
    to 0 just before the counted run and read just after, and must be
    ``per_batch`` times the number of batches. Returns (predictor, counts)."""
    import numpy as np
    import torch

    from mimrl_tpu_torch.eval.predict import Predictor

    predictor = Predictor(task, config_overrides=overrides)  # CUDA, bf16
    n_batches = len(predictor.test_loader)
    require(n_batches == 5, f"expected 5 test batches, got {n_batches}")
    predictor.evaluate_split("test")  # warm-up: cuBLAS / cuDNN set-up

    forward = predictor.forward
    batch_ms = []

    def timed_forward(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(batch)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    predictor.forward = timed_forward
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    metrics = predictor.evaluate_split("test")
    wall = time.perf_counter() - t0
    launches = counts()
    instances = int8_instances(step, launches)
    axis_instances = axis_mlp_instances(step, launches)
    attention_instances(step, launches)
    predictor.forward = forward
    want = tuple(n * n_batches for n in per_batch)
    require(launches == want,
            f"{step}: launches {dict(zip(KERNEL_NAMES, launches))}, want {want}")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics {metrics}")
    emit(phase="serve", step=step, metrics=metrics, overrides=overrides,
         batches=n_batches, launches=dict(zip(KERNEL_NAMES, launches)),
         int8_instances=instances, axis_mlp_instances=axis_instances,
         batch_ms_median=statistics.median(batch_ms), batch_ms=batch_ms,
         samples_per_s=N_TEST / wall, evaluate_s=wall,
         forward_samples_per_s=BATCH / (1e-3 * statistics.median(batch_ms)),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return predictor, launches


def serve_phase(task: str):
    """Predictor end to end, without and with the two flags; returns the
    launch counts of the two counted runs."""
    import numpy as np

    from mimrl_tpu_torch.eval.predict import Predictor

    # flash_attn 'auto' -> the attention kernel; no other kernel on this path
    predictor, launches = timed_serve(task, "predictor_bf16", {},
                                      step_launches("eval", False, "none"))
    errors = {"fwd": [], "bwd": []}
    with patched(checked_launches(errors)):
        preds = {"bf16_kernel": predictor.predict_loader(predictor.test_loader)[0]}
    require(len(errors["fwd"]) == 60,
            f"{len(errors['fwd'])} checked serving launches, want 60")
    for name, overrides in (("bf16_plain", {"flash_attn": "off"}),
                            ("f32_kernel", {"compute_dtype": "float32"}),
                            ("f32_plain", {"compute_dtype": "float32",
                                           "flash_attn": "off"})):
        p = Predictor(task, config_overrides=overrides)
        c0, i0 = counts(), attention_instance_counts()
        preds[name] = p.predict_loader(p.test_loader)[0]
        got = tuple(sub(b, a) for a, b in zip(i0, attention_instance_counts()))
        n_fwd = counts()[0] - c0[0]
        require(got == ((n_fwd, 0), (0, 0))
                and n_fwd == (60 if name == "f32_kernel" else 0),
                f"serve {name}: attention launches (tensor_core, simt) {got}")
        del p
    for name, x in preds.items():
        require(x.shape == (N_TEST, 1) and bool(np.isfinite(x).all()),
                f"{name} predictions: shape {x.shape} or non-finite values")
    f32_diff = float(np.abs(preds["f32_kernel"] - preds["f32_plain"]).max())
    bf16_diff = float(np.abs(preds["bf16_kernel"] - preds["bf16_plain"]).max())
    emit(phase="serve", step="route_check", f32_kernel_vs_plain=f32_diff,
         tol=SERVE_F32_TOL, bf16_kernel_vs_plain=bf16_diff,
         bf16_tol=SERVE_BF16_TOL,
         bf16_plain_vs_f32_plain=float(np.abs(
             preds["bf16_plain"] - preds["f32_plain"]).max()),
         bf16_kernel_vs_f32_plain=float(np.abs(
             preds["bf16_kernel"] - preds["f32_plain"]).max()),
         pred_abs_max=float(np.abs(preds["f32_plain"]).max()),
         launches_checked=len(errors["fwd"]),
         launch_rel_err_max=max(errors["fwd"]),
         launch_rel_err_median=statistics.median(errors["fwd"]),
         launch_tol=LAUNCH_BF16_TOL)
    require(f32_diff <= SERVE_F32_TOL,
            f"float32 kernel route vs plain route: {f32_diff} > {SERVE_F32_TOL}")
    require(bf16_diff <= SERVE_BF16_TOL,
            f"bf16 kernel route vs plain route: {bf16_diff} > {SERVE_BF16_TOL}")
    require(max(errors["fwd"]) <= LAUNCH_BF16_TOL,
            f"bf16 serving: an attention launch differs from its plain "
            f"version by {max(errors['fwd'])} > {LAUNCH_BF16_TOL}")
    breakdown(predictor, "breakdown_ms")
    del predictor

    # the same checkpoint with both flags: all of the serving path's kernels
    flags = {"use_pallas": True, "quant": "int8"}
    predictor, quant_launches = timed_serve(
        task, "predictor_bf16_quant", flags, step_launches("eval", True, "int8"))
    quant = predictor.predict_loader(predictor.test_loader)[0]
    require(quant.shape == (N_TEST, 1) and bool(np.isfinite(quant).all()),
            "quantised predictions: shape or non-finite values")
    emit(phase="serve", step="quant_vs_bf16",
         max_abs_diff=float(np.abs(quant - preds["bf16_kernel"]).max()),
         pred_abs_max=float(np.abs(preds["bf16_kernel"]).max()))
    breakdown(predictor, "breakdown_ms_quant")
    return launches, quant_launches


def packed_bigru(enc, x, lengths):
    """The bi-GRU as the port ran it before its lengths stayed on the
    device: ``nn.GRU`` over ``pack_padded_sequence`` (the lengths copied to
    the host), directions summed."""
    from torch import nn
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)
    out, _ = nn.GRU.forward(enc, packed)
    out, _ = pad_packed_sequence(out, batch_first=True,
                                 total_length=x.shape[1])
    fwd, bwd = out.chunk(2, dim=-1)
    return fwd + bwd


def breakdown(predictor, step: str) -> None:
    """Device time of the forward's parts on one bf16 batch (CUDA events;
    median of 25): BERT, the two bi-GRUs, CubeMLP, and the 12 attention
    kernel calls inside BERT; the two bi-GRUs also in the packed form the
    port had before (``packed_bigru``), and both forms' forward and
    backward in training mode."""
    import torch

    from mimrl_tpu_torch.models.encoders import lengths_from_sequence
    from mimrl_tpu_torch.ops.flash_attention import flash_attention

    def bigru_train(form):
        m.train()
        out = [form(enc, x_, n) for enc, x_, n in ((m.rnn_a, a, la),
                                                    (m.rnn_v, v, lv))]
        torch.autograd.grad(sum(o.sum() for o in out),
                            list(m.rnn_a.parameters()) + list(m.rnn_v.parameters()))
        m.eval()

    m = predictor.model
    batch = next(iter(predictor.test_loader))
    dev = predictor.device
    ids, types, mask, a, v = (torch.from_numpy(batch[k]).to(dev) for k in (
        "bert_sentences", "bert_sentence_types", "bert_sentence_att_mask",
        "audio", "video"))
    la, lv = lengths_from_sequence(a), lengths_from_sequence(v)
    x = torch.randn(BATCH, TIME_LEN, 3, 128, device=dev)
    q, k, vv, bias = attention_inputs(BATCH, N_HEADS, TIME_LEN, HEAD_DIM,
                                      torch.bfloat16, seed=1)
    with torch.inference_mode():
        parts = dict(
            forward=cuda_ms(lambda: m(ids, types, mask, a, v,
                                      return_features=False)),
            bert=cuda_ms(lambda: m.bertmodel(ids, types, mask)),
            attention_kernel_x12=12 * cuda_ms(
                lambda: flash_attention(q, k, vv, bias), inner=10),
            bigru_a_v=cuda_ms(lambda: (m.rnn_a(a, la), m.rnn_v(v, lv))),
            bigru_a_v_packed=cuda_ms(lambda: (packed_bigru(m.rnn_a, a, la),
                                              packed_bigru(m.rnn_v, v, lv))),
            cubemlp=cuda_ms(lambda: m.mlp_encoder(x)),
        )
    parts.update(
        bigru_a_v_train=cuda_ms(lambda: bigru_train(type(m.rnn_a).forward)),
        bigru_a_v_packed_train=cuda_ms(lambda: bigru_train(packed_bigru)))
    emit(phase="serve", step=step, **parts)


def train_phase(root: str, name: str = "train", use_pallas: bool = False,
                quant: str = "none"):
    """``cli.main`` for 2 epochs at full width and depth, without flags
    (phase 'train') or with ``--use_pallas --quant <mode>`` (phase 'quant');
    returns the four launch counts of the counted run."""
    import os

    import numpy as np
    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    # the route checks before this phase leave their Solvers in reference
    # cycles (a patched optimizer step holds its optimizer); unless they are
    # collected, this phase's peak memory counts their weights and moments
    gc.collect()
    torch.cuda.empty_cache()

    data = f"{root}/train_data"
    if not os.path.isdir(data):
        make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                         d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
    flags = (["--use_pallas"] if use_pallas else []) + (
        ["--quant", quant] if quant != "none" else [])
    argv = CANONICAL_MOSI + CANONICAL_TRAIN + flags + [
        "--data_dir", data, "--task_dir", f"{root}/runs", "--task_name", name]

    def launches_of(kind, n):
        return step_launches(kind, use_pallas, quant, n)

    # The run goes through the normal entry; what it did is read off by
    # wrapping the Solver's methods and the step functions for its duration:
    # launches per epoch, host time per step (a synchronise on each side),
    # and which parameter group each stage moved.
    log = dict(epochs=[], steps=dict(critic_step=[], train_step=[], eval_step=[]),
               moved=dict(critic_step=[], train_step=[]), solver=None)
    originals = dict(train=Solver.train, evaluate=Solver.evaluate,
                     solve=Solver.solve,
                     **{n: getattr(steps, n) for n in log["steps"]})

    def probe(model):
        """One tensor of each parameter group."""
        sd = model.state_dict()
        names = dict(
            bert="bertmodel.encoder.layer.11.output.dense.weight",
            gru="rnn_a.weight_hh_l0",
            cubemlp="mlp_encoder.layers_stack.0.mlp_d.fc1.weight",
            classifier="classifier.weight",
            vmi="vmi_estimator_f_t.critic_model.MLP_g.fc_in.weight",
            vcmi="vcmi_estimator_ac_t.classifier.fc0.weight")
        return {k: sd[n].detach().clone() for k, n in names.items()}

    def timed_step(fn_name):
        def wrapper(model, *args, **kwargs):
            before = probe(model) if fn_name in log["moved"] else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[fn_name](model, *args, **kwargs)
            torch.cuda.synchronize()
            log["steps"][fn_name].append(1e3 * (time.perf_counter() - t0))
            if before is not None:
                after = probe(model)
                log["moved"][fn_name].append(
                    {k: not torch.equal(before[k], after[k]) for k in before})
            return out
        return wrapper

    def train(self, epoch):
        torch.cuda.reset_peak_memory_stats()
        c0, t0 = counts(), time.perf_counter()
        result = originals["train"](self, epoch)
        c1 = counts()
        log["epochs"].append(dict(
            epoch=epoch, train_s=time.perf_counter() - t0,
            train_launches=sub(c1, c0), eval_launches=(0, 0, 0, 0),
            train_loss=result[0],
            critic_loss=result[1], train_mis=result[2],
            stage1_pass_losses=list(self.stage1_pass_losses),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
        return result

    def evaluate(self, loader):
        c0 = counts()
        result = originals["evaluate"](self, loader)
        c1 = counts()
        log["epochs"][-1]["eval_launches"] = add(
            log["epochs"][-1]["eval_launches"], sub(c1, c0))
        log["epochs"][-1].setdefault("eval_losses", []).append(result[0])
        log["epochs"][-1].setdefault("eval_mis", []).append(result[1])
        return result

    def solve(self):
        log["solver"] = self
        return originals["solve"](self)

    zero_counts()
    Solver.train, Solver.evaluate, Solver.solve = train, evaluate, solve
    for fn_name in log["steps"]:
        setattr(steps, fn_name, timed_step(fn_name))
    try:
        t0 = time.perf_counter()
        scores = cli_main(argv)
        wall = time.perf_counter() - t0
    finally:
        Solver.train, Solver.evaluate, Solver.solve = (
            originals["train"], originals["evaluate"], originals["solve"])
        for fn_name in log["steps"]:
            setattr(steps, fn_name, originals[fn_name])
    launches = counts()
    instances = int8_instances(name, launches)
    axis_instances = axis_mlp_instances(name, launches)
    attention_instances(name, launches)

    # ---- launch counts of the four kernels, exactly, per epoch: epoch 0
    # is 3 train steps, epoch 1 is 6 critic steps and 3 train steps; each
    # epoch evaluates one valid and one test batch ----
    e0, e1 = log["epochs"]
    want = [dict(train_launches=launches_of("train", 3),
                 eval_launches=launches_of("eval", 2)),
            dict(train_launches=add(launches_of("critic", 6),
                                    launches_of("train", 3)),
                 eval_launches=launches_of("eval", 2))]
    for e, w in zip((e0, e1), want):
        got = {k: e[k] for k in w}
        require(got == w, f"{name}: epoch {e['epoch']} launches {got}, want "
                f"{w} (order {KERNEL_NAMES})")
    require(launches == add(*(w[k] for w in want for k in w)),
            f"{name}: launches of the run {launches}")

    # ---- values ----
    for e in (e0, e1):
        vals = [e["train_loss"], e["critic_loss"], *e["train_mis"],
                *e["eval_losses"], *sum(e["eval_mis"], [])]
        require(all(np.isfinite(x) for x in vals), f"non-finite value in {e}")
    require(all(m == 0.0 for m in e0["train_mis"]),
            f"epoch 0 MI channels not zero: {e0['train_mis']}")
    require(any(m != 0.0 for m in e1["train_mis"]),
            "epoch 1 MI channels all zero")
    first, second = e1["stage1_pass_losses"]
    require(second < first,
            f"critic loss did not fall: pass 1 {first}, pass 2 {second}")
    main_groups = ("bert", "gru", "cubemlp", "classifier")
    for moved in log["moved"]["train_step"]:
        require(all(moved[g] for g in main_groups)
                and not moved["vmi"] and not moved["vcmi"],
                f"train_step moved {moved}")
    for moved in log["moved"]["critic_step"]:
        require(not any(moved[g] for g in main_groups)
                and moved["vmi"] and moved["vcmi"],
                f"critic_step moved {moved}")
    require(len(log["moved"]["critic_step"]) == 6
            and len(log["moved"]["train_step"]) == 6, "step counts")
    require(scores[0] is not None and all(
        np.isfinite(v) for s in scores for v in s.values()),
        f"non-finite best scores {scores}")

    # epoch 1's steps have the shapes of epoch 0's, which warmed them up
    # (the critic's first pass warms its second)
    train_ms = log["steps"]["train_step"][3:]
    critic_ms = log["steps"]["critic_step"][3:]
    eval_ms = log["steps"]["eval_step"][2:]
    emit(phase=name, step="solver_bf16", flags=flags, epochs=log["epochs"],
         wall_s=wall, kernel_order=KERNEL_NAMES, int8_instances=instances,
         axis_mlp_instances=axis_instances,
         train_step_ms=train_ms, critic_step_ms=critic_ms, eval_batch_ms=eval_ms,
         train_step_ms_median=statistics.median(train_ms),
         critic_step_ms_median=statistics.median(critic_ms),
         eval_batch_ms_median=statistics.median(eval_ms),
         train_epoch_samples_per_s=N_TRAIN / e1["train_s"],
         stage2_samples_per_s=N_TRAIN / (1e-3 * sum(train_ms)),
         peak_mem_gb=max(e["peak_mem_gb"] for e in log["epochs"]),
         launches=dict(zip(KERNEL_NAMES, launches)), best_valid=scores[0])

    solver = log["solver"]
    train_breakdown(solver, name)
    del solver
    log["solver"] = None
    torch.cuda.empty_cache()

    # ---- the run's best_valid slot serves, with the flags the run's
    # config.json recorded (outside the counted run) ----
    predictor = Predictor(f"{root}/runs/{name}")
    require(predictor.cfg.use_pallas == use_pallas and predictor.cfg.quant == quant,
            f"{name}: the run's config lost its flags")
    c0 = counts()
    metrics = predictor.evaluate_split("test")
    served = sub(counts(), c0)
    require(served == launches_of("eval", 1),
            f"{name}: Predictor launched {served} on one batch")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics of the trained checkpoint {metrics}")
    emit(phase=name, step="predictor_on_best_valid", metrics=metrics,
         launches=dict(zip(KERNEL_NAMES, served)))
    del predictor
    torch.cuda.empty_cache()
    return launches, argv


def train_breakdown(solver, name: str) -> None:
    """Device time of one bf16 ``train_step`` with MI and of its parts
    (CUDA events; median of 10 after 2 warm-up runs): forward, backward,
    optimizer; and the 12 + 12 attention launches at the step's shape."""
    import torch

    from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from mimrl_tpu_torch.train import steps

    opt, model = solver.opt, solver.model
    batch = next(iter(solver.train_loader))
    mb, labels, _ = solver._prep(batch)
    gen = solver.generator
    params = solver.opt_main.params
    model.train()

    def forward():
        model.train()  # eval_step, timed above, leaves the model in eval mode
        knn = steps.sample_all_knn(gen, solver.bank, opt.batch_size,
                                   opt.k_neighbor, opt.radius)
        return steps.stage2_loss(model, opt, mb, labels, knn, gen)[0]

    q, k, v, bias = attention_inputs(BATCH, N_HEADS, TIME_LEN, HEAD_DIM,
                                     torch.bfloat16, seed=2)
    seed = torch.tensor([7], device=q.device)
    d_out = torch.randn_like(q)
    parts = dict(
        train_step=cuda_ms(lambda: steps.train_step(
            model, solver.opt_main, opt, mb, labels, solver.bank,
            solver.new_bank, 0, gen, True), 2, 10),
        critic_step=cuda_ms(lambda: steps.critic_step(
            model, solver.opt_vmi, opt, mb, labels, solver.bank, gen), 2, 10),
        eval_step=cuda_ms(lambda: steps.eval_step(
            model, opt, mb, labels, solver.bank, gen, True), 2, 10),
        forward=cuda_ms(forward, 2, 10),
    )
    # the steps above updated the parameters in place: the graph whose
    # backward is timed is built after them, and the optimizer runs last
    loss = forward()
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    parts.update(
        backward=cuda_ms(lambda: torch.autograd.grad(
            loss, params, retain_graph=True), 2, 10),
        optimizer=cuda_ms(lambda: solver.opt_main.step(grads), 2, 10),
        attention_fwd_kernel_x12=12 * cuda_ms(
            lambda: flash_attention(q, k, v, bias, seed, DROPOUT_P), inner=10),
        attention_bwd_kernel_x12=12 * cuda_ms(
            lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, DROPOUT_P),
            inner=10),
    )
    emit(phase=name, step="breakdown_ms", **parts)
    train_profile(solver, mb, labels, name)


def train_profile(solver, mb, labels, name: str,
                  step_name: str = "profile_train_step") -> None:
    """torch.profiler over three train steps: device time by kernel
    name (the twelve largest, and every row of the port's own kernels,
    whose names carry the sources' kernel names), the device's busy time
    per step (the sum over
    kernels and copies) and the attention kernels' part of it, the device's
    span of the same three steps (CUDA
    events around them, inside the profiler) and from these two the idle
    share, and the host's wall time under the profiler. Informative only:
    without device records it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.train import steps

    def step():
        steps.train_step(solver.model, solver.opt_main, solver.opt, mb, labels,
                         solver.bank, solver.new_bank, 0, solver.generator,
                         True)

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # device records only: recording the host's operators as well slows the
    # host, which this step is bound by, and stretches the span
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            step()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    span_ms = start.elapsed_time(end) / 3
    # kernel-level records only: an operator's row repeats its kernels' time
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = device_busy_ms(prof)[0] / 3
    attention_ms = sum(r[1] for r in rows if "flash_" in r[0]) / 3e3
    emit(phase=name, step=step_name, steps=3, card=card(),
         wall_ms_per_step_profiled=wall_ms, device_busy_ms_per_step=busy_ms,
         attention_ms_per_step=attention_ms,
         attention_share_of_busy=attention_ms / busy_ms if rows else None,
         device_span_ms_per_step_profiled=span_ms,
         device_idle_share_profiled=(1.0 - busy_ms / span_ms) if rows else None,
         device_records=bool(rows),
         top=[dict(name=k[:80], ms_per_step=t / 3e3, calls_per_step=c / 3)
              for k, t, c in rows[:12]],
         port_kernels=[dict(name=k[:80], ms_per_step=t / 3e3,
                            calls_per_step=c / 3) for k, t, c in rows
                       if any(n in k for n in PORT_KERNEL_SYMBOLS)])


def train_f32_profile(argv) -> None:
    """One float32 ``train_step`` of the canonical recipe as the README's
    quick start runs it (no ``--compute_dtype``: float32, dropout on),
    profiled as ``train_profile`` reads the bf16 one: busy ms, idle share,
    the attention rows (12 forward and 12 backward launches, every one on
    the tensor-core instance)."""
    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.train.solver import Solver

    cfg = parse_args(f32_argv(argv)).replace(task_name="f32_profile",
                                             save_models=False)
    require(cfg.compute_dtype == "float32", "the README recipe is not float32")
    solver = Solver(cfg)
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    zero_counts()
    train_profile(solver, mb, labels, "train", "profile_train_step_f32")
    # the profiled run: 1 warm-up and 3 profiled steps
    launches = counts()
    attention_instances("train_f32_profile", launches)
    require(launches == step_launches("train", False, "none", 4),
            f"float32 train_step profile: launches {launches}")
    solver.writer.close()
    del solver
    gc.collect()
    torch.cuda.empty_cache()


ROUTES = (  # name, flash_attn, backward through the plain version
    ("kernels", "on", False), ("plain", "off", False),
    ("plain_backward", "on", True))


def grad_gap(got, want):
    """Per parameter, the largest gradient difference relative to the
    parameter's largest gradient in ``want`` (or to GRAD_FLOOR times the
    largest of all, where its own is below that); the five worst, and the
    worst three of those attention projections whose own gradient is above
    the floor."""
    size = {n: g.abs().max().item() for n, g in want.items()}
    diff = {n: (got[n] - want[n]).abs().max().item() for n in want}
    floor = GRAD_FLOOR * max(size.values())
    errs = {n: diff[n] / max(size[n], floor) for n in want}

    def rows(names, k):
        return [dict(name=n, rel_diff=errs[n], abs_diff=diff[n],
                     grad_abs_max=size[n])
                for n in sorted(names, key=errs.get, reverse=True)[:k]]

    attention = [n for n in errs if ".attention.self." in n and size[n] >= floor]
    return dict(worst=rows(errs, 5), attention_worst=rows(attention, 3),
                attention_above_floor=len(attention), compared=len(errs),
                grad_abs_max=max(size.values()), floor=floor)


def train_route_check(argv, routes=ROUTES) -> None:
    """One float32 ``train_step`` with every dropout rate 0, from the same
    weights and batch, three times: through the kernels, through the plain
    attention route, and through the forward kernel with the backward
    kernel's plain version in its place. The first two must agree in their
    loss. The first and the third share a forward bit for bit, so the
    gradients that ``train_step`` hands its optimizer differ by the
    backward kernel alone, and must agree parameter by parameter. (The gap
    to the plain route's gradients and the updates are stated only: the
    forwards differ there, and Adam's first step is ``lr * sign(g)``.)"""
    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.ops import flash_attention as fa
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    fwd_counter, bwd_counter = fa.flash_attention, fa.flash_attention_bwd
    results = {}
    for route, flash_attn, plain_backward in routes:
        cfg = parse_args(argv).replace(
            compute_dtype="float32", flash_attn=flash_attn, bert_dropout=0.0,
            dropout=[0.0] * 4, dropout_mlp=[0.0] * 3, moment_dtype="float32",
            task_name=f"route_{route}", save_models=False)
        solver = Solver(cfg)
        opt_main = solver.opt_main
        names = {id(p): n for n, p in solver.model.named_parameters()}
        before = {n: p.detach().clone()
                  for n, p in solver.model.named_parameters()}
        grads = {}
        step = opt_main.step

        def recording_step(gs):
            grads.update({names[id(p)]: g.detach().clone()
                          for p, g in zip(opt_main.params, gs)})
            return step(gs)

        opt_main.step = recording_step
        mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
        c0, i0 = (fwd_counter.launches, bwd_counter.launches), \
            attention_instance_counts()
        if plain_backward:
            fa.flash_attention_bwd = fa.flash_attention_bwd_plain
        try:
            loss, _, out = steps.train_step(
                solver.model, opt_main, cfg, mb, labels, solver.bank,
                solver.new_bank, 0, solver.generator, False)
        finally:
            fa.flash_attention_bwd = bwd_counter
        torch.cuda.synchronize()
        c1 = fwd_counter.launches, bwd_counter.launches
        want = (12 if flash_attn == "on" else 0,
                12 if flash_attn == "on" and not plain_backward else 0)
        require((c1[0] - c0[0], c1[1] - c0[1]) == want,
                f"route {route}: launches {c0} -> {c1}, want {want}")
        got = tuple(sub(b, a) for a, b in zip(i0, attention_instance_counts()))
        require(got == ((want[0], 0), (want[1], 0)),
                f"route {route}: float32 attention launches (tensor_core, "
                f"simt) {got}, want {want} all on tensor_core")
        require(len(grads) == len(opt_main.params), "train_step took no step")
        results[route] = (loss.item(), out, grads, {
            n: p.detach() - before[n] for n, p in solver.model.named_parameters()})
        solver.writer.close()
        del solver, opt_main, step
    (l_on, o_on, g_on, u_on), (l_off, o_off, g_off, u_off) = (
        results["kernels"], results["plain"])
    l_pb, o_pb, g_pb, _ = results["plain_backward"]
    rel = abs(l_on - l_off) / max(abs(l_off), 1e-30)
    upd_diff = max((u_on[n] - u_off[n]).abs().max().item() for n in u_on)
    upd_max = max(u.abs().max().item() for u in u_off.values())
    gap = grad_gap(g_on, g_pb)
    extra = {f"grads_vs_{r}": grad_gap(g_on, results[r][2])
             for r in results if r not in ("kernels", "plain_backward")}
    emit(phase="train", step="route_check", loss_kernel=l_on, loss_plain=l_off,
         loss_rel_diff=rel, tol=TRAIN_F32_LOSS_TOL,
         out_max_abs_diff=(o_on - o_off).abs().max().item(),
         update_max_abs_diff=upd_diff, update_abs_max=upd_max,
         grad_tol=TRAIN_F32_GRAD_TOL, grads_vs_plain_backward=gap, **extra)
    require(rel <= TRAIN_F32_LOSS_TOL,
            f"float32 train step, kernel vs plain route: loss {l_on} vs {l_off}")
    require(upd_max > 0 and all(
        torch.isfinite(u).all() for u in u_on.values()), "no or non-finite update")
    require(all(torch.isfinite(g).all() for g in g_on.values()),
            "non-finite gradient on the kernel route")
    require(l_on == l_pb and torch.equal(o_on, o_pb),
            "the forward kernel gave other bits on the same inputs")
    worst = gap["worst"][0]
    require(worst["rel_diff"] <= TRAIN_F32_GRAD_TOL,
            f"float32 train step, backward kernel vs its plain version: the "
            f"gradient of {worst['name']} differs by {worst['rel_diff']} of "
            f"its size")
    require(gap["attention_above_floor"] >= 12,
            f"only {gap['attention_above_floor']} attention gradients above "
            f"the floor")


def train_bf16_route_check(argv) -> None:
    """One bf16 ``train_step`` of the canonical recipe as it runs, dropout
    included, from the same weights, batch and generator: through both
    attention kernels (the tensor-core instances), every launch also held
    against its plain version on the same inputs (LAUNCH_BF16_TOL); with
    the backward kernel's plain version behind the same forward, so that
    the gradients handed to the optimizer differ by the backward kernel
    alone (TRAIN_BF16_GRAD_TOL); the controls, the backward kernel with a
    fault of CONTROL_FAULTS in its outputs, each of which that gate must
    catch; and through the plain attention route, which draws the same
    Philox masks (loss within TRAIN_BF16_LOSS_TOL)."""
    import math

    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.ops import flash_attention as fa

    errors = {"fwd": [], "bwd": []}
    kernels = step_launches("train", False, "none")
    routes = [  # name, flash_attn, patches, launches
        ("kernels", "on", checked_launches(errors), kernels),
        ("plain_backward", "on", ((fa, "flash_attention_bwd",
                                   fa.flash_attention_bwd_plain),),
         (12, 0, 0, 0)),
        ("plain", "off", (), (0, 0, 0, 0))]
    routes += [(f"control_{f}", "on", faulty_backward(f), kernels)
               for f in CONTROL_FAULTS]
    results = {}
    for route, flash_attn, patches, want in routes:
        cfg = parse_args(argv).replace(flash_attn=flash_attn, save_models=False,
                                       task_name=f"bf16_route_{route}")
        results[route] = recorded_train_step(cfg, patches)
        require(results[route][3] == want,
                f"bf16 route {route}: launches {results[route][3]}, want {want}")
    grads = {r: {n: g.float() for n, g in res[2].items()}
             for r, res in results.items()}
    (l_k, o_k, _, _), (l_p, o_p, _, _) = results["kernels"], results["plain"]
    l_b, o_b, _, _ = results["plain_backward"]
    rel = abs(l_k - l_p) / max(abs(l_p), 1e-30)
    gap = grad_gap(grads["kernels"], grads["plain_backward"])
    controls = {f: grad_gap(grads[f"control_{f}"], grads["plain_backward"])
                for f in CONTROL_FAULTS}
    emit(phase="train", step="route_check_bf16", loss_kernel=l_k,
         loss_plain=l_p, loss_rel_diff=rel, tol=TRAIN_BF16_LOSS_TOL,
         out_max_abs_diff=(o_k.float() - o_p.float()).abs().max().item(),
         out_abs_max=o_p.float().abs().max().item(),
         launches_checked={k: len(e) for k, e in errors.items()},
         launch_rel_err_max={k: max(e) for k, e in errors.items()},
         launch_tol=LAUNCH_BF16_TOL, grad_tol=TRAIN_BF16_GRAD_TOL,
         grads_vs_plain_backward=gap,
         controls=[dict(fault=f, worst=c["worst"][0],
                        attention_worst=c["attention_worst"][0])
                   for f, c in controls.items()],
         grads_vs_plain_route=grad_gap(grads["kernels"], grads["plain"]))
    require(math.isfinite(l_k) and all(
        bool(g.isfinite().all()) for g in grads["kernels"].values()),
        "bf16 train step: non-finite loss or gradient on the kernel route")
    require(rel <= TRAIN_BF16_LOSS_TOL,
            f"bf16 train step, kernel vs plain route: loss {l_k} vs {l_p}, "
            f"relative {rel} > {TRAIN_BF16_LOSS_TOL}")
    require(all(len(e) == 12 for e in errors.values()),
            f"checked launches {[len(e) for e in errors.values()]}, want 12")
    for kind, e in errors.items():
        require(max(e) <= LAUNCH_BF16_TOL,
                f"bf16 train step: an attention {kind} launch differs from "
                f"its plain version by {max(e)} > {LAUNCH_BF16_TOL}")
    require(l_k == l_b and torch.equal(o_k, o_b),
            "bf16: the forward kernel gave other bits on the same inputs")
    worst = gap["worst"][0]
    require(worst["rel_diff"] <= TRAIN_BF16_GRAD_TOL,
            f"bf16 train step, backward kernel vs its plain version: the "
            f"gradient of {worst['name']} differs by {worst['rel_diff']} of "
            f"its size > {TRAIN_BF16_GRAD_TOL}")
    for fault, c in controls.items():
        caught = c["worst"][0]["rel_diff"]
        require(caught > TRAIN_BF16_GRAD_TOL,
                f"bf16 control: a fault of {fault} in the backward moved the "
                f"gradients by {caught} only, within the gate")


def recorded_train_step(cfg, patches=()):
    """One ``train_step`` of a fresh ``Solver`` for ``cfg`` on the first
    train batch, with ``patches`` ((module, attribute, replacement), ...)
    in place for its duration. Returns (loss, outputs, the gradients the
    step handed its optimizer by parameter name, launch counts)."""
    import torch

    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    solver = Solver(cfg)
    opt_main = solver.opt_main
    names = {id(p): n for n, p in solver.model.named_parameters()}
    grads = {}
    step = opt_main.step

    def recording_step(gs):
        grads.update({names[id(p)]: g.detach().clone()
                      for p, g in zip(opt_main.params, gs)})
        return step(gs)

    opt_main.step = recording_step
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    c0, i0 = counts(), attention_instance_counts()
    with patched(patches):
        loss, _, out = steps.train_step(
            solver.model, opt_main, cfg, mb, labels, solver.bank,
            solver.new_bank, 0, solver.generator, False)
    torch.cuda.synchronize()
    launches = sub(counts(), c0)
    got = tuple(sub(b, a) for a, b in zip(i0, attention_instance_counts()))
    require(got == ((launches[0], 0), (launches[1], 0)),
            f"{cfg.task_name}: attention launches (tensor_core, simt) {got}, "
            f"want {launches[:2]} all on tensor_core")
    require(len(grads) == len(opt_main.params), "train_step took no step")
    solver.writer.close()
    return loss.item(), out, grads, launches


def quant_route_check(argv) -> None:
    """One float32 ``train_step`` with ``--use_pallas --quant int8`` and
    every dropout rate 0, from the same weights and batch, three times:
    through all four kernels; with the int8 kernel's plain version in its
    place; with the axis-MLP kernel's plain version in its place. The int8
    kernel is exact, so the second must repeat the first bit for bit (loss,
    outputs, every gradient but the embedding tables', whose atomics sum in
    a changing order). The third differs by the axis-MLP kernel alone. So
    does a second pair of steps, under ``--use_pallas`` without
    quantisation, which holds that kernel's effect on the gradients apart
    from the int8 roundings behind it. Tolerances: the top of this file."""
    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.ops import cubemlp_kernel, quant
    from mimrl_tpu_torch.ops.int8_matmul import int8_matmul_plain

    def plain_axis_mlp(x, w1, w2, b1, b2, axis, activate):
        return cubemlp_kernel.fused_axis_mlp_plain(x, w1, w2, b1, b2, axis,
                                                   activate)

    axis_patch = ((cubemlp_kernel, "_forward", plain_axis_mlp),)
    routes = (  # name, quant, patches
        ("kernels", "int8", ()),
        ("plain_int8", "int8", ((quant, "int8_matmul", int8_matmul_plain),)),
        ("plain_axis_mlp", "int8", axis_patch),
        ("no_quant_kernel", "none", ()),
        ("no_quant_plain_axis_mlp", "none", axis_patch))
    results = {}
    for route, mode, patches in routes:
        cfg = parse_args(argv).replace(
            compute_dtype="float32", bert_dropout=0.0, dropout=[0.0] * 4,
            dropout_mlp=[0.0] * 3, moment_dtype="float32", quant=mode,
            task_name=f"quant_route_{route}", save_models=False)
        results[route] = recorded_train_step(cfg, patches)
        want = list(step_launches("train", True, mode))
        if route == "plain_int8":
            want[3] = 0
        if patches is axis_patch:
            want[2] = 0
        require(results[route][3] == tuple(want),
                f"route {route}: launches {results[route][3]}, want {want}")
    l_k, o_k, g_k, _ = results["kernels"]
    require(all(torch.isfinite(g).all() for g in g_k.values()),
            "non-finite gradient on the kernel route")

    # the int8 kernel against its plain version inside the step: no change
    l_i, o_i, g_i, _ = results["plain_int8"]
    require(l_k == l_i and torch.equal(o_k, o_i),
            f"the int8 kernel changed the step's forward: loss {l_k} vs {l_i}")
    tables = [n for n in g_k if "embeddings" in n and "LayerNorm" not in n]
    unequal = [n for n in g_k if n not in tables and not torch.equal(g_k[n], g_i[n])]
    require(not unequal, f"the int8 kernel changed the gradient of {unequal[:3]}")
    table_gap = max(rel_err(g_k[n], g_i[n]) for n in tables)
    require(table_gap <= EMBEDDING_GRAD_TOL,
            f"embedding tables' gradients differ by {table_gap}")

    # the axis-MLP kernel against its plain version inside the step, with
    # the int8 products behind it and without them
    l_a, o_a, g_a, _ = results["plain_axis_mlp"]
    l_n, o_n, g_n, _ = results["no_quant_kernel"]
    l_p, o_p, g_p, _ = results["no_quant_plain_axis_mlp"]
    rel = abs(l_k - l_a) / max(abs(l_a), 1e-30)
    rel_n = abs(l_n - l_p) / max(abs(l_p), 1e-30)
    gap, gap_n = grad_gap(g_k, g_a), grad_gap(g_n, g_p)
    emit(phase="quant", step="route_check", loss_kernels=l_k,
         loss_plain_int8=l_i, loss_plain_axis_mlp=l_a,
         bit_equal_with_plain_int8=len(g_k) - len(tables),
         embedding_tables_rel_diff=table_gap,
         embedding_tol=EMBEDDING_GRAD_TOL, loss_rel_diff=rel,
         tol=TRAIN_F32_LOSS_TOL,
         out_max_abs_diff=(o_k - o_a).abs().max().item(),
         grad_tol=QUANT_GRAD_TOL, grads_vs_plain_axis_mlp=gap,
         no_quant=dict(loss_kernel=l_n, loss_plain_axis_mlp=l_p,
                       loss_rel_diff=rel_n,
                       out_max_abs_diff=(o_n - o_p).abs().max().item(),
                       grad_tol=AXIS_MLP_GRAD_TOL,
                       grads_vs_plain_axis_mlp=gap_n))
    require(max(rel, rel_n) <= TRAIN_F32_LOSS_TOL,
            f"float32 train step, axis-MLP kernel vs plain: loss {l_k} vs "
            f"{l_a} with int8, {l_n} vs {l_p} without")
    for what, g, tol in (("--use_pallas", gap_n, AXIS_MLP_GRAD_TOL),
                         ("--use_pallas --quant int8", gap, QUANT_GRAD_TOL)):
        worst = g["worst"][0]
        require(worst["rel_diff"] <= tol,
                f"float32 train step under {what}, axis-MLP kernel vs its "
                f"plain version: the gradient of {worst['name']} differs by "
                f"{worst['rel_diff']} of its size (tolerance {tol})")


def quant_mode_steps(argv) -> None:
    """One bf16 ``train_step`` each in ``int8_fwd`` and ``int8_all`` (with
    ``--use_pallas``): the int8 kernel launches 48 and 144 times."""
    import math

    from mimrl_tpu_torch.core.config import parse_args

    for mode in ("int8_fwd", "int8_all"):
        cfg = parse_args(argv).replace(quant=mode, task_name=f"quant_{mode}",
                                       save_models=False)
        loss, _, grads, launches = recorded_train_step(cfg)
        want = step_launches("train", True, mode)
        require(launches == want, f"{mode}: launches {launches}, want {want}")
        require(math.isfinite(loss) and all(
            bool(g.isfinite().all()) for g in grads.values()),
            f"{mode}: non-finite loss or gradient")
        emit(phase="quant", step=f"train_step_{mode}", loss=loss,
             launches=dict(zip(KERNEL_NAMES, launches)))


def write_bert_file(path: str) -> dict:
    """BERT-base in HuggingFace's layout, as ``BertForPreTraining`` saves
    it (``bert.`` prefix, pooler, ``position_ids``), from seeded tensors:
    normal(0, 0.02), LayerNorm weights 1 + normal(0, 0.02). Returns the
    tensors by the port's names."""
    import torch

    from mimrl_tpu_torch.models.bert import BertConfig, BertModel

    c = BertConfig()  # 30522 x 768, 12 layers of 12 heads, FFN 3072
    gen = torch.Generator().manual_seed(7)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in BertModel(c).state_dict().items()}
    tensors = {k: torch.randn(s, generator=gen) * 0.02
               + (1.0 if k.endswith("LayerNorm.weight") else 0.0)
               for k, s in shapes.items()}
    sd = {f"bert.{k}": v for k, v in tensors.items()}
    sd["bert.embeddings.position_ids"] = torch.arange(
        c.max_position_embeddings)[None]
    sd["bert.pooler.dense.weight"] = torch.randn(
        c.hidden_size, c.hidden_size, generator=gen) * 0.02
    sd["bert.pooler.dense.bias"] = torch.zeros(c.hidden_size)
    torch.save(sd, path)
    return tensors


def differing(got: dict, want: dict, limit: int = 8) -> list:
    """[name, rel_err] of the float tensors that differ between two
    state dicts, the largest first."""
    import torch

    gaps = sorted(((rel_err(got[k], y), k) for k, y in want.items()
                   if torch.is_tensor(y) and y.is_floating_point()
                   and not torch.equal(got[k], y)), reverse=True)
    return [[k, g] for g, k in gaps[:limit]]


def slot_tensors(slot: dict, opt_names: dict) -> dict:
    """Every tensor of a ``latest`` slot by name: the model's; each
    parameter's segment of both optimizers' flat moments, named after the
    parameter (``opt_names``: the optimizers' parameter names in order),
    and their step counts; the bank's fields; the three generators'
    states."""
    out = {f"model.{k}": v for k, v in slot["model"].items()}
    for opt, names in opt_names.items():
        state = slot[opt]
        out[f"{opt}.count"] = state["count"]
        for m in ("mu", "nu"):
            if state[m].numel():
                out.update((f"{opt}.{m}.{n}", seg) for n, seg in
                           zip(names, state[m].split(state["sizes"])))
    out.update((f"bank.{k}", v) for k, v in slot["bank"].items())
    out.update((f"rng.{k}", v) for k, v in slot["rng"].items())
    return out


def ulp_gap(got, want) -> float:
    """The largest difference of two tensors in units of the spacing of
    ``want``'s dtype at each element of ``want`` (its last place): 0 where
    bit-equal; huge where ``want`` holds a 0 that ``got`` does not;
    infinite for tensors that are not floating point."""
    import math

    import torch

    if torch.equal(got, want):
        return 0.0
    if not want.is_floating_point():
        return float("inf")
    info = torch.finfo(want.dtype)
    mantissa_bits = round(-math.log2(info.eps))
    # |want| = m * 2^e with m in [0.5, 1): one last place is 2^(e-1-bits)
    _, exponent = torch.frexp(want.double().abs().clamp_min(info.tiny))
    spacing = torch.ldexp(torch.ones_like(want, dtype=torch.float64),
                          exponent - 1 - mantissa_bits)
    return ((got.double() - want.double()).abs() / spacing).max().item()


def parameter(key: str) -> str:
    """The parameter a ``slot_tensors`` key belongs to: "model.x",
    "opt_main.mu.x", "opt_main.nu.x" -> x; other keys stand for
    themselves."""
    head, _, rest = key.partition(".")
    if head.startswith("opt_") and rest[:3] in ("mu.", "nu."):
        return rest[3:]
    return rest if head == "model" else key


def gap_gate(got: dict, want: dict, control: dict):
    """The resume phase's gate between two runs' ``slot_tensors``: where
    ``control`` (a repeat of ``want``'s run) equals ``want``, ``got`` must
    too; on every parameter where it does not (its value and both moments,
    ``unstable``), ``got`` may differ from ``want`` by RESUME_GAP_FACTOR
    times the largest control gap, in last places. Returns (passed, the
    record)."""
    import torch

    moved = {parameter(k) for k, v in want.items()
             if not torch.equal(control[k], v)}
    unstable = sorted(k for k in want if parameter(k) in moved)
    control_ulps = max((ulp_gap(control[k], want[k]) for k in unstable),
                       default=0.0)
    limit = RESUME_GAP_FACTOR * control_ulps
    outside = [k for k, v in want.items()
               if k not in unstable and not torch.equal(got[k], v)]
    inside = max((ulp_gap(got[k], want[k]) for k in unstable), default=0.0)
    return (not outside and inside <= limit,
            dict(unstable=unstable, control_ulps=control_ulps,
                 limit_ulps=limit, differing_outside_unstable=len(outside),
                 first_differing=outside[:5], unstable_ulps=inside,
                 bit_equal=not outside and inside == 0))


def epoch_values(task: str, epoch: int) -> list:
    """The train loss and the eight train MI values of ``epoch``, from the
    run's ``scalars.jsonl``."""
    rows = {r["tag"]: r["value"] for r in map(json.loads, open(
        f"{task}/scalars.jsonl")) if r["step"] == epoch}
    return [rows["Train/Loss"]] + [rows[f"Train/MI_{n}"] for n in (
        "ft", "fa", "fv", "in", "spec_t", "spec_a", "spec_v", "comp")]


def resume_phase(root: str):
    """A run stopped by SIGTERM in epoch 1 and resumed for epoch 2 (C)
    against the same run uninterrupted (A) and A's repeat (A2), at full
    width through ``cli.main`` with ``--bert_weights``; returns the launch
    counts of the resumed run."""
    import os
    import signal
    import threading
    import warnings

    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.core.checkpoint import CheckpointManager
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    gc.collect()
    torch.cuda.empty_cache()
    data, runs = f"{root}/train_data", f"{root}/resume_runs"
    if not os.path.isdir(data):
        make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                         d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
    bert_path = f"{root}/pytorch_model.bin"
    bert = write_bert_file(bert_path)

    def argv(name, *flags):
        return CANONICAL_MOSI + CANONICAL_TRAIN + RESUME_ARGS + [
            "--bert_weights", bert_path, "--data_dir", data,
            "--task_dir", runs, "--task_name", name, *flags]

    record = dict(phase="resume", step="resume_vs_uninterrupted",
                  bert_file_bytes=os.path.getsize(bert_path))
    originals = {n: vars(Solver)[n] for n in ("solve", "train", "_resume")}
    save, write_file = CheckpointManager.save, CheckpointManager._write_file
    saves, writes = [], []

    def timed_save(self, slot, state):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        save(self, slot, state)
        saves.append(dict(slot=slot, backend=self.backend,
                          ms=1e3 * (time.perf_counter() - t0),
                          live_gb=live / 1e9,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))

    def timed_write(self, slot, host, event):
        """The write of a slot, on the thread that does it."""
        t0 = time.perf_counter()
        write_file(self, slot, host, event)
        writes.append(dict(slot=slot, backend=self.backend,
                           thread=threading.current_thread().name,
                           ms=1e3 * (time.perf_counter() - t0),
                           bytes=os.path.getsize(self._path(slot))))

    def run(name, *flags, patches=()):
        """cli.main, then the run's final latest slot and epoch-2 values."""
        gc.collect()
        torch.cuda.empty_cache()
        with patched([(CheckpointManager, "save", timed_save),
                      (CheckpointManager, "_write_file", timed_write),
                      *patches]):
            cli_main(argv(name, *flags))
        task = f"{runs}/{name}"
        slot = CheckpointManager(task).restore("latest", map_location="cpu")
        return dict(slot=slot, values=(epoch_values(task, 2)
                                       if slot["epoch"] == 2 else None))

    # A: uninterrupted; its Solver must hold the BERT file's tensors
    opt_names = {}

    def solve_checking_bert(self):
        names = {id(p): n for n, p in self.model.named_parameters()}
        opt_names.update((k, [names[id(p)] for p in getattr(self, k).params])
                         for k in ("opt_main", "opt_vmi"))
        sd = self.model.bertmodel.state_dict()
        unequal = [k for k, v in bert.items() if not torch.equal(sd[k].cpu(), v)]
        require(sd.keys() == bert.keys() and not unequal,
                f"--bert_weights: the Solver's BERT differs from the file "
                f"in {unequal[:3]}")
        record["bert_tensors_checked"] = len(bert)
        return originals["solve"](self)

    a = run("A", patches=[(Solver, "solve", solve_checking_bert)])
    a_saves, a_writes = list(saves), list(writes)
    a2 = run("A2")

    # B: SIGTERM to this process during epoch 1, under --ckpt_backend
    # orbax: its slots are written on a background thread, and latest is
    # durable when the run stops
    def train_with_sigterm(self, epoch):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return originals["train"](self, epoch)

    handler = signal.getsignal(signal.SIGTERM)
    del saves[:], writes[:]
    b = run("B", "--ckpt_backend", "orbax",
            patches=[(Solver, "train", train_with_sigterm)])
    b_saves, b_writes = list(saves), list(writes)
    require(b["slot"]["epoch"] == 1 and signal.getsignal(signal.SIGTERM) is handler,
            f"run B: latest at epoch {b['slot']['epoch']}, want 1, and the "
            "SIGTERM handler restored")
    require(b_writes and all(w["thread"] != "MainThread" for w in b_writes)
            and all(w["thread"] == "MainThread" for w in a_writes),
            f"run B's slots not written on a background thread: {b_writes}")
    del b
    b_task = f"{runs}/B"
    t0 = time.perf_counter()
    CheckpointManager(b_task).restore("latest", map_location="cpu")
    record["read_latest_ms"] = 1e3 * (time.perf_counter() - t0)

    # C: resume B for epoch 2, the launches of each train_step counted
    step_counts, resume_ms = [], []
    train_step = steps.train_step

    def counted_train_step(*args, **kwargs):
        c0 = counts()
        out = train_step(*args, **kwargs)
        step_counts.append(sub(counts(), c0))
        return out

    def timed_resume(self, resume_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        originals["_resume"](self, resume_dir)
        torch.cuda.synchronize()
        resume_ms.append(1e3 * (time.perf_counter() - t0))

    zero_counts()
    c = run("C", "--resume", b_task, patches=[
        (steps, "train_step", counted_train_step),
        (Solver, "_resume", timed_resume)])
    launches = counts()
    attention_instances("resume", launches)
    want = add(step_launches("critic", False, "none", 6),
               step_launches("train", False, "none", 3),
               step_launches("eval", False, "none", 2))
    require(launches == want and step_counts == [
        step_launches("train", False, "none")] * 3,
        f"resumed epoch: launches {launches} (want {want}), per train_step "
        f"{step_counts}")

    # fault control: a resume that leaves the loader's passes at 0
    def resume_passes_at_zero(self, resume_dir):
        originals["_resume"](self, resume_dir)
        self.train_loader.passes = 0

    fault = run("fault_passes", "--resume", b_task, patches=[
        (Solver, "_resume", resume_passes_at_zero)])

    # the gate: where A2 equals A, C must too; where the card does not
    # reproduce itself (``unstable``: every parameter of which A2 differs
    # from A in its value or a moment, with its value and both moments),
    # C may differ from A by up to RESUME_GAP_FACTOR times the largest
    # A2-vs-A gap there, in last places
    tensors = {k: dict(slot_tensors(r["slot"], opt_names), epoch2_values=(
                   torch.tensor(r["values"], dtype=torch.float64)))
               for k, r in dict(a=a, a2=a2, c=c, fault=fault).items()}

    moved = {parameter(k) for k, v in tensors["a"].items()
             if not torch.equal(tensors["a2"][k], v)}
    unstable = sorted(k for k in tensors["a"] if parameter(k) in moved)
    control_ulps = max((ulp_gap(tensors["a2"][k], tensors["a"][k])
                        for k in unstable), default=0.0)
    limit_ulps = RESUME_GAP_FACTOR * control_ulps

    def gate(name, r):
        """(the tensors pass, the counters pass, the record)"""
        got = tensors[name]
        outside = [k for k, v in tensors["a"].items()
                   if k not in unstable and not torch.equal(got[k], v)]
        inside = max((ulp_gap(got[k], tensors["a"][k]) for k in unstable),
                     default=0.0)
        same = {k: r["slot"][k] == a["slot"][k]
                for k in ("loader_passes", "lr_schedule")}
        return (not outside and inside <= limit_ulps, all(same.values()),
                dict(differing_outside_unstable=len(outside),
                     first_differing=outside[:5], unstable_ulps=inside,
                     **{f"{k}_equal": v for k, v in same.items()}))

    tensors_ok, counters_ok, resumed = gate("c", c)
    passed = tensors_ok and counters_ok
    # the fault must be caught by what training computed, not by the pass
    # counter it leaves behind
    fault_tensors_ok, _, faulty = gate("fault", fault)
    caught = not fault_tensors_ok
    latest = os.path.getsize(f"{b_task}/latest_model.pt")
    record.update(
        tensors_compared=len(tensors["a"]), unstable=unstable,
        control_ulps=control_ulps, limit_ulps=limit_ulps,
        gap_factor=RESUME_GAP_FACTOR, resumed_c_vs_a=resumed, fault_passes_at_zero_vs_a=faulty,
        bit_equal_control=not unstable,
        bit_equal_resumed=not resumed["differing_outside_unstable"]
        and resumed["unstable_ulps"] == 0,
        gate_passed=passed, fault_caught=caught, slot_bytes=latest,
        write_latest_ms=[s["ms"] for s in a_saves if s["slot"] == "latest"],
        card=card(), save_main_thread_ms={
            backend: [s["ms"] for s in got if s["slot"] == "latest"]
            for backend, got in (("msgpack", a_saves), ("orbax", b_saves))},
        background_write_ms=[w["ms"] for w in b_writes],
        background_write_bytes=[w["bytes"] for w in b_writes],
        background_write_threads=sorted({w["thread"] for w in b_writes}),
        save_peak_gb=max(s["peak_gb"] for s in a_saves),
        save_live_gb=max(s["live_gb"] for s in a_saves),
        resume_ms=resume_ms[0], launches=dict(zip(KERNEL_NAMES, launches)),
        train_step_launches=[dict(zip(KERNEL_NAMES, s)) for s in step_counts],
        epoch2_values_a=a["values"], epoch2_values_c=c["values"])

    # where A and A2 differ: which operations torch's deterministic-
    # algorithm check flags in one train_step, and which gradients differ
    # between two train_steps from the same state
    if unstable:
        cfg = parse_args(argv("probe")).replace(save_models=False)
        with warnings.catch_warnings(record=True) as flagged:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                recorded_train_step(cfg)
            finally:
                torch.use_deterministic_algorithms(False)
        record["nondeterministic_ops"] = sorted({
            str(w.message)[:160] for w in flagged
            if "determinis" in str(w.message)})
        grads = [recorded_train_step(cfg)[2] for _ in range(2)]
        record["train_step_grads_differing"] = differing(*grads, limit=20)
    emit(**record)
    require(caught, "resume gate: a resume with the loader's passes at 0 "
            f"passed the gate ({faulty})")
    require(passed, f"resume gate: C vs A {resumed}, limit {limit_ulps} "
            f"last places in {unstable}")
    return launches


def rung_launches(stage1: str, use_pallas: bool, quant: str):
    """Launches of a 3-epoch rung run: 9 train steps, 6 eval batches, and in
    epochs 1-2 stage 1's forwards: 12 with a fresh one per critic step, 6
    with ``--fast_stage1``, none with ``--stage1_cached``."""
    forwards = {"scan": 12, "fast": 6, "cached": 0}[stage1]
    return add(step_launches("train", use_pallas, quant, 9),
               step_launches("eval", use_pallas, quant, 6),
               step_launches("critic", use_pallas, quant, forwards))


def profiled_steps(fn, n: int) -> dict:
    """torch.profiler over one call of fn() that runs ``n`` steps (after a
    warm-up call): device busy ms per step (kernels and copies), the
    device's span per step (CUDA events inside the profiler), the idle
    share, and the host's wall ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    span_ms = start.elapsed_time(end) / n
    busy, total = device_busy_ms(prof)
    busy_ms = busy / n
    return dict(device_busy_ms=busy_ms if busy else None,
                device_kernel_sum_ms=total / n if busy else None,
                device_span_ms=span_ms,
                idle_share=(1.0 - busy_ms / span_ms) if busy else None,
                wall_ms=wall_ms)


def rung_profile(solver, stage1: str) -> dict:
    """``profiled_steps`` over a stage-2 epoch (3 ``train_step``s with MI)
    and a one-pass stage 1 (3 critic steps) of a finished rung run's
    Solver, through its own runner: replayed graphs, or eager calls."""
    from mimrl_tpu_torch.train import steps

    o = solver.opt
    batches, labels, _, _ = solver._stack_epoch(solver.train_loader)
    nb = labels.shape[0]

    def stage2():
        steps.train_epoch(solver.model, solver.opt_main, o, batches, labels,
                          solver.bank, solver.new_bank, solver.generator,
                          True, run=solver.graphs)

    def stage1_pass():
        if stage1 == "cached":
            steps.critic_epoch_cached(solver.model, solver.opt_vmi, o,
                                      solver.bank, nb, solver.generator, 1,
                                      run=solver.graphs)
        else:
            fn = steps.critic_epoch if stage1 == "fast" else steps.critic_epoch_fresh
            fn(solver.model, solver.opt_vmi, o, batches, labels, solver.bank,
               solver.generator, 1, run=solver.graphs)

    return dict(train_step=profiled_steps(stage2, nb),
                critic_step=profiled_steps(stage1_pass, nb))


def capture_failure_check() -> dict:
    """A body that copies a pageable host tensor to the card cannot be
    captured: the runner must raise, naming the step, and keep no graph."""
    import torch

    from mimrl_tpu_torch.train.graphs import StepGraphs

    runner = StepGraphs(torch.device("cuda"))

    def body(x):
        return x * torch.tensor(2.0, device=x.device)

    try:
        runner("host_copy", body, x=torch.ones(4, device="cuda"))
    except RuntimeError as e:
        message = str(e)
    else:
        message = None
    torch.cuda.synchronize()
    caught = message is not None and "'host_copy'" in message
    require(caught and not runner.steps,
            f"a step that cannot be captured did not raise: {message}")
    return dict(raised=message[:200])


def rung_run(runs: str, name: str, argv, graphs=True, stage1=None, patches=(),
         timed=True):
    """``cli.main`` on ``argv`` with its run in ``runs/name``, with CUDA
    graphs or eagerly; returns the run's readings and its final slot's
    tensors (``rung_profile``'s reading with ``stage1``)."""
    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.train.graphs import StepGraphs
    from mimrl_tpu_torch.train.solver import Solver

    originals = {"solve": vars(Solver)["solve"],
                 "finalize": vars(Solver)["_finalize_epoch"],
                 "sync": vars(Solver)["_synchronize"],
                 "call": vars(StepGraphs)["__call__"]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    info = dict(step_ms={}, epoch_s=[], syncs=[])

    def solve(self):
        info["solver"] = self
        return originals["solve"](self)

    def finalize(self, tracking, epoch, dt, *args, **kwargs):
        info["epoch_s"].append(dt)
        return originals["finalize"](self, tracking, epoch, dt, *args,
                                     **kwargs)

    def timed_call(self, step, body, **inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["call"](self, step, body, **inputs)
        torch.cuda.synchronize()
        info["step_ms"].setdefault(step, []).append(
            1e3 * (time.perf_counter() - t0))
        return out

    def synchronize(self):
        originals["sync"](self)
        info["syncs"].append(time.perf_counter())

    argv = list(argv) + ["--task_dir", runs, "--task_name", name]
    zero_counts()
    t0 = time.perf_counter()
    with patched([(Solver, "solve", solve),
                  (Solver, "_finalize_epoch", finalize),
                  (Solver, "_synchronize", synchronize),
                  *([(StepGraphs, "__call__", timed_call)] if timed else []),
                  *patches]):
        cli_main(argv, graphs=graphs)
    info.update(wall_s=time.perf_counter() - t0, launches=counts(),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    attention_instances(name, info["launches"])
    solver = info.pop("solver")
    names = {id(p): n for n, p in solver.model.named_parameters()}
    opt_names = {k: [names[id(p)] for p in getattr(solver, k).params]
                 for k in ("opt_main", "opt_vmi")}
    task = f"{runs}/{name}"
    last = solver.opt.epochs_num - 1
    # the state a latest slot of the last epoch would hold, taken in
    # memory: a BERT-base slot is 1.1 GB, and the script's dozens of runs
    # would otherwise write tens of GB that nothing reads back
    slot = solver._snapshot(last)
    info["tensors"] = dict(
        {k: v.cpu() for k, v in slot_tensors(slot, opt_names).items()},
        last_epoch_values=torch.tensor(epoch_values(task, last),
                                       dtype=torch.float64))
    info["graphs"] = solver.graphs.stats()
    if stage1 is not None:
        info["profile"] = rung_profile(solver, stage1)
    del solver, slot
    return info


def rungs_phase(root: str):
    """The --epoch_scan rungs at full width and depth through ``cli.main``,
    3 epochs each, with CUDA graphs (G), eagerly (E) and eagerly again
    (E2): G against E by ``gap_gate`` with E2 as the control, a G whose
    replays reuse the generator's state at capture (what an unregistered
    generator would do) must fail that gate; launches counted through
    replays; per-step host ms, epoch s, device busy and idle share, capture
    s per graph, peak memory; the per-batch path's stage-2 ms per step with
    --num_workers 0 and 4. Returns the launch counts of the three flag-free
    G runs together and of the flagged one."""
    import os

    import torch

    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.train.graphs import StepGraphs

    gc.collect()
    torch.cuda.empty_cache()
    data, runs = f"{root}/train_data", f"{root}/rung_runs"
    if not os.path.isdir(data):
        make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                         d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
    call = vars(StepGraphs)["__call__"]

    def run(name, flags, **kwargs):
        return rung_run(runs, name, CANONICAL_MOSI + CANONICAL_TRAIN
                        + RUNG_ARGS + flags + ["--data_dir", data], **kwargs)

    def medians(info):
        """Median ms of each step's calls after its first (the first runs
        eagerly and captures)."""
        return {k: statistics.median(v[1:]) for k, v in info["step_ms"].items()
                if len(v) > 1}

    records, totals = [], []
    for stage1, flags in RUNGS + (("quant", ["--epoch_scan"] + QUANT_FLAGS),):
        quant = stage1 == "quant"
        mode = "scan" if quant else stage1
        g = run(f"{stage1}_graphs", flags, stage1=mode)
        e = run(f"{stage1}_eager", flags, graphs=False, stage1=mode)
        e2 = run(f"{stage1}_eager2", flags, graphs=False)
        want = rung_launches(mode, quant, "int8" if quant else "none")
        for r in (g, e):
            require(r["launches"] == want,
                    f"rung {stage1}: launches {r['launches']}, want {want} "
                    f"(order {KERNEL_NAMES})")
        if quant:
            int8_instances(f"rung {stage1}", g["launches"])
            axis_mlp_instances(f"rung {stage1}", g["launches"])
        passed, gate = gap_gate(g["tensors"], e["tensors"], e2["tensors"])
        record = dict(
            phase="rungs", step=f"rung_{stage1}", flags=flags,
            graphs_vs_eager=gate, gate_passed=passed,
            tensors_compared=len(e["tensors"]),
            launches=dict(zip(KERNEL_NAMES, g["launches"])),
            step_ms_graphs=medians(g), step_ms_eager=medians(e),
            epoch_s_graphs=g["epoch_s"], epoch_s_eager=e["epoch_s"],
            wall_s_graphs=g["wall_s"], wall_s_eager=e["wall_s"],
            peak_gb_graphs=g["peak_gb"], peak_gb_eager=e["peak_gb"],
            graphs=g["graphs"], profile_graphs=g["profile"],
            profile_eager=e["profile"],
            last_epoch_values_graphs=g["tensors"]["last_epoch_values"].tolist(),
            last_epoch_values_eager=e["tensors"]["last_epoch_values"].tolist())
        if stage1 == "scan":
            # fault control: every replay of a graph starts from the
            # generator's state right after its capture, so each replay
            # draws the same attention seeds and kNN anchors
            frozen = {}

            def frozen_call(self, step, body, **inputs):
                if step in frozen:
                    for gen, state in zip(self.generators, frozen[step]):
                        gen.set_state(state)
                out = call(self, step, body, **inputs)
                if step not in frozen and step in self.steps:
                    frozen[step] = [gen.get_state() for gen in self.generators]
                return out

            fault = run("scan_frozen_generator", flags, timed=False,
                        patches=[(StepGraphs, "__call__", frozen_call)])
            fault_passed, fault_gate = gap_gate(
                fault["tensors"], e["tensors"], e2["tensors"])
            record.update(fault_frozen_generator=fault_gate,
                          fault_caught=not fault_passed)
            del fault
        emit(**record)
        require(passed, f"rung {stage1}: graphs vs eager {gate}")
        if stage1 == "scan":
            require(record["fault_caught"], "rung gate: replays with a frozen "
                    f"generator passed it ({record['fault_frozen_generator']})")
        if quant:
            quant_launches = g["launches"]
        else:
            totals.append(g["launches"])
        del g, e, e2

    # the per-batch path's stage 2 without and with --num_workers's
    # background thread, in turns (0, 4, 4, 0): wall ms per step of epoch
    # 1's stage 2, between the syncs after stage 1 and after stage 2
    per_batch = {"0": [], "4": []}
    for i, workers in enumerate(("0", "4", "4", "0")):
        r = run(f"per_batch_{i}_workers{workers}", [
            "--epochs_num", "2", "--num_workers", workers], timed=False)
        syncs = r["syncs"]
        per_batch[workers].append(1e3 * (syncs[3] - syncs[2]) / 3)
        del r
    emit(phase="rungs", step="per_batch_stage2",
         stage2_ms_per_step_workers_0=per_batch["0"],
         stage2_ms_per_step_workers_4=per_batch["4"],
         capture_failure=capture_failure_check())
    return add(*totals), quant_launches


# ---------------------------------------------------------------------- #
# The families phase: three recipes of recipes/ at their full widths, and
# the canonical recipe with the LSTM and the Conv encoder.

FAMILY_COMMON = [  # the flags the three recipes share (recipes/*.sh)
    "--log_scale", "0-0-0", "--normalize", "0-1-1", "--d_common", "128",
    "--encoders", "gru", "--activate", "gelu", "--dropout_mlp", "0.0-0.0-0.0",
    "--dropout", "0.1-0.1-0.1-0.1", "--bias", "--res_project", "1-1",
    "--critic_type", "separate", "--baseline_type", "constant",
    "--bound_type", "infonce",
    "--loss_mi_coefficient1", "1-1-1-1-1-1-1-1-1-1-1",
    "--loss_mi_coefficient2", "0.01-0.01-0.01-0.01-0.01-0.01-0.01-0.01",
    "--k_neighbor", "2", "--stage1_n", "2", "--seed", "0",
    "--gradient_clip", "1.5", "--epochs_num", "2", "--optm", "Adam",
    "--lr_decrease", "multi_step", "--lr_decrease_rate", "0.1", "--parallel",
    # the best slots only, which Predictor serves (see rung_run's note)
    "--save_latest_every", "0"]
CUBE_T100 = ["--time_len", "100", "--d_hiddens", "50-3-128=10-3-128",
             "--d_outs", "50-3-128=10-3-128"]
# recipe -> (its own flags, (train, valid, test) sizes); every recipe keeps
# its own widths, only the epochs are cut to 2. AVEC2019: the public
# DAIC-WOZ session counts; POM: its published split
FAMILIES = {
    "mosi_local": (["--dataset", "mosi_50", "--batch_size", "128",
                    "--time_len", "50", "--d_hiddens", "25-3-128=5-3-128",
                    "--d_outs", "25-3-128=5-3-128", "--loss", "MAE",
                    "--learning_rate", "4e-3", "--lr_decrease_iter", "9-60"],
                   (384, 128, 128)),
    "avec2019": (["--dataset", "avec2019", "--text", "text", "--audio", "mfcc",
                  "--video", "au", "--batch_size", "32", *CUBE_T100,
                  "--loss", "CCC", "--learning_rate", "1e-3",
                  "--bert_lr_rate", "0.01", "--lr_decrease_iter", "20-40"],
                 (163, 56, 56)),
    "pom_sdk": (["--dataset", "pom_SDK", "--text", "text", "--audio",
                 "covarep", "--video", "facet42", "--batch_size", "64",
                 *CUBE_T100, "--loss", "MAE", "--learning_rate", "2e-3",
                 "--bert_freeze", "no", "--bert_lr_rate", "0.01",
                 "--lr_decrease_iter", "25-45"], (600, 100, 203)),
}
# the canonical MOSI encoder (bi-GRU) swapped: an encoder's output on the
# card against the same weights on the CPU, both float32 (TF32 off): the
# CPU tests hold the port to JAX at this tolerance
ENCODER_CPU_TOL = 1e-4
# the axis MLP's six shapes at mosi_local.sh's widths (25-3-128=5-3-128 on
# [128, 50, 3, 128]), and the int8 products of one BERT-base layer at
# AVEC2019's M = 32 x 100
FAMILY_AXIS_MLP_SHAPES = [
    ((BATCH, 50, 3, 128), 1, 25, 25), ((BATCH, 25, 3, 128), 2, 3, 3),
    ((BATCH, 25, 3, 128), 3, 128, 128), ((BATCH, 25, 3, 128), 1, 5, 5),
    ((BATCH, 5, 3, 128), 2, 3, 3), ((BATCH, 5, 3, 128), 3, 128, 128)]
AVEC_ROWS = 32 * TIME_LEN


def card() -> str:
    """nvidia-smi's name and power limit of the card, for the records."""
    if not hasattr(card, "line"):
        card.line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return card.line


def family_launches(kind: str, raw: bool, use_pallas: bool, quant: str,
                    n: int = 1):
    """``step_launches`` of a recipe: without raw text there is no BERT,
    so neither attention nor int8 products."""
    c = step_launches(kind, use_pallas, quant, n)
    return c if raw else (0, 0, c[2], 0)


def family_data(root: str, family: str) -> str:
    """The recipe's synthetic dataset (the port's ``data/synthetic.py``) at
    its feature widths; every split's size is printed."""
    import os

    from mimrl_tpu_torch.data import synthetic

    data = f"{root}/family_data/{family}"
    n = FAMILIES[family][1]
    if not os.path.isdir(data):
        if family == "mosi_local":
            synthetic.make_local_fixture(data, "mosi_50", n, dims=(300, 5, 20),
                                         time_len=50, seed=3)
        elif family == "avec2019":  # up to 100 sentences a session
            synthetic.make_avec_fixture(data, n, d_mfcc=39, d_au=49,
                                        max_len=TIME_LEN + 1, seed=4)
        else:
            synthetic.make_sdk_fixture(data, "pom", n, d_text=300, d_audio=43,
                                       d_video=35, max_len=TIME_LEN + 1, seed=5)
        emit(phase="families", step="data", family=family,
             train=n[0], valid=n[1], test=n[2])
    return data


def family_argv(root: str, family: str, *extra) -> list:
    return FAMILY_COMMON + FAMILIES[family][0] + list(extra) + [
        "--data_dir", family_data(root, family)]


def family_run(root: str, name: str, argv, raw: bool, use_pallas=False,
               quant="none", epochs: int = 2):
    """``cli.main`` per batch with the counts set to 0 just before and
    read just after: launches against the steps the run took, finite
    scores, MI telemetry after epoch 0; host ms per step (a synchronise on
    each side), the train epoch's samples/s, peak memory. Returns (record,
    launches, the run's Solver)."""
    import numpy as np
    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = {k: [] for k in ("train_step", "critic_step", "eval_step",
                               "grad_debug_step")}
    info = dict(train_s=[])
    originals = {k: getattr(steps, k) for k in step_ms}
    solve, train = vars(Solver)["solve"], vars(Solver)["train"]

    def timed(k):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[k](*args, **kwargs)
            torch.cuda.synchronize()
            step_ms[k].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def keep_solver(self):
        info["solver"] = self
        return solve(self)

    def timed_train(self, epoch):
        t0 = time.perf_counter()
        out = train(self, epoch)
        info["train_s"].append(time.perf_counter() - t0)
        return out

    task = f"{root}/family_runs/{name}"
    full = list(argv) + ["--task_dir", f"{root}/family_runs",
                         "--task_name", name]
    zero_counts()
    t0 = time.perf_counter()
    with patched([(steps, k, timed(k)) for k in step_ms]
                 + [(Solver, "solve", keep_solver),
                    (Solver, "train", timed_train)]):
        scores = cli_main(full)
    wall = time.perf_counter() - t0
    launches = counts()
    attention_instances(name, launches)
    solver = info.pop("solver")
    n = {k: len(v) for k, v in step_ms.items()}
    # a --check_gradient step (grad_debug_step) runs a forward, and a
    # backward that stops short of BERT: its launches are a critic step's
    want = add(*(family_launches(k.split("_")[0].replace("grad", "critic"),
                                 raw, use_pallas, quant, n[k])
                 for k in step_ms))
    require(launches == want, f"{name}: launches {launches} for {n} steps, "
            f"want {want} (order {KERNEL_NAMES})")
    nb = len(solver.train_loader)
    require(n["train_step"] == epochs * nb
            and n["critic_step"] == 2 * (epochs - 1) * nb,
            f"{name}: {n} steps for {nb} train batches")
    instances = (int8_instances(name, launches) if quant != "none"
                 else None)
    axis_instances = (axis_mlp_instances(name, launches) if use_pallas
                      else None)
    require(scores[0] is not None and all(
        np.isfinite(v) for s in scores for v in s.values()),
        f"{name}: non-finite best scores {scores}")
    rows = [json.loads(r) for r in open(f"{task}/scalars.jsonl")]
    require(all(np.isfinite(r["value"]) for r in rows),
            f"{name}: non-finite scalars " + str([
                (r["step"], r["tag"], r["value"]) for r in rows
                if not np.isfinite(r["value"])][:10]))
    mi = [r["value"] for r in rows if r["step"] == 1
          and r["tag"].startswith("Train/MI_")]
    log = open(f"{task}/Running.log").read()
    line = next(x for x in log.splitlines() if "Parameters: " in x)
    require((", bert 0, " in line) != raw, f"{name}: {line}")
    require(epochs == 1 or len(mi) == 8 and any(v != 0.0 for v in mi),
            f"{name}: epoch 1 MI channels {mi}")
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    events_ms = cuda_ms(lambda: steps.train_step(
        solver.model, solver.opt_main, solver.opt, mb, labels, solver.bank,
        solver.new_bank, 0, solver.generator, True), 2, 5)
    n_train = len(solver.train_loader.ds)
    record = dict(
        phase="families", step=name, card=card(),
        launches=dict(zip(KERNEL_NAMES, launches)),
        steps=n, int8_instances=instances, axis_mlp_instances=axis_instances,
        parameters=line.split("Parameters: ")[1], best_valid=scores[0],
        wall_s=wall, train_s=info["train_s"],
        # the last epoch's steps; the first epoch's warmed them up
        train_step_ms_median=statistics.median(step_ms["train_step"][-nb:]),
        critic_step_ms_median=(statistics.median(step_ms["critic_step"][nb:])
                               if epochs > 1 else None),
        eval_batch_ms_median=statistics.median(step_ms["eval_step"]),
        train_step_events_ms=events_ms,
        train_epoch_samples_per_s=n_train / info["train_s"][-1],
        stage2_samples_per_s=n_train / (1e-3 * sum(step_ms["train_step"][-nb:])),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return record, launches, solver


def family_serve(name: str, task: str, raw: bool, use_pallas=False,
                 quant="none"):
    """``Predictor`` on the run's ``best_valid`` slot: the test split's
    launches (the counts set to 0 just before it), its metrics, samples/s
    after a warm-up pass. Returns (metrics, samples/s, launches)."""
    import numpy as np

    from mimrl_tpu_torch.eval.predict import Predictor

    predictor = Predictor(task)
    predictor.evaluate_split("test")  # warm-up
    n_batches = len(predictor.test_loader)
    zero_counts()
    t0 = time.perf_counter()
    metrics = predictor.evaluate_split("test")
    wall = time.perf_counter() - t0
    served = counts()
    attention_instances(f"{name} served", served)
    want = family_launches("eval", raw, use_pallas, quant, n_batches)
    require(served == want, f"{name}: Predictor launched {served}, want {want}")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"{name}: non-finite served metrics {metrics}")
    samples = len(predictor.test_loader.ds)
    del predictor
    return metrics, samples / wall, served


def checked_axis_mlp(errors):
    """Patches under which every axis-MLP kernel launch also runs its plain
    version on the same inputs and appends its ``rel_err``."""
    from mimrl_tpu_torch.ops import cubemlp_kernel as ck

    forward = ck._forward

    def checked(x, w1, w2, b1, b2, axis, activate):
        out = forward(x, w1, w2, b1, b2, axis, activate)
        errors.append(rel_err(out, ck.fused_axis_mlp_plain(
            x, w1, w2, b1, b2, axis, activate)))
        return out

    return ((ck, "_forward", checked),)


def checked_int8(seen):
    """Patches under which every int8 product of ``ops/quant.py`` also runs
    the plain version; each launch appends (M, K, N, bit-equal)."""
    import torch

    from mimrl_tpu_torch.ops import quant
    from mimrl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    def checked(a, b, sa, sb, out_dtype):
        out = int8_matmul(a, b, sa, sb, out_dtype)
        want = int8_matmul_plain(a, b, sa, sb, out_dtype)
        seen.append((a.shape[0], a.shape[1], b.shape[1],
                     bool(torch.equal(out, want))))
        return out

    return ((quant, "int8_matmul", checked),)


def profiled_ms(fn, kernel_name, tries=None):
    """``profiler_ms`` with up to three sessions, as ``int8_phase`` reads
    it: a session has come back without the kernel's records. The number
    of profiler runs it took is appended to ``tries``."""
    for tried in range(1, 4):
        ms = profiler_ms(fn, kernel_name)
        if ms is not None:
            break
    if tries is not None:
        tries.append(tried)
    return ms


def float32_attention_shape(bs: int, t: int) -> dict:
    """The float32 attention kernels at ``[bs, 12, t, 64]`` with dropout
    against their plain versions, on the tensor-core instances (required),
    timed by queued CUDA events and the profiler beside the SIMT
    instances, SDPA and the bound. Returns {kernel name: record}."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops import flash_attention as fa

    out = {}
    dtype = torch.float32
    q, k, v, bias = attention_inputs(bs, N_HEADS, t, HEAD_DIM, dtype,
                                     seed=bs + t - TIME_LEN)
    seed = torch.tensor([bs], device="cuda")
    d_out = torch.randn_like(q)
    shape = [bs, N_HEADS, t, HEAD_DIM]
    for kernel, backward in (("flash_attention_fwd", False),
                             ("flash_attention_bwd", True)):
        instance = fa._instance(dtype, t, HEAD_DIM, backward)
        if backward:
            err = max(rel_err(g, w) for g, w in zip(
                fa.flash_attention_bwd(q, k, v, bias, seed, d_out, DROPOUT_P),
                fa.flash_attention_bwd_plain(q, k, v, bias, seed, d_out,
                                             DROPOUT_P)))
            qq, kk, vv = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias)
            times = timings(
                lambda: fa.flash_attention_bwd(q, k, v, bias, seed, d_out, 0.0),
                lambda: fa.flash_attention_bwd(q, k, v, bias, seed, d_out,
                                               DROPOUT_P),
                lambda: fa.flash_attention_bwd_plain(q, k, v, bias, seed,
                                                     d_out, 0.0),
                lambda: torch.autograd.grad(sdpa, (qq, kk, vv), d_out,
                                            retain_graph=True),
                kernel_symbol("bwd", instance, "float32"),
                *simt_timed(q, k, v, bias, seed, d_out))
            del sdpa, qq, kk, vv
            tol = BWD_TOL["float32"]
        else:
            err = rel_err(fa.flash_attention(q, k, v, bias, seed, DROPOUT_P),
                          fa.flash_attention_plain(q, k, v, bias, seed,
                                                   DROPOUT_P))
            times = timings(
                lambda: fa.flash_attention(q, k, v, bias),
                lambda: fa.flash_attention(q, k, v, bias, seed, DROPOUT_P),
                lambda: fa.flash_attention_plain(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=bias),
                kernel_symbol("fwd", instance, "float32"),
                *simt_timed(q, k, v, bias, seed))
            tol = KERNEL_TOL["float32"]
        require(err <= tol, f"{kernel} {shape} float32 with dropout: "
                f"relative error {err} > {tol}")
        require(instance == "tensor_core",
                f"{kernel} {shape} float32: instance {instance}")
        bound, by, fp32_pipes = attention_bound(q, bias, backward=backward)
        out[kernel] = dict(shape=shape, dtype="float32", instance=instance,
                           max_rel_err_dropout=err, bound_ms=bound,
                           bound_by=by, bound_ms_fp32_pipes=fp32_pipes,
                           **times)
    del q, k, v, bias, d_out
    return out


def family_kernel_shapes() -> dict:
    """The kernels at the slice's new shapes against their plain versions,
    timed (queued CUDA events and the profiler) beside the bound and the
    one-call PyTorch equivalent: attention forward and backward at AVEC's
    bs 32 and POM's bs 64 in float32 (the recipes' compute type: the
    tensor-core instances, timed beside the SIMT ones), with dropout; the
    axis MLP at mosi_local.sh's six shapes;
    the int8 products of a BERT-base layer at M 3200, forward and dw, bit
    for bit. Returns {kernel name: [records]}."""
    import math

    import torch

    from mimrl_tpu_torch.ops import cubemlp_kernel as ck
    from mimrl_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                 int8_matmul_plain, plan)

    out = {name: [] for name in KERNEL_NAMES}
    for bs in (32, 64):
        for name, rec in float32_attention_shape(bs, TIME_LEN).items():
            out[name].append(rec)

    sms = ck._sm_count(torch.device("cuda", 0))
    for shape, axis, d_hidden, d_out_ in FAMILY_AXIS_MLP_SHAPES:
        p = ck.plan(math.prod(shape[:axis]), shape[axis], d_hidden, d_out_,
                    math.prod(shape[axis + 1:]), sms)
        require(p.instance == AXIS_MLP_INSTANCE[axis],
                f"axis MLP {shape} axis {axis}: planned {p.instance}")
        args = axis_mlp_inputs(shape, axis, d_hidden, d_out_, True,
                               seed=sum(shape) + axis)
        err = rel_err(ck.fused_axis_mlp(*args, axis, "gelu"),
                      ck.fused_axis_mlp_plain(*args, axis, "gelu"))
        require(err <= AXIS_MLP_TOL,
                f"axis MLP {shape} axis {axis}: {err} > {AXIS_MLP_TOL}")
        bound, by, rate, _ = axis_mlp_bound(*args, axis)
        out["cubemlp_axis_mlp"].append(dict(
            shape=list(shape), axis=axis, d_hidden=d_hidden, d_out=d_out_,
            instance=p.instance, max_rel_err=err,
            ms=cuda_ms(lambda: ck.fused_axis_mlp(*args, axis, "gelu"), inner=20),
            profiler_ms=profiled_ms(lambda: ck.fused_axis_mlp(
                *args, axis, "gelu"), "axis_mlp_"),
            plain_ms=cuda_ms(lambda: ck.fused_axis_mlp_plain(
                *args, axis, "gelu"), inner=20),
            bound_ms=bound, bound_by=by, bound_rate=rate, library_ms=None))

    for role, (k_, n_) in [(r, s) for r in ("forward", "dw")
                           for s in INT8_LAYER_SHAPES]:
        m, k, n = (AVEC_ROWS, k_, n_) if role == "forward" else (k_, AVEC_ROWS, n_)
        dtype = torch.bfloat16 if role == "forward" else torch.float32
        a, b, sa, sb = int8_inputs(m, k, n, seed=m + k + n)
        p = plan(m, n, k, sms)
        got = int8_matmul(a, b, sa, sb, dtype)
        require(torch.equal(got, int8_matmul_plain(a, b, sa, sb, dtype)),
                f"int8 {role} {(m, k, n)}: differs from the plain version")
        require(p.instance == "wgmma", f"int8 {role} {(m, k, n)}: {p.instance}")
        bound, by = int8_bound(m, k, n, dtype)
        ms = cuda_ms(lambda: int8_matmul(a, b, sa, sb, dtype), inner=10)
        out["int8_matmul"].append(dict(
            role=role, shape=[m, k, n], instance=p.instance,
            stream_k=p.stream_k, grid=p.grid, bit_equal=True, ms=ms,
            profiler_ms=profiled_ms(lambda: int8_matmul(a, b, sa, sb, dtype), (
                "int8_matmul_wgmma_kernel", "int8_matmul_wgmma_reduce")),
            plain_ms=cuda_ms(lambda: int8_matmul_plain(a, b, sa, sb, dtype),
                             2, 5),
            library_ms=cuda_ms(lambda: (torch._int_mm(a, b).float() * sa
                                        * sb).to(dtype), inner=10),
            bound_ms=bound, bound_by=by, tops=2 * m * n * k / (1e-3 * ms) / 1e12))
    for name, recs in out.items():
        emit(phase="families", step="kernel_shapes", card=card(), kernel=name,
             shapes=recs)
    return out


def pipe_kernel_shapes() -> dict:
    """The attention kernels at the pipeline's microbatch shape, bf16
    ``[BATCH / PIPE_MICRO, 12, 100, 64]`` (the pipe case's units), forward
    and backward with and without dropout against their plain versions,
    timed as the kernel phase times them beside the bound and SDPA.
    Returns {kernel name: [records]} (the attention kernels only)."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops import flash_attention as fa

    bs, dtype = BATCH // PIPE_MICRO, torch.bfloat16
    q, k, v, bias = attention_inputs(bs, N_HEADS, TIME_LEN, HEAD_DIM, dtype,
                                     seed=bs + 1)
    seed = torch.tensor([bs], device="cuda")
    d_out = torch.randn_like(q)
    shape = [bs, N_HEADS, TIME_LEN, HEAD_DIM]
    out = {}
    for kernel, backward in (("flash_attention_fwd", False),
                             ("flash_attention_bwd", True)):
        instance = fa._instance(dtype, TIME_LEN, HEAD_DIM, backward)
        if backward:
            err = max(max(rel_err(g, w) for g, w in zip(
                fa.flash_attention_bwd(q, k, v, bias, seed, d_out, p),
                fa.flash_attention_bwd_plain(q, k, v, bias, seed, d_out, p)))
                for p in (0.0, DROPOUT_P))
            qq, kk, vv = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias)
            times = timings(
                lambda: fa.flash_attention_bwd(q, k, v, bias, seed, d_out, 0.0),
                lambda: fa.flash_attention_bwd(q, k, v, bias, seed, d_out,
                                               DROPOUT_P),
                lambda: fa.flash_attention_bwd_plain(q, k, v, bias, seed,
                                                     d_out, 0.0),
                lambda: torch.autograd.grad(sdpa, (qq, kk, vv), d_out,
                                            retain_graph=True),
                kernel_symbol("bwd", instance, "bfloat16"))
            del sdpa, qq, kk, vv
            tol = BWD_TOL["bfloat16"]
        else:
            err = max(rel_err(fa.flash_attention(q, k, v, bias, seed, p),
                              fa.flash_attention_plain(q, k, v, bias, seed, p))
                      for p in (0.0, DROPOUT_P))
            times = timings(
                lambda: fa.flash_attention(q, k, v, bias),
                lambda: fa.flash_attention(q, k, v, bias, seed, DROPOUT_P),
                lambda: fa.flash_attention_plain(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=bias),
                kernel_symbol("fwd", instance, "bfloat16"))
            tol = KERNEL_TOL["bfloat16"]
        require(err <= tol, f"{kernel} {shape} bfloat16: relative error "
                f"{err} > {tol}")
        require(instance == "tensor_core",
                f"{kernel} {shape} bfloat16: instance {instance}")
        bound, by, _ = attention_bound(q, bias, backward=backward)
        out[kernel] = [dict(shape=shape, dtype="bfloat16", instance=instance,
                            max_rel_err=err, bound_ms=bound, bound_by=by,
                            **times)]
        emit(phase="kernel", step="pipe_shape", card=card(), kernel=kernel,
             **out[kernel][0])
    return out


def families_phase(root: str):
    """The slice's recipes end to end on the card (see the module's
    docstring); returns the launch counts of its counted runs together."""
    import copy

    import numpy as np
    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.universal import get_data_loader
    from mimrl_tpu_torch.eval.metrics import calc_metrics_pom
    from mimrl_tpu_torch.models.encoders import lengths_from_sequence
    from mimrl_tpu_torch.ops import quant
    from mimrl_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from mimrl_tpu_torch.train import steps

    totals = []
    runs = f"{root}/family_runs"

    # 1. mosi_local.sh: dense text, no BERT; without and with --use_pallas
    for use_pallas in (False, True):
        name = "mosi_local" + ("_pallas" if use_pallas else "")
        argv = family_argv(root, "mosi_local",
                           *(["--use_pallas"] if use_pallas else []))
        record, launches, solver = family_run(root, name, argv, False,
                                              use_pallas)
        totals.append(launches)
        require(not any(n.startswith("bertmodel.")
                        for n in solver.model.state_dict()),
                f"{name}: the dense-text model holds BERT parameters")
        if use_pallas:  # every axis-MLP launch of one forward, checked
            errors = []
            mb, labels, _ = solver._prep(next(iter(solver.valid_loader)))
            with patched(checked_axis_mlp(errors)):
                steps.eval_step(solver.model, solver.opt, mb, labels,
                                solver.bank, solver.generator, True)
            require(len(errors) == 6 and max(errors) <= AXIS_MLP_TOL,
                    f"{name}: axis-MLP launches vs plain {errors}")
            record.update(axis_mlp_launch_rel_err=errors, tol=AXIS_MLP_TOL)
        del solver
        metrics, sps, c = family_serve(name, f"{runs}/{name}", False,
                                       use_pallas)
        totals.append(c)
        emit(**record, served=metrics, serve_samples_per_s=sps)

    # 2. avec2019.sh: CCC selection, random words per pass
    name = "avec2019"
    argv = family_argv(root, name)
    record, launches, solver = family_run(root, name, argv, True)
    totals.append(launches)
    rows = [json.loads(r) for r in open(f"{runs}/{name}/scalars.jsonl")]
    val_ccc = [r["value"] for r in rows if r["tag"] == "Val/ccc"]
    require(len(val_ccc) == 2 and record["best_valid"]["ccc"] == max(val_ccc),
            f"{name}: best valid {record['best_valid']} is not the epoch of "
            f"the largest valid CCC {val_ccc}")
    errors = {"fwd": [], "bwd": []}  # every attention launch of a step
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    with patched(checked_launches(errors)):
        steps.train_step(solver.model, solver.opt_main, solver.opt, mb,
                         labels, solver.bank, solver.new_bank, 0,
                         solver.generator, True)
    torch.cuda.synchronize()
    require(len(errors["fwd"]) == 12 and len(errors["bwd"]) == 12
            and max(errors["fwd"]) <= KERNEL_TOL["float32"]
            and max(errors["bwd"]) <= BWD_TOL["float32"],
            f"{name}: attention launches of a train step vs plain {errors}")
    # the stacked epochs of --epoch_scan hold the per-batch loader's words
    twin = get_data_loader(solver.opt, solver.tokenizer)[0]
    stacks = []
    for p in range(2):
        solver.train_loader.passes = p
        stacks.append(solver._stack_epoch(solver.train_loader)[0][
            "bert_sentences"].cpu())
        want = np.stack([b["bert_sentences"] for b in twin])
        require(np.array_equal(stacks[-1].numpy(), want),
                f"{name}: pass {p}'s stacked tokens differ from the loader's")
    require(not torch.equal(*stacks), f"{name}: both passes drew one text")
    record.update(attention_launches_checked=len(errors["fwd"]) * 2,
                  attention_fwd_rel_err_max=max(errors["fwd"]),
                  attention_bwd_rel_err_max=max(errors["bwd"]),
                  tokens_changed=float((stacks[0] != stacks[1]).float().mean()))
    del solver
    metrics, sps, c = family_serve(name, f"{runs}/{name}", True)
    totals.append(c)
    emit(**record, served=metrics, serve_samples_per_s=sps)

    # one float32 train step under --use_pallas --quant int8, dropout 0:
    # the int8 kernel against its plain version, bit for bit
    results, seen = {}, []
    for route, patches in (("kernels", checked_int8(seen)),
                           ("plain_int8", ((quant, "int8_matmul",
                                            int8_matmul_plain),))):
        cfg = parse_args(argv + ["--use_pallas", "--quant", "int8"]).replace(
            compute_dtype="float32", bert_dropout=0.0, dropout=[0.0] * 4,
            dropout_mlp=[0.0] * 3, task_name=f"avec_quant_{route}",
            task_dir=runs, save_models=False)
        results[route] = recorded_train_step(cfg, patches)
    (l_k, o_k, g_k, c_k), (l_i, o_i, g_i, _) = results.values()
    require(c_k == family_launches("train", True, True, "int8"),
            f"avec quant step: launches {c_k}")
    tables = [n for n in g_k if "embeddings" in n and "LayerNorm" not in n]
    unequal = [n for n in g_k if n not in tables
               and not torch.equal(g_k[n], g_i[n])]
    table_gap = max(rel_err(g_k[n], g_i[n]) for n in tables)
    ms_seen = sorted({m for m, _, _, _ in seen})
    require(l_k == l_i and torch.equal(o_k, o_i) and not unequal
            and table_gap <= EMBEDDING_GRAD_TOL and all(e for *_, e in seen)
            and AVEC_ROWS in ms_seen and len(seen) == c_k[3],
            f"avec quant step: the int8 kernel changed the step (loss {l_k} "
            f"vs {l_i}, {unequal[:3]}, tables {table_gap}, M {ms_seen})")
    emit(phase="families", step="avec2019_quant_route_check", card=card(),
         loss=l_k,
         int8_launches_checked=len(seen), int8_m=ms_seen,
         bit_equal_gradients=len(g_k) - len(tables),
         embedding_tables_rel_diff=table_gap)
    del results

    # 3. pom_sdk.sh: the POM battery
    name = "pom_sdk"
    record, launches, solver = family_run(root, name, family_argv(root, name),
                                          True)
    totals.append(launches)
    battery = set(calc_metrics_pom(np.arange(4.0), np.arange(4.0)[::-1]))
    require(set(record["best_valid"]) == battery,
            f"{name}: scores {sorted(record['best_valid'])}, want {battery}")
    del solver
    metrics, sps, c = family_serve(name, f"{runs}/{name}", True)
    totals.append(c)
    emit(**record, served=metrics, serve_samples_per_s=sps)

    # 4. the canonical recipe with the other two encoders, 1 epoch each
    for encoder in ("lstm", "conv"):
        name = f"canonical_{encoder}"
        argv = CANONICAL_MOSI + CANONICAL_TRAIN + [
            "--encoders", encoder, "--epochs_num", "1",
            "--save_latest_every", "0", "--data_dir", f"{root}/train_data"]
        record, launches, solver = family_run(root, name, argv, True,
                                              epochs=1)
        totals.append(launches)
        # the encoders on the card against the same weights on the CPU
        batch = next(iter(solver.valid_loader))
        gaps = {}
        for mod in ("audio", "video"):
            enc = getattr(solver.model, ("conv_" if encoder == "conv" else
                                         "rnn_") + mod[0]).eval()
            x = torch.from_numpy(batch[mod])
            with torch.no_grad():
                outs = [e(x.to(dev)) if encoder == "conv" else
                        e(x.to(dev), lengths_from_sequence(x.to(dev)))
                        for e, dev in ((enc, "cuda"),
                                       (copy.deepcopy(enc).cpu(), "cpu"))]
            gaps[mod] = (outs[0].cpu() - outs[1]).abs().max().item()
        require(max(gaps.values()) <= ENCODER_CPU_TOL,
                f"{name}: the encoders on the card vs the CPU {gaps}")
        del solver
        metrics, sps, c = family_serve(name, f"{runs}/{name}", True)
        totals.append(c)
        emit(**record, encoder_card_vs_cpu=gaps, tol=ENCODER_CPU_TOL,
             served=metrics, serve_samples_per_s=sps)

    # 5. --epoch_scan: mosi_local.sh with the LSTM and avec2019.sh, graphs
    # (G) against eager (E) with a second eager run (E2) as the control.
    # AVEC in float32, as its recipe runs: a float32 run repeats on the card
    # (the token-type lookup sums its gradient in a fixed order), so G, E
    # and E2 must be equal bit for bit
    for family, extra, raw in (
            ("mosi_local", ["--encoders", "lstm"], False),
            ("avec2019", [], True)):
        argv = family_argv(root, family, "--epoch_scan", "--no_save_models",
                           *extra)
        g = rung_run(runs, f"{family}_scan_graphs", argv)
        e = rung_run(runs, f"{family}_scan_eager", argv, graphs=False)
        e2 = rung_run(runs, f"{family}_scan_eager2", argv, graphs=False,
                      timed=False)
        n_train, n_valid, n_test = FAMILIES[family][1]
        bs = int(argv[argv.index("--batch_size") + 1])
        nb = -(-n_train // bs)
        n_eval = -(-n_valid // bs) + -(-n_test // bs)
        want = add(family_launches("train", raw, False, "none", 2 * nb),
                   family_launches("eval", raw, False, "none", 2 * n_eval),
                   family_launches("critic", raw, False, "none", 2 * nb))
        for r in (g, e):
            require(r["launches"] == want, f"{family} rung: launches "
                    f"{r['launches']}, want {want}")
        passed, gate = gap_gate(g["tensors"], e["tensors"], e2["tensors"])
        steps_ms = {k: statistics.median(v[1:]) for k, v in g["step_ms"].items()
                    if len(v) > 1}
        eager_ms = {k: statistics.median(v[1:]) for k, v in e["step_ms"].items()
                    if len(v) > 1}
        emit(phase="families", step=f"{family}_scan", card=card(), flags=extra,
             graphs_vs_eager=gate, gate_passed=passed,
             tensors_compared=len(e["tensors"]),
             launches=dict(zip(KERNEL_NAMES, g["launches"])),
             step_ms_graphs=steps_ms, step_ms_eager=eager_ms,
             epoch_s_graphs=g["epoch_s"], epoch_s_eager=e["epoch_s"],
             peak_gb_graphs=g["peak_gb"], peak_gb_eager=e["peak_gb"],
             graphs=g["graphs"])
        require(passed, f"{family} rung: graphs vs eager {gate}")
        require(family != "avec2019" or (gate["bit_equal"]
                                         and not gate["unstable"]),
                f"{family} float32 rung: G, E and E2 not bit-equal {gate}")
        totals.append(g["launches"])
        del g, e, e2
    return add(*totals)


# ---------------------------------------------------------------------- #
# The eleventh slice: a float32 run repeats on the card; the transformer,
# TFN and MoE fusions; --custom_loss, --check_gradient and --profile_dir.

# the fusions against the CPU on the same weights and batch rows: the
# whole model's eval forward (relative to the largest output entry), and a
# train step's fusion-parameter gradients with the fusion's input and the
# gradient reaching its output held fixed (grad_gap's rule)
FUSION_CPU_TOL = 1e-4
FUSION_GRAD_TOL = 1e-3
FUSION_CPU_ROWS = 16  # batch rows of the CPU forward (rows do not interact)
# the fifth configuration of BASELINE.json sweeps the bounds with the
# fusions: TFN with CLUB; the transformer with NWJ diverges in its second
# critic step (nwj_divergence), in an estimator the fusion does not feed,
# so the gated transformer run takes the recipe's InfoNCE
FUSIONS = (("transformer", "infonce"), ("tfn", "club"), ("moe", "infonce"))
VMI_ORDER = ("f_t", "f_a", "f_v", "t_a", "t_v", "ac_t", "ta_c", "vc_t",
             "tv_c", "tc_a", "tc_v")
HOOK_TOL = 1e-5
HOOK_SPEC = "mimrl_tpu_torch.train.custom:feature_decorrelation"


def f32_argv(argv) -> list:
    """The canonical argv as the README's quick start runs it: float32 (no
    ``--compute_dtype``)."""
    i = argv.index("--compute_dtype")
    return argv[:i] + argv[i + 2:]


def two_step_state(cfg, lookup=None) -> dict:
    """A fresh ``Solver`` for ``cfg`` and two eager ``train_step``s on the
    first train batch, dropout on (without MI, then with MI on the bank the
    first wrote); returns ``slot_tensors`` of its state. ``lookup``
    replaces BERT's token-type lookup (the fault control)."""
    import torch

    from mimrl_tpu_torch.models import bert
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    patches = [] if lookup is None else [(bert, "_rows_in_fixed_order", lookup)]
    with patched(patches):
        solver = Solver(cfg)
        mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
        for use_mi in (False, True):
            steps.train_step(solver.model, solver.opt_main, cfg, mb, labels,
                             solver.bank, solver.new_bank, 0, solver.generator,
                             use_mi)
            solver.bank.copy_(solver.new_bank)
        torch.cuda.synchronize()
    names = {id(p): n for n, p in solver.model.named_parameters()}
    opt_names = {k: [names[id(p)] for p in getattr(solver, k).params]
                 for k in ("opt_main", "opt_vmi")}
    state = {k: v.cpu() for k, v in
             slot_tensors(solver._snapshot(0), opt_names).items()}
    solver.writer.close()
    del solver
    gc.collect()
    torch.cuda.empty_cache()
    return state


def determinism_check(argv) -> None:
    """Two float32 runs of one seed, each a fresh ``Solver`` and two eager
    ``train_step``s of the canonical recipe with dropout on, must be bit for
    bit equal in every parameter, optimizer moment, bank field and
    generator state. BERT's token-type table is looked up by a chain of
    ``torch.where``, whose backward sums in a fixed order; the same two
    runs with ``nn.Embedding``'s lookup in its place are stated beside it
    (its CUDA backward sums the 12,800 positions of one type in an order
    that may change from run to run)."""
    import torch.nn.functional as F

    from mimrl_tpu_torch.core.config import parse_args

    base = parse_args(f32_argv(argv)).replace(save_models=False)
    runs = [two_step_state(base.replace(task_name=f"repeat_{i}"))
            for i in range(2)]
    gaps = differing(runs[1], runs[0])
    control = [two_step_state(base.replace(task_name=f"embedding_{i}"),
                              lambda table, ids: F.embedding(ids, table))
               for i in range(2)]
    emit(phase="train", step="float32_determinism", card=card(),
         tensors_compared=len(runs[0]), differing=gaps,
         bit_equal=not gaps,
         embedding_lookup_differing=differing(control[1], control[0]),
         embedding_lookup_tensors_differing=sum(
             not control[1][k].equal(v) for k, v in control[0].items()))
    require(not gaps, f"two float32 runs of one seed differ: {gaps}")


def fusion_checks(solver, name: str) -> dict:
    """The fusion of a trained run on the card against the CPU, the same
    weights and batch: the whole model's eval forward on FUSION_CPU_ROWS
    rows of a valid batch; and one ``train_step``'s fusion-parameter
    gradients (fusion dropout 0), recomputed on the CPU from the fusion's
    input and the gradient that reached its output in that step. Then
    device times by the profiler: three ``train_step``s with MI, and the
    fusion's forward and backward alone at the step's shape."""
    import copy

    import torch

    from mimrl_tpu_torch.models.model import forward_batch
    from mimrl_tpu_torch.train import steps

    model, enc = solver.model, solver.model.mlp_encoder
    batch, _, _ = solver._prep(next(iter(solver.valid_loader)))
    rows = {k: v[:FUSION_CPU_ROWS] for k, v in batch.items()}
    cpu = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.no_grad():
        card = forward_batch(model, rows)
        host = forward_batch(cpu, {k: v.cpu() for k, v in rows.items()})
    del cpu
    forward_gap = max(rel_err(c.cpu(), h) for c, h in zip(card, host))

    # one train step, with the fusion's dropout at 0
    for m in enc.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    held = {}

    def keep_io(module, inputs, output):
        held["x"] = inputs[0].detach().cpu()
        output.register_hook(lambda g: held.__setitem__("g", g.detach().cpu()))

    names = {id(p): n for n, p in model.named_parameters()}
    weights = {n: p.detach().cpu().clone() for n, p in enc.named_parameters()}
    grads, step = {}, solver.opt_main.step

    def recording_step(gs):
        grads.update({names[id(p)]: g.detach().cpu().clone()
                      for p, g in zip(solver.opt_main.params, gs)})
        return step(gs)

    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    hook = enc.register_forward_hook(keep_io)
    solver.opt_main.step = recording_step
    try:
        steps.train_step(model, solver.opt_main, solver.opt, mb, labels,
                         solver.bank, solver.new_bank, 0, solver.generator,
                         True)
    finally:
        del solver.opt_main.step  # the class's method again
        hook.remove()
    host_enc = copy.deepcopy(enc).cpu().train()
    host_enc.load_state_dict(weights)
    host_enc(held["x"]).backward(held["g"])
    want = {f"mlp_encoder.{n}": p.grad for n, p in host_enc.named_parameters()}
    gap = grad_gap({n: grads[n] for n in want}, want)

    def three_steps():
        for _ in range(3):
            steps.train_step(model, solver.opt_main, solver.opt, mb, labels,
                             solver.bank, solver.new_bank, 0,
                             solver.generator, True)

    x = held["x"].to(solver.device).requires_grad_()
    cot = held["g"].to(solver.device)

    def fusion_alone():
        enc(x).backward(cot)

    step_prof = profiled_steps(three_steps, 3)
    fusion_prof = profiled_steps(fusion_alone, 1)
    enc.zero_grad(set_to_none=True)
    busy, fusion_busy = (step_prof["device_busy_ms"],
                         fusion_prof["device_busy_ms"])
    record = dict(
        forward_rel_err=forward_gap, forward_tol=FUSION_CPU_TOL,
        cpu_rows=FUSION_CPU_ROWS, grads_vs_cpu=gap, grad_tol=FUSION_GRAD_TOL,
        fusion_parameters=len(want),
        fusion_input_shape=list(held["x"].shape),
        train_step_profile=step_prof, fusion_fwd_bwd_profile=fusion_prof,
        fusion_share_of_train_step=(fusion_busy / busy
                                    if busy and fusion_busy else None))
    require(forward_gap <= FUSION_CPU_TOL,
            f"{name}: the card's eval forward vs the CPU's {forward_gap}")
    require(gap["worst"][0]["rel_diff"] <= FUSION_GRAD_TOL,
            f"{name}: fusion gradients on the card vs the CPU {gap['worst']}")
    return record


def nwj_divergence(root: str) -> None:
    """The transformer fusion with ``--bound_type nwj`` (BASELINE.json's
    pairing), stated and not gated: each critic step's eleven weighted
    losses, the first step with a non-finite one and its estimators, and
    the run's non-finite scalars. NWJ's marginal term is
    ``exp(logmeanexp(scores - 1))`` in both packages
    (``mimrl_tpu/mi/bounds.py:63-74``), which leaves float32's range at
    scores near 89."""
    import math

    import numpy as np
    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.models.model import MimrlModel

    seen = []
    stage1 = vars(MimrlModel)["compute_vmi_loss_stage1"]

    def recording(self, *args, **kwargs):
        mis, losses = stage1(self, *args, **kwargs)
        seen.append(torch.stack(losses).detach())
        return mis, losses

    name, runs = "fusion_transformer_nwj", f"{root}/family_runs"
    argv = f32_argv(CANONICAL_MOSI + CANONICAL_TRAIN) + [
        "--fusion", "transformer", "--bound_type", "nwj",
        "--no_save_models", "--save_latest_every", "0",
        "--data_dir", f"{root}/train_data", "--task_dir", runs,
        "--task_name", name]
    with patched([(MimrlModel, "compute_vmi_loss_stage1", recording)]):
        cli_main(argv)
    losses = torch.stack(seen).cpu().tolist()
    bad = [i for i, row in enumerate(losses)
           if not all(math.isfinite(v) for v in row)]
    rows = [json.loads(r) for r in open(f"{runs}/{name}/scalars.jsonl")]
    emit(phase="fusions", step="transformer_nwj", card=card(), gated=False,
         critic_losses=[dict(zip(VMI_ORDER, row)) for row in losses],
         first_non_finite_step=bad[0] if bad else None,
         non_finite_estimators=([VMI_ORDER[j] for j, v in enumerate(
             losses[bad[0]]) if not math.isfinite(v)] if bad else []),
         non_finite_scalars=[(r["step"], r["tag"]) for r in rows
                             if not np.isfinite(r["value"])])


def fusions_phase(root: str):
    """The transformer, TFN and MoE fusions at the canonical recipe's full
    width in float32 (the README's compute type; default widths: 2 layers,
    4 heads, 4 experts, top 2; fusion dropout 0.1), each through
    ``cli.main`` for 2 epochs and served by ``Predictor`` from its
    ``best_valid`` slot; ``fusion_checks`` on each; then
    ``nwj_divergence``. Returns the launch counts of the gated runs and
    their serving together."""
    totals = []
    for fusion, bound in FUSIONS:
        name = f"fusion_{fusion}"
        argv = f32_argv(CANONICAL_MOSI + CANONICAL_TRAIN) + [
            "--fusion", fusion, "--bound_type", bound,
            "--dropout_mlp", "0.1-0.1-0.1", "--save_latest_every", "0",
            "--data_dir", f"{root}/train_data"]
        record, launches, solver = family_run(root, name, argv, True)
        totals.append(launches)
        require(type(solver.model.mlp_encoder).__name__.lower().startswith(
            fusion), f"{name}: {type(solver.model.mlp_encoder).__name__}")
        record.update(fusion_checks(solver, name), phase="fusions",
                      bound_type=bound)
        del solver
        metrics, sps, c = family_serve(name, f"{root}/family_runs/{name}",
                                       True)
        totals.append(c)
        emit(**record, served=metrics, serve_samples_per_s=sps)
        gc.collect()
    nwj_divergence(root)
    gc.collect()
    return add(*totals)


def hooks_phase(root: str):
    """A 2-epoch run of the canonical recipe with ``--custom_loss``
    (``feature_decorrelation``), ``--check_gradient`` and ``--profile_dir``:
    the check-gradient blocks (every non-BERT parameter after each of epoch
    1's critic and train steps) finite; the trace of epoch 1 chrome-trace
    JSON with CUDA kernel events; and an eval step's loss with the hook
    minus the loss without it equal to the hook's value. Returns the
    run's launch counts."""
    import json as _json
    import math
    import os

    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.custom import load_custom_loss

    name, prof = "hooks", f"{root}/hooks_profile"
    argv = CANONICAL_MOSI + CANONICAL_TRAIN + [
        "--custom_loss", HOOK_SPEC, "--check_gradient", "--profile_dir", prof,
        "--no_save_models", "--save_latest_every", "0",
        "--data_dir", f"{root}/train_data"]
    record, launches, solver = family_run(root, name, argv, True)
    require(record["steps"]["grad_debug_step"] == 9,
            f"{name}: {record['steps']} check-gradient steps, want 9")
    log = open(f"{root}/family_runs/{name}/Running.log").read().splitlines()
    params = sorted(n for n, _ in solver.model.named_parameters()
                    if "bert" not in n)
    lines = [x.split("-->")[1] for x in log if "-->" in x]
    values = [float(x.split(": ")[1]) for x in lines
              if x.startswith(("para: ", "grad_value: "))]
    named = [x[len("name: "):] for x in lines if x.startswith("name: ")]
    require(named == params * 9 and len(values) == 2 * len(named)
            and all(math.isfinite(v) for v in values),
            f"{name}: {len(named)} check-gradient blocks, want 9 x "
            f"{len(params)} finite ones")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    require(len(traces) == 1, f"{name}: trace files {os.listdir(prof)}")
    events = _json.load(open(f"{prof}/{traces[0]}"))["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    require(kernels > 0 and any(f"Profiler trace written to {prof}" in x
                                for x in log),
            f"{name}: the trace holds {kernels} CUDA kernel events")
    # each built-in hook's value is what it adds to a loss; the run's
    # feature_decorrelation is below the loss's last place on these
    # features, l2_output's is well above it and must be added once
    mb, labels, _ = solver._prep(next(iter(solver.valid_loader)))
    plain = steps.eval_step(solver.model, solver.opt, mb, labels, solver.bank,
                            solver.generator, False)
    hooks = {}
    for spec in (HOOK_SPEC, "mimrl_tpu_torch.train.custom:l2_output"):
        fn = load_custom_loss(spec, solver.opt)
        hooked = steps.eval_step(solver.model, solver.opt, mb, labels,
                                 solver.bank, solver.generator, False,
                                 custom_loss=fn)
        value = fn(plain[2], labels, plain[3]).item()
        hooks[spec.split(":")[1]] = dict(
            value=value, loss=hooked[0].item(), loss_without=plain[0].item(),
            gap=abs(hooked[0].item() - plain[0].item() - value))
    l2 = hooks["l2_output"]
    require(all(h["value"] > 0 and h["gap"] <= HOOK_TOL
                for h in hooks.values())
            and l2["loss"] != l2["loss_without"] and l2["gap"] < l2["value"] / 10,
            f"{name}: the losses with and without the hooks {hooks}")
    del solver
    # the hook inside the captured steps of --epoch_scan (3 epochs), with
    # epoch 1, whose critic steps are captured, under the profiler
    scan_prof = f"{root}/hooks_scan_profile"
    scan = rung_run(f"{root}/rung_runs", "hooks_scan",
                    CANONICAL_MOSI + CANONICAL_TRAIN + RUNG_ARGS + [
                        "--epoch_scan", "--custom_loss", HOOK_SPEC,
                        "--profile_dir", scan_prof,
                        "--data_dir", f"{root}/train_data"])
    values = scan["tensors"]["last_epoch_values"]
    require(scan["launches"] == rung_launches("scan", False, "none")
            and bool(values.isfinite().all())
            and any(f.endswith(".pt.trace.json") for f in os.listdir(scan_prof)),
            f"{name}: the hook on --epoch_scan: launches {scan['launches']}, "
            f"last epoch {values.tolist()}, trace {os.listdir(scan_prof)}")
    record.update(phase="hooks")
    emit(**record, check_gradient_blocks=len(named),
         parameters_per_block=len(params), trace_file=traces[0],
         trace_bytes=os.path.getsize(f"{prof}/{traces[0]}"),
         trace_kernel_events=kernels, hooks=hooks, hook_tol=HOOK_TOL, scan_graphs=scan["graphs"],
         scan_last_epoch_values=values.tolist(),
         scan_launches=dict(zip(KERNEL_NAMES, scan["launches"])))
    gc.collect()
    return add(launches, scan["launches"])


# ---------------------------------------------------------------------- #
# The group phase: --epoch_group against the per-epoch --epoch_scan path.

# 5 epochs: epoch 0 on the per-epoch path, then the groups 1-2 and 3-4; the
# milestone at epoch 2 cuts the rate inside the first group
GROUP = 2
GROUP_ARGS = ["--epochs_num", "5", "--epoch_scan", "--lr_decrease_iter",
              "2-60", "--save_latest_every", "0"]
# patience 0: the rate halves after any epoch whose valid loss does not
# improve. On an H100 80GB HBM3 at 700 W avec2019.sh's valid loss rose in
# epoch 2 (0.355, then 0.447), so its pair decays inside and across groups
# (the canonical recipe's fell in each of 5 epochs: no decay there)
GROUP_PLATEAU = ["--lr_decrease", "plateau", "--lr_decrease_iter", "0",
                 "--lr_decrease_rate", "0.5"]
# the measurement pair: 7 epochs, epochs 3-4 timed dispatch to dispatch
# (no capture in them), epochs 5-6 profiled from a drained queue
GROUP_TIMED = ["--epochs_num", "7"]
GROUP_PROFILED = 5
MOSI_SPLIT = (1284, 229, 686)  # CMU-MOSI's train / valid / test split
# mosi_local.sh's pair: epochs 3-10 timed (four groups), 11-12 profiled
LOCAL_EPOCHS = 13


def nested_tensors(state, prefix="") -> tuple:
    """({path: tensor on the CPU}, {path: other value}) of a nested dict."""
    tensors, values = {}, {}
    for k, v in state.items():
        path = f"{prefix}{k}"
        if hasattr(v, "is_floating_point"):
            tensors[path] = v.detach().cpu()
        elif isinstance(v, dict):
            t, o = nested_tensors(v, path + ".")
            tensors.update(t)
            values.update(o)
        else:
            values[path] = v
    return tensors, values


def run_decisions(task: str) -> list:
    """Per epoch, whether the run logged a better valid and a better test
    score before the epoch's line."""
    out, now = [], [False, False]
    for line in open(f"{task}/Running.log"):
        if "Better valid score found" in line:
            now[0] = True
        elif "Better test score found" in line:
            now[1] = True
        elif "Epoch:[" in line:
            out.append(now)
            now = [False, False]
    return out


def instrumented(fn, profile_from=None, patches=()):
    """Run ``fn()`` (a training entry point) with the counts set to 0 just
    before and read just after, torch's sync debug mode on, and the
    Solver's dispatches and host halves wrapped: per dispatch (an epoch of
    the per-epoch path, or a group) its launches and the host
    synchronisations inside it (sync-debug warnings); the one-copy waits
    of the run (``_Fetch.wait``), the seconds the run logged per epoch,
    peak memory, the final state and the slots it saved (kept in memory:
    ``CheckpointManager.save`` is intercepted), the scalars, the
    better-epoch decisions and the best epochs' feature pickles. With ``profile_from`` = e: the device's busy
    ms and idle share over epochs e and e + 1, from a drained queue at
    e's dispatch to the last operation of e + 1's (the profiler)."""
    import os
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.core.checkpoint import CheckpointManager
    from mimrl_tpu_torch.train import solver as solver_mod
    from mimrl_tpu_torch.train.solver import Solver

    Fetch = solver_mod._Fetch
    orig = {k: vars(Solver)[k] for k in (
        "solve", "_epoch_scan_dispatch", "_dispatch_epoch_group", "_log_epoch")}
    orig_wait = vars(Fetch)["wait"]
    info = dict(dispatch=[], epoch_s={}, waits=0, slots={})
    window = {}

    def solve(self):
        info["solver"] = self
        return orig["solve"](self)

    def with_syncs(call):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = call()
        return out, sum("synchroniz" in str(w.message) for w in seen)

    def wrap_dispatch(key, grouped):
        def dispatch(self, *args):
            epoch, g = args[0], (args[1] if grouped else 1)
            if epoch == profile_from:
                torch.cuda.synchronize()
                window["profile"] = profile(activities=[ProfilerActivity.CUDA])
                window["profile"].start()
                window["start"] = torch.cuda.Event(enable_timing=True)
                window["start"].record()
            c0 = counts()
            out, n = with_syncs(lambda: orig[key](self, *args))
            info["dispatch"].append(dict(epoch=epoch, g=g, syncs=n,
                                         launches=sub(counts(), c0)))
            if profile_from is not None and epoch + g - 1 == profile_from + 1:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize()
                window["profile"].stop()
                span = window["start"].elapsed_time(end)
                busy = device_busy_ms(window["profile"])[0]
                info["profile"] = dict(
                    epochs=[profile_from, profile_from + 1], span_ms=span,
                    busy_ms=busy if busy else None,
                    idle_share=1 - busy / span if busy else None)
            return out
        return dispatch

    def log_epoch(self, epoch, dt, *args, **kwargs):
        info["epoch_s"][epoch] = dt
        return orig["_log_epoch"](self, epoch, dt, *args, **kwargs)

    def wait(self):
        info["waits"] += 1
        return orig_wait(self)

    def save(self, name, state):
        info["slots"][name] = nested_tensors(state)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with patched([(Solver, "solve", solve),
                      (Solver, "_epoch_scan_dispatch",
                       wrap_dispatch("_epoch_scan_dispatch", False)),
                      (Solver, "_dispatch_epoch_group",
                       wrap_dispatch("_dispatch_epoch_group", True)),
                      (Solver, "_log_epoch", log_epoch),
                      (Fetch, "wait", wait),
                      (CheckpointManager, "save", save), *patches]):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    info.update(wall_s=time.perf_counter() - t0, launches=counts(),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    attention_instances("group", info["launches"])
    solver = info.pop("solver")
    task = solver.task_path
    info["final"] = nested_tensors(solver._snapshot(solver.opt.epochs_num - 1))
    info["scalars"] = open(f"{task}/scalars.jsonl").read()
    info["decisions"] = run_decisions(task)
    # the best epochs' eval features (--save_best_features), as written
    info["features"] = {}
    for name in ("features_val", "features_test", "features_test_for_valid"):
        if os.path.exists(f"{task}/{name}.pkl"):
            with open(f"{task}/{name}.pkl", "rb") as f:
                info["features"][name] = f.read()
    info["lr"] = [json.loads(r)["value"] for r in info["scalars"].splitlines()
                  if json.loads(r)["tag"] == "Lr"]
    info["passes"] = [getattr(solver, k).passes for k in (
        "train_loader", "valid_loader", "test_loader")]
    info["task"] = task
    del solver
    return info


def group_gate(got: dict, want: dict) -> tuple:
    """Bit-equality of two runs: the final state, every slot saved, the
    scalars, the better-epoch decisions, the best epochs' features (the
    pickles' bytes) and the loaders' passes. Returns (passed, the first
    differences)."""
    import torch

    diffs = []
    for part in ("final", *sorted(set(got["slots"]) | set(want["slots"]))):
        a, b = got["slots"].get(part), want["slots"].get(part)
        if part == "final":
            a, b = got["final"], want["final"]
        if a is None or b is None:
            diffs.append(f"{part}: missing")
            continue
        if a[0].keys() != b[0].keys() or a[1] != b[1]:
            diffs.append(f"{part}: other entries or values")
            continue
        diffs += [f"{part}.{k}" for k, v in b[0].items()
                  if v.dtype != a[0][k].dtype or not torch.equal(a[0][k], v)]
    for key in ("scalars", "decisions", "features", "passes"):
        if got[key] != want[key]:
            diffs.append(key)
    return not diffs, diffs[:8]


def group_pair(name: str, argv, records: list, patches_g=(), bert=True,
               **kwargs):
    """The per-epoch run (P) and the grouped run (G) of ``argv``: G must
    equal P bit for bit (``group_gate``), launch per group exactly
    ``GROUP`` times P's launches of an epoch with stage 1 (with BERT, at
    least one attention launch an epoch), and synchronise the host inside
    no dispatch after its first group. Returns (P, G)."""
    from mimrl_tpu_torch.cli.main import main as cli_main

    p = instrumented(lambda: cli_main(argv + ["--task_name", f"{name}_p"]),
                     **kwargs)
    g = instrumented(lambda: cli_main(argv + [
        "--epoch_group", str(GROUP), "--task_name", f"{name}_g"]),
        patches=patches_g, **kwargs)
    passed, diffs = group_gate(g, p)
    per_epoch = [d["launches"] for d in p["dispatch"]]
    epoch_launches = per_epoch[1]
    groups = [d for d in g["dispatch"] if d["g"] > 1]
    later = [d["syncs"] for d in groups[1:]]
    record = dict(
        phase="group", step=name, gate_passed=passed, differing=diffs,
        tensors_compared=len(p["final"][0]) + sum(
            len(s[0]) for s in p["slots"].values()),
        slots=sorted(p["slots"]), features=sorted(p["features"]),
        decisions=g["decisions"], lr=g["lr"],
        launches_per_epoch=dict(zip(KERNEL_NAMES, epoch_launches)),
        launches_per_group=[d["launches"] for d in groups],
        launches_total=dict(zip(KERNEL_NAMES, g["launches"])),
        syncs_per_dispatch_p=[d["syncs"] for d in p["dispatch"]],
        syncs_per_dispatch_g=[d["syncs"] for d in g["dispatch"]],
        waits_p=p["waits"], waits_g=g["waits"],
        dispatches_g=[d["g"] for d in g["dispatch"]],
        epoch_s_p=p["epoch_s"], epoch_s_g=g["epoch_s"],
        wall_s_p=p["wall_s"], wall_s_g=g["wall_s"],
        peak_gb_p=p["peak_gb"], peak_gb_g=g["peak_gb"],
        profile_p=p.get("profile"), profile_g=g.get("profile"), card=card())
    records.append(record)
    emit(**record)
    require(passed, f"group {name}: grouped vs per-epoch differ in {diffs}")
    require(len(p["features"]) == (3 if "--save_best_features" in argv
                                   else 0),
            f"group {name}: feature pickles {sorted(p['features'])}")
    require(all(c == epoch_launches for c in per_epoch[1:])
            and all(d["launches"] == tuple(GROUP * x for x in epoch_launches)
                    for d in groups)
            and g["dispatch"][0]["launches"] == per_epoch[0]
            and (sum(epoch_launches[:2]) > 0) == bert,
            f"group {name}: launches per group {record['launches_per_group']}"
            f", per epoch {per_epoch}")
    require(groups and not any(later),
            f"group {name}: host synchronisations inside a dispatch {later}")
    return p, g


def group_readings(name: str, p: dict, g: dict, timed) -> None:
    """The readings of a pair: epoch seconds dispatch to dispatch over the
    ``timed`` epochs (no capture in them) and their medians, host
    synchronisations inside the dispatches, the one-copy waits of each
    run (per epoch 3: train, valid, test; per group 1; with
    ``--save_best_features`` 2 more at the end), the device's busy ms and
    idle share over the two profiled epochs (from a drained queue), peak
    memory."""
    p_s = [p["epoch_s"][e] for e in timed]
    g_s = [g["epoch_s"][e] for e in timed]
    emit(phase="group", step="readings", workload=name, card=card(),
         epochs_timed=list(timed), epoch_s_per_epoch=p_s, epoch_s_grouped=g_s,
         median_epoch_s_per_epoch=statistics.median(p_s),
         median_epoch_s_grouped=statistics.median(g_s),
         host_syncs_per_epoch=[d["syncs"] for d in p["dispatch"]][1:],
         host_syncs_per_group=[d["syncs"] for d in g["dispatch"]
                               if d["g"] > 1][1:],
         waits_per_epoch_run=p["waits"], waits_grouped_run=g["waits"],
         dispatches_grouped=len(g["dispatch"]),
         profiled_epochs=p["profile"]["epochs"],
         idle_share_per_epoch=p["profile"]["idle_share"],
         idle_share_grouped=g["profile"]["idle_share"],
         busy_ms_per_epoch=p["profile"]["busy_ms"],
         busy_ms_grouped=g["profile"]["busy_ms"],
         span_ms_per_epoch=p["profile"]["span_ms"],
         span_ms_grouped=g["profile"]["span_ms"],
         peak_gb_per_epoch=p["peak_gb"], peak_gb_grouped=g["peak_gb"])


def group_phase(root: str):
    """``--epoch_group 2`` against the per-epoch ``--epoch_scan`` path at
    full width (``group_pair``): the canonical bf16 recipe on the rungs'
    384/128/128 split for 7 epochs with ``--save_best_features`` and its
    readings (``group_readings``), and a reversed selection rule that the
    gate must catch; the flagged recipe (``--use_pallas --quant int8``,
    all four kernels) for 5 epochs; AVEC2019 (``avec2019.sh``, float32,
    CCC) under the plateau schedule (on the device) for 5 epochs, whose
    rate must decay; ``mosi_local.sh`` (no BERT: the epoch boundary weighs
    most) at MOSI's 1284/229/686 split for 13 epochs with its readings. Then ``tools/parity.py`` at MOSI's
    canonical shapes for 5 epochs in groups of 2 and per epoch, and
    ``--compare`` of the grouped report. Returns the launch counts of the
    grouped runs."""
    import math
    import os

    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.data import synthetic
    from mimrl_tpu_torch.tools import parity
    from mimrl_tpu_torch.train import steps

    data, runs = f"{root}/train_data", f"{root}/group_runs"
    if not os.path.isdir(data):
        synthetic.make_dec_fixture(
            data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH), d_audio=5,
            d_video=20, max_len=TIME_LEN + 1, seed=1)
    base = CANONICAL_MOSI + CANONICAL_TRAIN + GROUP_ARGS + ["--data_dir", data]

    def argv(name, *flags):
        return base + list(flags) + ["--task_dir", runs, "--task_name", name]

    records, grouped = [], []
    canonical = (*GROUP_TIMED, "--save_best_features")
    p, g = group_pair("canonical", argv("canonical", *canonical), records,
                      profile_from=GROUP_PROFILED)
    grouped.append(g["launches"])
    group_readings("canonical", p, g, range(3, 5))
    better = steps.selection_better

    def reversed_rule(sel, new, best):
        return better("acc" if sel == "mae" else "mae", new, best)

    fault = instrumented(lambda: cli_main(argv(
        "canonical_fault", *canonical, "--epoch_group", str(GROUP))),
        patches=[(steps, "selection_better", reversed_rule)])
    fault_passed, fault_diffs = group_gate(fault, g)
    emit(phase="group", step="fault_reversed_selection",
         gate_passed=fault_passed, differing=fault_diffs,
         decisions=fault["decisions"])
    require(not fault_passed, "group gate: a reversed selection rule passed it")
    del fault, p, g
    _, g = group_pair("quant", argv("quant", *QUANT_FLAGS), records)
    grouped.append(g["launches"])
    int8_instances("group quant", g["launches"])
    axis_mlp_instances("group quant", g["launches"])
    del g
    avec = family_argv(root, "avec2019", "--epochs_num", "5", "--epoch_scan",
                       *GROUP_PLATEAU, "--task_dir", runs)
    _, g = group_pair("avec2019_f32_plateau", avec, records)
    grouped.append(g["launches"])
    require(min(g["lr"]) < max(g["lr"]),
            f"group avec2019_f32_plateau: no plateau decay, rates {g['lr']}")
    del g
    # mosi_local.sh (dense text, no BERT: none of the four kernels; a 7.8
    # ms replayed train step) at MOSI's split: 11 train batches of 128
    local = f"{root}/group_local"
    synthetic.make_local_fixture(local, "mosi_50", MOSI_SPLIT,
                                 dims=(300, 5, 20), time_len=50, seed=3)
    local_argv = (FAMILY_COMMON + FAMILIES["mosi_local"][0]
                  + ["--data_dir", local, "--task_dir", runs, "--epoch_scan",
                     "--epochs_num", str(LOCAL_EPOCHS)])
    p, g = group_pair("mosi_local", local_argv, records, bert=False,
                      profile_from=LOCAL_EPOCHS - 2)
    grouped.append(g["launches"])
    group_readings("mosi_local", p, g, range(3, LOCAL_EPOCHS - 2))
    del p, g

    # tools/parity.py at MOSI's split sizes, 5 epochs in groups of 2 and per
    # epoch: samples/s (the median epoch after the first), and --compare
    reports = {}
    for key, group in (("g2_e5", GROUP), ("g1_e5", 1)):
        out = f"{root}/parity_{key}.json"
        args = ["--synthetic", "--full_scale", "--allow_hermetic",
                "--epochs_num", "5", "--epoch_group", str(group),
                "--light_artifacts", "--task_dir", f"{root}/parity",
                "--task_name", key, "--out", out]
        info = instrumented(lambda: parity.main(args))
        with open(out) as f:
            doc = json.load(f)
        scores = [v for name in ("best_valid_score", "best_test_score",
                                 "test_score_at_best_valid")
                  for v in doc[name].values()]
        channels = doc["mi_channels"]
        require(all(map(math.isfinite, scores)) and len(channels) == 24
                and all(len(v) == 5 and all(map(math.isfinite, v))
                        for v in channels.values())
                and math.isfinite(doc["samples_per_sec"]),
                f"parity {key}: scores, MI channels or samples/s")
        reports[key] = dict(out=out, doc=doc, info=info)
        if group == GROUP:
            grouped.append(info["launches"])
    g, p = reports["g2_e5"]["info"], reports["g1_e5"]["info"]
    per_epoch = p["dispatch"][1]["launches"]
    require([d["launches"] for d in g["dispatch"] if d["g"] > 1]
            == [tuple(GROUP * x for x in per_epoch)] * 2,
            "parity: launches of the groups against the per-epoch run's")
    main_out = reports["g2_e5"]["out"]
    same = parity.main(["--compare", main_out, main_out])
    bad = json.loads(json.dumps(reports["g2_e5"]["doc"]))
    bad["test_score_at_best_valid"]["mae"] *= 1.05
    bad_path = f"{root}/parity_bad.json"
    with open(bad_path, "w") as f:
        json.dump(bad, f)
    try:
        parity.main(["--compare", main_out, bad_path])
        code = 0
    except SystemExit as stop:
        code = stop.code
    require(same["pass"] and code == 1,
            f"parity --compare: with itself {same['pass']}, perturbed exit "
            f"{code}")
    emit(phase="group", step="parity", card=card(),
         samples_per_sec={k: v["doc"]["samples_per_sec"]
                          for k, v in reports.items()},
         wall_time_sec={k: v["doc"]["wall_time_sec"]
                        for k, v in reports.items()},
         epoch_s={k: v["info"]["epoch_s"] for k, v in reports.items()},
         host_syncs={k: [d["syncs"] for d in v["info"]["dispatch"]]
                     for k, v in reports.items()},
         test_score_at_best_valid=reports["g2_e5"]["doc"][
             "test_score_at_best_valid"],
         mi_channels=len(reports["g2_e5"]["doc"]["mi_channels"]),
         scores_equal_g2_g1=reports["g2_e5"]["doc"][
             "test_score_at_best_valid"]
         == reports["g1_e5"]["doc"]["test_score_at_best_valid"],
         compare_self_pass=same["pass"], compare_perturbed_exit=code,
         peak_gb={k: v["info"]["peak_gb"] for k, v in reports.items()})
    torch.cuda.empty_cache()
    return add(*grouped)


# ---------------------------------------------------------------------- #
# The mi_bank phase: the batched estimator bank (--fused_estimators) and
# the audio/video pair (--fused_av_scan), both on by default; and the
# standalone phase: mi/standalone.py's calibration sweep.

BANK_TOL = dict(rtol=2e-5, atol=1e-6)  # JAX's limits for the fused bank
BANK_GRAD_TOL = dict(rtol=5e-5, atol=1e-6)
BANK_CASES = (("infonce", "separate", "constant"),
              ("tuba", "separate", "unnormalized"))
UNFUSED = ["--unfused_estimators", "--unfused_av_scan"]
BANK_PROFILE_CALLS = 10
AV_REPS = 10


def bank_model(bound, critic, baseline):
    """The canonical model's estimator bank (d_common 128, fused features
    128 wide, hidden 256, embed 128) on the card, seeded; the rest of the
    model is cut to dense text of width 8, which the bank never reads."""
    import torch

    from mimrl_tpu_torch.models.model import MimrlModel, init_weights

    with torch.device("meta"):
        m = MimrlModel(d_a=5, d_v=20, d_common=128, d_t=8, raw_text=False,
                       time_len=TIME_LEN, d_hiddens=((50, 3, 128), (10, 3, 128)),
                       d_outs=((50, 3, 128), (10, 3, 128)), bound_type=bound,
                       critic_type=critic, baseline_type=baseline,
                       fused_estimators=True)
    m = m.to_empty(device="cpu")
    init_weights(m, torch.Generator().manual_seed(3))
    return m.cuda()


def bank_inputs(seed: int):
    """Labels, (F, T, A, V) and the six kNN triples at bs 128: features
    drawn on the card, the triples by the port's sampler from a bank of 384
    random rows (k_neighbor 2, radius 1)."""
    import torch

    from mimrl_tpu_torch.train import steps

    g = torch.Generator("cuda").manual_seed(seed)
    feats = [torch.randn(BATCH, 128, device="cuda", generator=g)
             for _ in range(4)]
    labels = torch.randn(BATCH, device="cuda", generator=g)
    bank = steps.FeatureBank(N_TRAIN, N_TRAIN, 128, device="cuda")
    for t in bank.tensors()[:5]:
        t.copy_(torch.randn(t.shape, device="cuda", generator=g))
    knn = steps.sample_all_knn(g, bank, BATCH, 2, 1.0)
    return labels, feats, knn


def bank_values(model, fused: bool, labels, feats, knn):
    """Both stages' values and the stage-1 gradients by parameter name."""
    import torch

    model.fused_estimators = fused
    names = [n for n, _ in model.named_parameters()
             if n.startswith(("vmi_", "vcmi_"))]
    params = dict(model.named_parameters())
    mis1, losses1 = model.compute_vmi_loss_stage1(labels, *feats, knn)
    grads = torch.autograd.grad(sum(losses1), [params[n] for n in names])
    mis2, losses2 = model.compute_vmi_loss_stage2(labels, *feats, knn)
    values = dict(mis1=torch.stack(mis1), losses1=torch.stack(losses1),
                  mis2=torch.stack(mis2), losses2=torch.stack(losses2))
    return ({k: v.detach() for k, v in values.items()},
            dict(zip(names, grads)))


def close_record(got, want, tol) -> dict:
    """Whether every element of ``got`` is within ``tol`` of ``want``
    (numpy's allclose rule), the largest absolute error, and the largest
    error over the tolerance."""
    import torch

    err = (got.double() - want.double()).abs()
    room = tol["atol"] + tol["rtol"] * want.double().abs()
    return dict(ok=bool((err <= room).all()), max_abs_err=err.max().item(),
                worst_over_tol=(err / room).max().item())


def bank_gate(model, labels, feats, knn, patches=()) -> dict:
    """The batched bank (under ``patches``) against the sequential one on
    the same weights and inputs: values at JAX's limits (BANK_TOL),
    gradients at its gradient limits (BANK_GRAD_TOL), element by element."""
    with patched(patches):
        got, got_g = bank_values(model, True, labels, feats, knn)
    want, want_g = bank_values(model, False, labels, feats, knn)
    values = {k: close_record(got[k], want[k], BANK_TOL) for k in want}
    grads = {k: close_record(got_g[k], want_g[k], BANK_GRAD_TOL)
             for k in want_g}
    worst = max(grads.items(), key=lambda kv: kv[1]["worst_over_tol"])
    return dict(
        ok=all(r["ok"] for r in values.values())
        and all(r["ok"] for r in grads.values()),
        values=values, gradients_compared=len(grads),
        gradients_failed=[k for k, r in grads.items() if not r["ok"]][:8],
        gradient_max_abs_err=max(r["max_abs_err"] for r in grads.values()),
        gradient_worst=dict(name=worst[0], **worst[1]))


def swapped_stack():
    """The fault control: ``stack_linears`` with the first two estimators'
    first-layer weights swapped in the stack."""
    from mimrl_tpu_torch.mi import critics, estimators

    real = critics.stack_linears

    def swapped(modules):
        layers = real(modules)
        w, b = layers[0]
        order = [1, 0] + list(range(2, w.shape[0]))
        layers[0] = (w[order], b)
        return layers

    return [(critics, "stack_linears", swapped),
            (estimators, "stack_linears", swapped)]


def bank_profile(model, labels, feats, knn) -> dict:
    """Device busy ms and kernel launches of the bank's stage-1 forward,
    and of the forward with the backward of its summed losses, per call,
    batched against sequential (profiler, BANK_PROFILE_CALLS calls each);
    and the same by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = [p for n, p in model.named_parameters()
              if n.startswith(("vmi_", "vcmi_"))]

    def forward():
        return model.compute_vmi_loss_stage1(labels, *feats, knn)[1]

    def both():
        torch.autograd.grad(sum(forward()), params)

    out = {}
    for fused in (True, False):
        model.fused_estimators = fused
        for name, fn in (("forward", forward), ("forward_backward", both)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(BANK_PROFILE_CALLS):
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = device_busy_ms(prof)[0]
            kernels = sum(e.count for e in rows
                          if "memcpy" not in e.key.lower()
                          and "memset" not in e.key.lower())
            key = f"{'batched' if fused else 'sequential'}_{name}"
            out[key] = dict(
                busy_ms=busy / BANK_PROFILE_CALLS if busy else None,
                launches=kernels / BANK_PROFILE_CALLS if rows else None,
                events_ms=cuda_ms(fn, 2, 10))
    model.fused_estimators = True
    return out


def eager_steps(solver) -> dict:
    """Eager ``train_step`` (with MI) and ``critic_step`` of a Solver by
    CUDA events (median of 10 after 2 warm-up runs)."""
    from mimrl_tpu_torch.train import steps

    o, gen = solver.opt, solver.generator
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))
    solver.model.train()
    return dict(
        train_step_ms=cuda_ms(lambda: steps.train_step(
            solver.model, solver.opt_main, o, mb, labels, solver.bank,
            solver.new_bank, 0, gen, True), 2, 10),
        critic_step_ms=cuda_ms(lambda: steps.critic_step(
            solver.model, solver.opt_vmi, o, mb, labels, solver.bank, gen),
            2, 10))


def profiled_eager_steps(solver) -> dict:
    """Three eager train steps under the profiler (busy, span, idle
    share)."""
    from mimrl_tpu_torch.train import steps

    o = solver.opt
    mb, labels, _ = solver._prep(next(iter(solver.train_loader)))

    def three():
        for _ in range(3):
            steps.train_step(solver.model, solver.opt_main, o, mb, labels,
                             solver.bank, solver.new_bank, 0,
                             solver.generator, True)

    return profiled_steps(three, 3)


def step_comparison(root: str) -> tuple:
    """The canonical bf16 recipe's steps with the default flags and with
    ``--unfused_estimators --unfused_av_scan``: two Solvers (``--epoch_scan``,
    so each has its step graphs) on one seeded random bank; one eager train
    and critic step of each counted first; then the eager steps by CUDA
    events in turns (default, unfused, unfused, default, default,
    unfused), three eager train steps of each under the profiler, and the
    replayed rung steps (``rung_profile``). Returns (the record, launches
    of the counted steps)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    data = f"{root}/train_data"
    if not os.path.isdir(data):
        make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                         d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
    argv = CANONICAL_MOSI + CANONICAL_TRAIN + [
        "--data_dir", data, "--task_dir", f"{root}/bank_runs",
        "--epoch_scan", "--no_save_models"]
    solvers = {}
    for name, flags in (("default", []), ("unfused", UNFUSED)):
        cfg = parse_args(argv + flags + ["--task_name", f"bank_{name}"])
        s = Solver(cfg)
        g = torch.Generator("cuda").manual_seed(5)
        for t in s.bank.tensors()[:5]:
            t.copy_(torch.randn(t.shape, device="cuda", generator=g))
        s.have_bank = True
        solvers[name] = s
    require(solvers["default"].model.fused_estimators
            and solvers["default"].model.fused_av_scan
            and not solvers["unfused"].model.fused_estimators
            and not solvers["unfused"].model.fused_av_scan,
            "the flags did not reach the model")
    launches = {}
    for name, s in solvers.items():
        o = s.opt
        mb, labels, _ = s._prep(next(iter(s.train_loader)))
        zero_counts()
        steps.train_step(s.model, s.opt_main, o, mb, labels, s.bank,
                         s.new_bank, 0, s.generator, True)
        steps.critic_step(s.model, s.opt_vmi, o, mb, labels, s.bank,
                          s.generator)
        torch.cuda.synchronize()
        launches[name] = counts()
        want = add(step_launches("train", False, "none"),
                   step_launches("critic", False, "none"))
        require(launches[name] == want,
                f"mi_bank {name}: launches {launches[name]}, want {want}")
        attention_instances(f"mi_bank {name}", launches[name])
    record = {f"eager_{name}": [] for name in solvers}
    for name in ("default", "unfused", "unfused", "default", "default",
                 "unfused"):
        record[f"eager_{name}"].append(eager_steps(solvers[name]))
    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's
        torch.ones(1, device="cuda").add_(1)  # first session starts slowly
        torch.cuda.synchronize()
    for name, s in solvers.items():
        record[f"profile_eager_{name}"] = profiled_eager_steps(s)
        record[f"replayed_{name}"] = rung_profile(s, "scan")
    for s in solvers.values():
        s.writer.close()
    del solvers
    gc.collect()
    torch.cuda.empty_cache()
    return record, add(*launches.values())


def av_inputs(seed: int):
    """Audio [128, 100, 5] and video [128, 100, 20] with ragged lengths
    (zero rows after each sample's own length, drawn per tower)."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    out = []
    for d in (5, 20):
        x = torch.randn(BATCH, TIME_LEN, d, device="cuda", generator=g)
        n = torch.randint(1, TIME_LEN + 1, (BATCH,), device="cuda",
                          generator=g)
        x = x * (torch.arange(TIME_LEN, device="cuda")[None, :]
                 < n[:, None])[..., None]
        out.append(x)
    return out


def av_pair_check() -> dict:
    """The canonical towers (2-layer bi-GRU, d_common 128, bs 128, T 100):
    ``run_pair`` on two streams against the two calls in turn, outputs and
    every parameter's gradient bit for bit; a pair fed each other's lengths
    (the fault control) must differ. Then the encoders' forward and
    backward by CUDA events with and without the streams (median of
    AV_REPS), and by the profiler: busy ms against span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.models.encoders import (BiRnnEncoder,
                                                 lengths_from_sequence,
                                                 run_pair)
    from mimrl_tpu_torch.models.model import init_weights

    encs = []
    for d in (5, 20):
        enc = BiRnnEncoder("gru", d, 128, 2)
        init_weights(enc, torch.Generator().manual_seed(d))
        encs.append(enc.cuda().train())
    a, v = av_inputs(11)
    la, lv = lengths_from_sequence(a), lengths_from_sequence(v)
    g = torch.Generator("cuda").manual_seed(12)
    d_a, d_v = (torch.randn(BATCH, TIME_LEN, 128, device="cuda", generator=g)
                for _ in range(2))
    params = [p for enc in encs for p in enc.parameters()]

    def step(pair, fault=False):
        if pair:
            oa, ov = run_pair(encs[0], a, lv if fault else la,
                              encs[1], v, la if fault else lv)
        else:
            oa, ov = encs[0](a, la), encs[1](v, lv)
        grads = torch.autograd.grad(
            (oa * d_a).sum() + (ov * d_v).sum(), params)
        return [oa.detach(), ov.detach(), *grads]

    want = step(False)
    got = step(True)
    fault = step(True, fault=True)
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(got, want))
    fault_equal = all(torch.equal(x, y) for x, y in zip(fault, want))
    record = dict(tensors=len(want), bit_equal=equal,
                  fault_swapped_lengths_equal=fault_equal)
    for name, pair in (("streams", True), ("one_stream", False),
                       ("one_stream_2", False), ("streams_2", True)):
        record[f"fwd_bwd_ms_{name}"] = cuda_ms(lambda: step(pair), 2, AV_REPS)
        step(pair)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                step(pair)
            end.record()
            torch.cuda.synchronize()
        busy, total = device_busy_ms(prof)
        record[f"profile_{name}"] = dict(
            busy_ms=busy / 3 if busy else None, kernel_sum_ms=total / 3,
            span_ms=start.elapsed_time(end) / 3)
    # the same on the device alone: each form captured in a CUDA graph
    # (the rungs' case: no host between the launches) and replayed
    for name, pair in (("streams", True), ("one_stream", False)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(pair)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(pair)
        record[f"graph_fwd_bwd_ms_{name}"] = cuda_ms(graph.replay, 3,
                                                     AV_REPS)
        del graph
    require(equal, "mi_bank: the A/V pair on two streams differs from the "
            "two calls in turn")
    require(not fault_equal, "mi_bank: the A/V pair's fault control (each "
            "tower given the other's lengths) passed the bit-equality gate")
    return record


def mi_bank_phase(root: str):
    """The batched bank against the sequential one at the canonical widths
    (InfoNCE with a separate critic, TUBA with an unnormalized baseline),
    with a stacking fault that the gate must catch; the bank's busy ms and
    launches batched against sequential; the canonical steps with the
    default flags against ``--unfused_estimators --unfused_av_scan``; the
    A/V pair. Returns the launches of its counted steps."""
    import torch

    for bound, critic, baseline in BANK_CASES:
        model = bank_model(bound, critic, baseline)
        require(model.vmi_groups == [["f_t", "f_a", "f_v", "t_a", "t_v"]]
                and len(model.cmi_groups) == 1, "mi_bank: the groups")
        labels, feats, knn = bank_inputs(7)
        gate = bank_gate(model, labels, feats, knn)
        fault = bank_gate(model, labels, feats, knn, swapped_stack())
        emit(phase="mi_bank", step=f"bank_{bound}", critic=critic,
             baseline=baseline, card=card(), gate=gate,
             fault_swapped_stack=dict(ok=fault["ok"],
                                      values=fault["values"]),
             profile=bank_profile(model, labels, feats, knn))
        require(gate["ok"], f"mi_bank {bound}: batched vs sequential "
                f"{gate['gradients_failed']} {gate['gradient_worst']}")
        require(not fault["ok"], f"mi_bank {bound}: the swapped stack "
                "passed the gate")
        del model
    record, launches = step_comparison(root)
    emit(phase="mi_bank", step="steps", card=card(), **record)
    emit(phase="mi_bank", step="av_pair", card=card(), **av_pair_check())
    gc.collect()
    torch.cuda.empty_cache()
    return launches


STANDALONE = dict(dim=5, n=2048, epochs=60, batch_size=256, lr=2e-3,
                  weight_decay=0.9, rhos=(0.7,))
# tests/test_bounds.py::test_gaussian_mi_recovery's seven cases:
# (bound, critic, baseline)
RECOVERY_CASES = (("infonce", "separate", "constant"),
                  ("nwj", "separate", "constant"),
                  ("js", "separate", "constant"),
                  ("smile", "concat", "constant"),
                  ("tuba", "separate", "unnormalized"),
                  ("mine", "separate", "constant"),
                  ("dv", "separate", "constant"))


def standalone_phase() -> None:
    """``mi/standalone.py`` on the card: ``run_sweep`` at rho 0.7 at the
    recovery settings of ``tests/test_bounds.py`` (dim 5, 2048 samples, 60
    epochs, bs 256, lr 2e-3, EMA 0.9, ``max``): each of its seven cases
    within (0.35, 2.5) x the true MI; ``js_fgan`` in (-1, 0.05]; CLUB
    with ``mean`` above 0.6 x the truth (``tests/test_fusion_club.py``);
    the fault control, an independent y, as that test checks it (CLUB,
    ``mean``, 30 epochs): below 0.4 and below 0.35 x the truth; InfoNCE's
    ``max`` on the independent y, stated. Wall seconds per bound."""
    import torch

    from mimrl_tpu_torch.mi import standalone

    true = standalone.rho_to_mi(5, 0.7)
    kw = {k: v for k, v in STANDALONE.items() if k != "rhos"}
    rows, failed = [], []
    for bound, critic, baseline in RECOVERY_CASES + (
            ("js_fgan", "separate", "constant"),):
        res = standalone.run_sweep([bound], STANDALONE["rhos"],
                                   critic_type=critic, baseline_type=baseline,
                                   estimation="max", seed=0, **kw)
        _, t, est, wall = res[bound][0]
        ok = bool(-1.0 < est <= 0.05 if bound == "js_fgan"
                  else 0.35 * t < est < 2.5 * t)
        rows.append(dict(bound=bound, critic=critic, baseline=baseline,
                         true_mi=t, estimate=est, wall_s=wall, ok=ok))
        failed += [] if ok else [bound]
    # CLUB, an upper bound, with the mean of the last epochs; then the
    # fault control, y independent of x, as tests/test_fusion_club.py
    # checks it (CLUB, mean, 30 epochs: below 0.4 and below 0.35 x the
    # truth); and InfoNCE's max on the independent y at the sweep's
    # settings, stated: with the same batches every epoch, each bound's
    # estimate on independent data climbs as the critic learns the pairs
    g = torch.Generator("cuda").manual_seed(1)
    x, y = standalone.sample_correlated_gaussian(g, 0.7, 5, 2048)
    y_ind = torch.randn(2048, 5, device="cuda", generator=g)
    train = dict(batch_size=256, lr=2e-3, weight_decay=0.9)
    for name, yy, estimation, bound, epochs in (
            ("club", y, "mean", "club", 60),
            ("independent_y", y_ind, "mean", "club", 30),
            ("independent_y_infonce", y_ind, "max", "infonce", 60)):
        t0 = time.perf_counter()
        est, _ = standalone.compute_mi(torch.Generator().manual_seed(2),
                                       "separate", "constant", bound, x, yy,
                                       estimation=estimation, epochs=epochs,
                                       **train)
        wall = time.perf_counter() - t0
        ok = {"club": est > 0.6 * true,
              "independent_y": abs(est) < 0.4 and est < 0.35 * true,
              "independent_y_infonce": None}[name]
        rows.append(dict(bound=name, estimation=estimation, epochs=epochs,
                         true_mi=true, estimate=est, wall_s=wall,
                         ok=None if ok is None else bool(ok)))
        failed += [] if ok in (None, True) else [name]
    emit(phase="standalone", card=card(), settings=STANDALONE, rows=rows)
    require(not failed, f"standalone: recovery gates failed for {failed}")


# ---------------------------------------------------------------------- #
# 14. mesh: the data-, tensor-, sequence- and expert-parallel mesh


def mesh_argv(data: str, *flags) -> list:
    return CANONICAL_MOSI + CANONICAL_TRAIN + ["--data_dir", data, *flags]


def mesh_inputs(seed: int = 0):
    """A seeded full-width batch (bs 128, T 100, the fixture's widths), its
    labels and a seeded bank of 3 batches' rows (d_common 128)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(BATCH, TIME_LEN)) > 0.2).astype(np.int64)
    mask[:, 0] = 1
    sample_mask = np.ones(BATCH, np.float32)
    sample_mask[-(BATCH // 16 + 1):] = 0.0  # cycle-padded rows
    batch = dict(
        bert_sentences=rng.integers(0, MESH_VOCAB, (BATCH, TIME_LEN)),
        bert_sentence_types=np.zeros((BATCH, TIME_LEN), np.int64),
        bert_sentence_att_mask=mask,
        audio=rng.normal(size=(BATCH, TIME_LEN, 5)).astype(np.float32),
        video=rng.normal(size=(BATCH, TIME_LEN, 20)).astype(np.float32),
        sample_mask=sample_mask)
    bank = dict(C=rng.normal(size=(3 * BATCH, 1)).astype(np.float32),
                **{f: rng.normal(size=(3 * BATCH, 128)).astype(np.float32)
                   for f in "FTAV"})
    return batch, rng.normal(size=BATCH).astype(np.float32), bank


def mesh_gate_args(case_flags) -> list:
    layers = PIPE_GATE_LAYERS if "--mesh_pipe" in case_flags else \
        MESH_GATE_LAYERS
    return ["--optm", "SGD", "--bert_layers", str(layers)]


def pipe_step_launches(pallas: bool, quant: str, remat: bool, layers: int,
                       stages: int, micro: int):
    """One pipe rank's launches in one critic_step + train_step: its
    layers' attention and int8 launches on each microbatch, the six axis
    MLPs of each forward on every rank, and under remat the backward's
    second forward of its layers."""
    per = layers // stages
    c = add(*(step_launches(kind, False, quant, micro, per)
              for kind in ("critic", "train")), (0, 0, 12 if pallas else 0, 0))
    if remat:
        c = add(c, step_launches("critic", False, quant, micro, per))
    return c


def mesh_gate_rank(rank, device, data, case_flags, variants, faults):
    """One rank of a case's equality gate: per variant, one critic_step +
    train_step at full width on the mesh against the unsharded step (and,
    on rank 0, the order-only control: check.split_batch_step, on a pipe
    mesh check.microbatch_step; both are kept for a variant that differs
    in its pipeline's schedule alone), every kernel launch of the mesh
    step held against its plain version; then the fault controls on the
    first variant. The seq_shard case's control is the larger of the row
    split's and ``check.ksplit_step``'s gaps (its arithmetic on one
    rank), each stated. Returns (rank 0) the readings."""
    import torch
    import torch.distributed as dist

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.models.model import build_model, init_weights
    from mimrl_tpu_torch.parallel import check
    from mimrl_tpu_torch.parallel.mesh import make_mesh

    batch, labels, bank = mesh_inputs()
    out, state, refs = {}, None, {}
    for name, flags in variants:
        cfg = parse_args(mesh_argv(data, *case_flags, *flags,
                                   *mesh_gate_args(case_flags)))
        if cfg.flash_attn == "auto":  # the Solver's rule on a mesh
            cfg = cfg.replace(flash_attn="off")
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, cfg.mesh_pipe,
                         cfg.mesh_dcn)
        if state is None or cfg.fusion != state[0]:
            model = build_model(cfg, MESH_VOCAB, 5, 20, "cpu")
            init_weights(model, torch.Generator().manual_seed(cfg.seed))
            state = (cfg.fusion, model.state_dict())
            del model
        args = (cfg, batch, labels, bank, 2 * BATCH, device)

        def build():
            return check.build(cfg, MESH_VOCAB, 5, 20, state[1], device)

        key = repr(cfg.replace(pipe_virtual=1, pipe_remat=False))
        if key not in refs:
            refs.clear()
            gc.collect()
            ref = check.one_step(build(), *args)
            control = None
            if rank == 0:
                start = {k: v.double() for k, v in state[1].items()}
                split = (check.microbatch_step if cfg.mesh_pipe > 1
                         else check.split_batch_step)
                control = check.relative_gaps(ref, split(build(), *args),
                                              start)
            if rank == 0 and cfg.seq_shard:
                # --seq_shard's order-only control: the row split or the
                # sequence-parallel arithmetic on one rank (the second
                # products' input axis in two blocks summed in float32),
                # whichever moves more
                ksplit = check.relative_gaps(
                    ref, check.ksplit_step(build(), *args), start)
                control = dict({k: max(v, ksplit[k])
                                for k, v in control.items()},
                               split=control, ksplit=ksplit)
            refs[key] = (ref, control)
        ref, control = refs[key]
        errors, axis_errors, int8_seen = {"fwd": [], "bwd": []}, [], []
        checks = (checked_launches(errors) + checked_axis_mlp(axis_errors)
                  + checked_int8(int8_seen))
        zero_counts()
        with patched(checks):
            gaps, _, _ = check.equality_gap(
                cfg, mesh, state[1], batch, labels, bank, 2 * BATCH,
                vocab=MESH_VOCAB, d_a=5, d_v=20, device=device,
                reference=ref, measure=check.relative_gaps)
        torch.cuda.synchronize(device)
        on = device if mesh.backend == "nccl" else "cpu"
        every = torch.zeros((mesh.n_ranks, 4), dtype=torch.int64, device=on)
        every[rank] = torch.tensor(counts(), device=on)
        dist.all_reduce(every)
        worst = torch.tensor([max(errors["fwd"], default=0.0),
                              max(errors["bwd"], default=0.0),
                              max(axis_errors, default=0.0),
                              float(not all(e for *_, e in int8_seen))],
                             dtype=torch.float64, device=on)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        out[name] = dict(gaps=gaps, control=control,
                         launches_per_rank=every.tolist(),
                         kernel_errors=dict(zip(
                             ("attention_fwd", "attention_bwd", "axis_mlp",
                              "int8_not_bit_equal"), worst.tolist())),
                         attention_dtype=str(cfg.compute_dtype),
                         flash_attn=cfg.flash_attn)
        if name == variants[0][0]:
            for fault, spec in faults.items():
                fgaps, _, _ = check.equality_gap(
                    cfg, mesh, state[1], batch, labels, bank, 2 * BATCH,
                    vocab=MESH_VOCAB, d_a=5, d_v=20, device=device,
                    reference=ref, faults=spec, measure=check.relative_gaps)
                out[f"fault_{fault}"] = dict(gaps=fgaps)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    refs.clear()
    return out


def mesh_read_rank(rank, device, argv):
    """One rank of a case's 2-epoch ``--epoch_scan`` run: its scores, epoch
    seconds (and over the epoch's train batches), launches, peak memory,
    and one eager train step after the run: its ms and the profiler's
    collective rows. Returns (rank 0) every rank's readings."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    epochs, box = [], {}
    finalize = vars(Solver)["_finalize_epoch"]

    def timed(self, tracking, epoch, dt, *args, **kwargs):
        epochs.append(dt)
        return finalize(self, tracking, epoch, dt, *args, **kwargs)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    with patched([(Solver, "_finalize_epoch", timed)]):
        solver = Solver(parse_args(argv), device=device)
        scores = solver.solve()
    torch.cuda.synchronize(device)
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    n_steps = len(solver.train_loader)
    batch = next(iter(solver.train_loader))
    mb, labels, _ = solver._prep(batch)

    def step():
        steps.train_step(solver.model, solver.opt_main, solver.opt, mb,
                         labels, solver.bank, solver.new_bank, 0,
                         solver.generator, True)
        torch.cuda.synchronize(device)

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        step_ms = 1e3 * (time.perf_counter() - t0)
    rows = [dict(name=e.key, calls=e.count,
                 host_ms=e.cpu_time_total / 1e3,
                 device_ms=getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()
            if any(w in e.key.lower() for w in ("all_reduce", "allreduce",
                                                  "gloo", "nccl"))]
    busy, _ = device_busy_ms(prof)
    mine = dict(rank=rank, scores=scores, epoch_s=epochs,
                ms_per_train_batch=[1e3 * dt / n_steps for dt in epochs],
                eager_step_ms=step_ms, **busy_readings(prof, busy),
                collective_rows=rows, launches=launches, peak_gb=peak_gb,
                graphs=solver.graphs.stats(),
                mesh=repr(solver.mesh))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def pipe_read_rank(rank, device, argv):
    """One rank of the pipe case's readings at 12 BERT layers: the Solver
    of the flags, then per schedule of PIPE_READ_SCHEDULES one eager
    train_step to warm up and one under the profiler: its ms, busy ms, the
    rows of the hops, the output's share over pipe, the gradient sums and
    gloo's all-reduces, launches, peak memory, and the ticks this rank
    computes and idles. Returns (rank 0) every rank's readings."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.parallel.mesh import PIPE_AXIS
    from mimrl_tpu_torch.parallel.pipeline import rank_ticks
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    solver = Solver(parse_args(argv), device=device)
    init_s = time.perf_counter() - t0
    mesh = solver.mesh
    batch = next(iter(solver.train_loader))
    mb, labels, _ = solver._prep(batch)

    def step():
        steps.train_step(solver.model, solver.opt_main, solver.opt, mb,
                         labels, solver.bank, solver.new_bank, 0,
                         solver.generator, True)
        torch.cuda.synchronize(device)

    mine = []
    for name, virtual, remat in PIPE_READ_SCHEDULES:
        mesh.set_pipeline(solver.opt.pipe_microbatches, virtual, remat)
        step()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step()
            step_ms = 1e3 * (time.perf_counter() - t1)
        launches = counts()
        rows = [dict(name=e.key, calls=e.count,
                     host_ms=e.cpu_time_total / 1e3,
                     device_ms=getattr(e, "device_time_total",
                                       getattr(e, "cuda_time_total", 0.0))
                     / 1e3)
                for e in prof.key_averages()
                if e.key.startswith("mimrl/") or any(
                    w in e.key.lower() for w in ("all_reduce", "allreduce"))]
        busy, _ = device_busy_ms(prof)
        ticks = rank_ticks(mesh.shape[PIPE_AXIS], mesh.n_microbatches,
                           virtual, mesh.coords[PIPE_AXIS])
        computed = sum(any(op[0] == "unit" for op in ops) for ops in ticks)
        mine.append(dict(
            rank=rank, schedule=name, virtual=virtual, remat=remat,
            microbatches=mesh.n_microbatches, eager_step_ms=step_ms,
            **busy_readings(prof, busy), rows=rows, launches=launches,
            peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
            ticks=len(ticks), ticks_computed=computed,
            ticks_idle=len(ticks) - computed, solver_init_s=init_s,
            mesh=repr(mesh), bert_layers=solver.opt.bert_layers))
    del solver
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def mesh_one_rank_nccl(data: str, runs: str):
    """A one-rank NCCL group on this card: the flagged recipe's 2-epoch
    ``--epoch_scan`` run on a one-rank mesh, whose step graphs capture the
    kernels with the mesh's NCCL collectives (the gradient average);
    returns its readings and launches."""
    import torch
    import torch.distributed as dist

    from mimrl_tpu_torch.cli.main import free_port
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.parallel.mesh import make_mesh
    from mimrl_tpu_torch.train.solver import Solver

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        argv = mesh_argv(data, "--flash_attn", "on", *QUANT_FLAGS,
                         *MESH_READ_ARGS, "--task_dir", runs,
                         "--task_name", "mesh_nccl1")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        epochs = []
        finalize = vars(Solver)["_finalize_epoch"]

        def timed(self, tracking, epoch, dt, *args, **kwargs):
            epochs.append(dt)
            return finalize(self, tracking, epoch, dt, *args, **kwargs)

        zero_counts()
        t0 = time.perf_counter()
        with patched([(Solver, "_finalize_epoch", timed)]):
            solver = Solver(parse_args(argv), mesh=mesh)
            scores = solver.solve()
        torch.cuda.synchronize()
        launches = counts()
        stats = solver.graphs.stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del solver
    finally:
        dist.destroy_process_group()
    require(mesh.backend == "nccl" and mesh.capturable, repr(mesh))
    require(all(all(v == v for v in s.values() if isinstance(v, float))
                for s in scores), f"one-rank NCCL run: scores {scores}")
    require(stats and all(g["replays"] >= 1 for g in stats.values()),
            f"one-rank NCCL run: graphs {stats}")
    return dict(wall_s=time.perf_counter() - t0, epoch_s=epochs,
                scores=scores, launches=launches, graphs=stats,
                peak_gb=peak_gb)


def mesh_group_rank(rank, device, data, root, cases):
    """One rank of a group of processes that runs ``cases`` (of one mesh
    shape): each case's gate, then its 2-epoch readings. Returns (rank 0)
    {case: {"gate": ..., "readings": [per rank]}}."""
    out = {}
    for case in cases:
        case_flags, variants = MESH_CASES[case]
        faults = CASE_FAULTS.get(case, {})
        t0 = time.perf_counter()
        gate = mesh_gate_rank(rank, device, data, case_flags, variants,
                              faults)
        gate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if case == "pipe":
            readings = pipe_read_rank(rank, device, mesh_argv(
                data, *case_flags, "--task_dir", f"{root}/runs",
                "--task_name", "mesh_pipe", "--no_save_models"))
        else:
            readings = mesh_read_rank(rank, device, mesh_argv(
                data, *case_flags, *MESH_READ_FLAGS.get(case, []),
                *MESH_READ_ARGS, "--task_dir", f"{root}/runs",
                "--task_name", f"mesh_{case}"))
        out[case] = dict(gate=gate, readings=readings, gate_s=gate_s,
                         readings_s=time.perf_counter() - t0)
        if case == "seq_shard":
            t0 = time.perf_counter()
            out[case]["memory"] = seq_memory_rank(rank, device, data, root, 2)
            out[case]["memory_s"] = time.perf_counter() - t0
    return out


def mesh_dropout_check() -> dict:
    """``parallel/mesh.py::Dropout`` on a split batch against ``F.dropout``
    of the whole batch on the card, from one generator state: each rank's
    rows (2 ranks) of the output and of the input gradient bit-equal, at
    the canonical step's dropout shapes and a CubeMLP input's permuted
    layout, bf16 and float32."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.parallel.mesh import Dropout, Mesh

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, perm in (((BATCH, TIME_LEN, 768), None),
                            ((BATCH, 128), None),
                            ((BATCH, 3, 128, 50), (0, 3, 1, 2))):
            g = torch.Generator("cuda").manual_seed(len(shape))
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            if perm is not None:
                x = x.permute(*perm)
            dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
            x.requires_grad_()
            state = torch.cuda.get_rng_state()
            want = F.dropout(x, DROPOUT_P, True)
            (want_dx,) = torch.autograd.grad(want, x, dy)
            half = BATCH // 2
            for rank in range(2):
                mesh = Mesh({"data": 2}, rank)
                mesh.set_batch(BATCH)
                drop = Dropout(DROPOUT_P)
                drop.mesh = mesh
                torch.cuda.set_rng_state(state)
                rows = slice(rank * half, (rank + 1) * half)
                got = drop(x[rows])
                (dx,) = torch.autograd.grad(got, x, dy[rows])
                require(torch.equal(got, want[rows])
                        and torch.equal(dx[rows], want_dx[rows]),
                        f"mesh Dropout {dtype} {shape} rank {rank}: not "
                        "F.dropout's rows")
            out[f"{str(dtype)[6:]}_{'x'.join(map(str, x.shape))}"] = float(
                (want != 0).float().mean())
    return out


def partial_sums_check() -> dict:
    """``models/bert.py::_PartialSums`` (the row-parallel products' bf16
    partial sums, returned in float32, under ``--seq_shard`` at model 2)
    against ``F.linear`` in float32 of the same bf16 values, at the
    attention output dense's and the FFN down-projection's shapes: the
    sums within PARTIAL_SUMS_TOL, both gradients within bf16's rounding
    (PARTIAL_SUMS_GRAD_TOL), each relative to the largest magnitude."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.models import bert

    out = {}
    for name, k in (("attention_output", 384), ("ffn_down", 1536)):
        g = torch.Generator("cuda").manual_seed(k)
        h = torch.randn(BATCH, TIME_LEN, k, device="cuda", generator=g)
        h = h.bfloat16().requires_grad_()
        w = (0.02 * torch.randn(768, k, device="cuda", generator=g)
             ).requires_grad_()
        dy = torch.randn(BATCH, TIME_LEN, 768, device="cuda", generator=g)
        y = bert._PartialSums.apply(h, w)
        hf = h.detach().float().requires_grad_()
        wf = w.detach().bfloat16().float().requires_grad_()
        yf = F.linear(hf, wf)

        def rel(got, want):
            return float((got.float() - want).abs().max()
                         / want.abs().max())

        got_g = torch.autograd.grad(y, (h, w), dy)
        want_g = torch.autograd.grad(yf, (hf, wf), dy.bfloat16().float())
        r = dict(value=rel(y, yf), grad_h=rel(got_g[0], want_g[0]),
                 grad_w=rel(got_g[1], want_g[1]), dtype=str(y.dtype))
        require(y.dtype == torch.float32
                and r["value"] <= PARTIAL_SUMS_TOL
                and max(r["grad_h"], r["grad_w"]) <= PARTIAL_SUMS_GRAD_TOL,
                f"_PartialSums {name}: {r} against float32 F.linear")
        out[name] = r
    return out


def mesh_phase(root: str):
    """The mesh's dropout against ``F.dropout``; the four cases of the
    mesh (``parallel/mesh.py``, ``parallel/pipeline.py``) at full width:
    the one-step equality gates with their controls and fault controls,
    and the 2-epoch ``--epoch_scan`` readings per rank, for the pipe case
    one eager train_step per schedule at 12 layers (one group of two
    processes for the four); then, on one card, a one-rank NCCL run
    whose graphs capture the collectives. Returns the launches of the
    counted mesh runs (the data case's flagged run on every rank, the pipe
    case's readings steps on every rank, and the one-rank NCCL run)."""
    import math

    import torch

    from mimrl_tpu_torch.parallel.check import run_ranks

    data = f"{root}/train_data"  # train_phase's split
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    devices = ([f"cuda:{i}" for i in range(2)] if n_cards >= 2
               else ["cuda:0", "cuda:0"])
    emit(phase="mesh", step="setup", cards=n_cards, backend=backend,
         devices=devices, card=card(),
         note=("two ranks share one card over gloo: correctness only, the "
               "times are no measure of scaling") if n_cards < 2 else
         "one rank per card over NCCL")
    emit(phase="mesh", step="dropout", keep_rates=mesh_dropout_check(),
         card=card())
    emit(phase="mesh", step="partial_sums", gaps=partial_sums_check(),
         tol=PARTIAL_SUMS_TOL, grad_tol=PARTIAL_SUMS_GRAD_TOL, card=card())
    flagged = add(step_launches("train", True, "int8", 6, layers=1),
                  step_launches("critic", True, "int8", 6, layers=1),
                  step_launches("eval", True, "int8", 4, layers=1))
    launches = (0, 0, 0, 0)

    def limits_of(control):
        return {k: MESH_GAP_FACTOR * max(control[k], MESH_GAP_FLOOR)
                for k in MESH_GATED}

    for cases in MESH_GROUPS:
        t0 = time.perf_counter()
        results = run_ranks(2, mesh_group_rank, (data, root, cases),
                            backend=backend, devices=devices, store_dir=root)
        emit(phase="mesh", step="group_seconds", cases=cases,
             seconds=time.perf_counter() - t0)
        for case in cases:
            gate, ranks = results[case]["gate"], results[case]["readings"]
            variants = MESH_CASES[case][1]
            for name, _ in variants:
                r = gate[name]
                limits = limits_of(r["control"])
                ratio = {k: r["gaps"][k] / limits[k] for k in limits}
                emit(phase="mesh", step="gate", case=case, variant=name,
                     gaps=r["gaps"], control=r["control"], limits=limits,
                     gap_over_limit=ratio, factor=MESH_GAP_FACTOR,
                     launches_per_rank=r["launches_per_rank"],
                     kernel_errors=r["kernel_errors"],
                     flash_attn=r["flash_attn"], card=card(),
                     seconds=results[case]["gate_s"])
                require(all(v <= 1.0 for v in ratio.values()),
                        f"mesh {case}/{name}: gaps {r['gaps']} over the "
                        f"limits {limits}")
                ke = r["kernel_errors"]
                require(ke["attention_fwd"] <= LAUNCH_BF16_TOL
                        and ke["attention_bwd"] <= LAUNCH_BF16_TOL
                        and ke["axis_mlp"] <= AXIS_MLP_TOL
                        and ke["int8_not_bit_equal"] == 0.0,
                        f"mesh {case}/{name}: a kernel launch against its "
                        f"plain version {ke}")
                # per rank: a critic_step and a train_step
                flags = MESH_CASES[case][0] + dict(variants)[name]
                kernels = "--flash_attn" in flags
                pallas = "--use_pallas" in flags
                quant = "int8" if pallas else "none"
                if case == "pipe":
                    want = list(pipe_step_launches(
                        pallas, quant, "--pipe_remat" in flags,
                        PIPE_GATE_LAYERS, 2, PIPE_MICRO))
                else:
                    want = list(add(
                        *(step_launches(kind, pallas, quant,
                                        layers=MESH_GATE_LAYERS)
                          for kind in ("critic", "train"))))
                if not kernels:
                    want[:2] = [0, 0]
                for per_rank in r["launches_per_rank"]:
                    require(per_rank == want, f"mesh {case}/{name}: "
                            f"launches per rank {per_rank}, want {want}")
            limits = limits_of(gate[variants[0][0]]["control"])
            for fault in CASE_FAULTS.get(case, {}):
                g = gate[f"fault_{fault}"]["gaps"]
                miss = max(g[k] / limits[k] for k in limits)
                emit(phase="mesh", step="fault_control", case=case,
                     fault=fault, gaps=g, limits=limits, gap_over_limit=miss)
                require(miss >= 10.0, f"mesh fault control {fault} missed "
                        f"its limit by {miss:.3g}x only (want >= 10x)")
            if case == "pipe":
                for per_rank in ranks:
                    for r in per_rank:
                        want = pipe_step_launches(
                            False, "none", r["remat"], r["bert_layers"], 2,
                            PIPE_MICRO)
                        want = sub(want, step_launches(
                            "critic", False, "none", PIPE_MICRO,
                            r["bert_layers"] // 2))
                        require(tuple(r["launches"]) == want,
                                f"mesh pipe readings {r['schedule']} rank "
                                f"{r['rank']}: launches {r['launches']}, "
                                f"want {want}")
                        launches = add(launches, tuple(r["launches"]))
                        emit(phase="mesh", step="pipe_readings",
                             backend=backend, card=card(),
                             seconds=results[case]["readings_s"], **r)
                continue
            for r in ranks:
                require(all(math.isfinite(v) for s in r["scores"]
                            for v in s.values()),
                        f"mesh {case} rank {r['rank']}: scores {r['scores']}")
                emit(phase="mesh", step="readings", case=case,
                     flags=MESH_READ_FLAGS.get(case, []), backend=backend,
                     card=card(), seconds=results[case]["readings_s"], **r)
            require(ranks[0]["scores"] == ranks[1]["scores"],
                    f"mesh {case}: the ranks' scores differ")
            if case == "seq_shard":
                seq_memory_emit(results[case]["memory"], backend, 2)
                emit(phase="mesh", step="seq_memory_seconds",
                     seconds=results[case]["memory_s"])
            if case == "data":
                for r in ranks:
                    require(tuple(r["launches"]) == flagged,
                            f"mesh data rank {r['rank']}: launches "
                            f"{r['launches']}, want {flagged}")
                    launches = add(launches, tuple(r["launches"]))
    if n_cards < 2:
        one = mesh_one_rank_nccl(data, f"{root}/runs")
        require(tuple(one["launches"]) == flagged,
                f"one-rank NCCL run: launches {one['launches']}, "
                f"want {flagged}")
        emit(phase="mesh", step="one_rank_nccl", card=card(), **one)
        launches = add(launches, tuple(one["launches"]))
    return launches


# ---------------------------------------------------------------------- #
# The step-cost split (tools/decompose.py), a mimrl_tpu slot resumed, the
# host library (native/), sequence parallelism's memory, per-rank busy

DECOMPOSE_SHAPES = (  # (label, the BENCH_* shape, --use_pallas)
    ("bf16", dict(bs=BATCH, time_len=TIME_LEN, bert_layers=12,
                  dtype="bfloat16", quant="none"), False),
    ("bf16_int8_pallas", dict(bs=BATCH, time_len=TIME_LEN, bert_layers=12,
                              dtype="bfloat16", quant="int8"), True),
    # recipes/run2_manifest.json's mosi_Dec shape (float32 by default)
    ("f32_bs64_t150", dict(bs=64, time_len=150, bert_layers=12,
                           dtype="float32", quant="none"), False),
)
DECOMPOSE_STEPS = 3  # timed calls per piece, after one warm-up call
# tests/fixtures/mimrl_tpu_slot: the layout of a mimrl_tpu `latest` (2
# epochs of the config beside it on this DeclareLab split), filled from a
# seed here; tests/test_torch_checkpoint.py holds it against a slot that
# the JAX package writes
JAX_SLOT_SPLIT = (6, 5, 11)
JAX_SLOT_TOL = 1e-4  # card against CPU, relative to 1 + |value| (float32)
SEQ_READ_LAYERS = 12  # the --seq_shard memory reading: the canonical depth


def decompose_phase() -> tuple:
    """``tools/decompose.py`` at DECOMPOSE_SHAPES on the card: JAX's text
    lines and one record per shape (every piece eager and, for the four
    steps the rungs replay, replayed; busy ms), the counts of all four
    kernels. Returns the launches of the decompose runs."""
    import math

    import torch

    from mimrl_tpu_torch.tools import decompose

    zero_counts()
    for label, shape, pallas in DECOMPOSE_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        before, t0 = counts(), time.perf_counter()
        result = decompose.decompose(shape, DECOMPOSE_STEPS, 1, 1, pallas)
        print(decompose.report(result), flush=True)
        bad = [k for k, r in result["pieces"].items()
               if not (math.isfinite(r["ms"]) and r["ms"] > 0)]
        require(not bad, f"decompose {label}: pieces {bad} not timed")
        emit(phase="decompose", step=label, card=card(),
             seconds=time.perf_counter() - t0,
             launches=sub(counts(), before), **result)
    launches = counts()
    attention_instances("decompose", launches)
    int8_instances("decompose", launches)
    axis_mlp_instances("decompose", launches)
    require(all(c > 0 for c in launches),
            f"decompose: a kernel was never launched: {launches}")
    return launches


def jax_slot_resume(root: str, device=None) -> dict:
    """``--resume`` of a ``mimrl_tpu`` msgpack ``latest`` on the card and
    on the CPU in this call: the fixture's layout filled from a seed and
    written in flax's format (``core/flax_msgpack.py``), resumed by a
    Solver on each device; then the epoch after it at step level, stage 2
    (train steps with MI) and a stage-1 critic step, with the same kNN
    anchors drawn on the host for both (the config's dropout is off); the
    card's losses and MI values within JAX_SLOT_TOL of the CPU's, and a
    resume that takes optax's nu as mu (on the card) must miss that limit
    tenfold. Then the same tree as ``mimrl_tpu``'s orbax slot
    (``core/orbax_slot.py``'s writer) in a run directory of its own: read
    back leaf for leaf bit for bit against the msgpack read, resumed on
    the card into the msgpack resume's state bit for bit, its epoch equal
    to the msgpack resume's (bit for bit; where it is not, a second
    msgpack resume on the card is the control: bit for bit where it
    repeats the first, else within RESUME_GAP_FACTOR times its gap)
    and within JAX_SLOT_TOL of the CPU's, and served by ``Predictor``.
    ``device``: the card (None) or, to rehearse, the CPU."""
    import json
    import math
    import os

    import numpy as np
    import torch

    from mimrl_tpu_torch.core import flax_msgpack, orbax_slot
    from mimrl_tpu_torch.core.config import MimrlConfig
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.models import convert
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "mimrl_tpu_slot")
    base = f"{root}/jax_slot"
    data, run = f"{base}/data", f"{base}/run"
    os.makedirs(run, exist_ok=True)
    make_dec_fixture(data, "mosi", n_per_split=JAX_SLOT_SPLIT, max_len=15,
                     seed=3)
    with open(f"{fixture}/skeleton.json") as f:
        slot = flax_msgpack.seeded_tree(json.load(f), 0)
    flax_msgpack.write(f"{run}/latest_model.msgpack", slot)
    with open(f"{fixture}/config.json") as f:
        cfg_json = f.read()
    with open(f"{run}/config.json", "w") as f:
        f.write(cfg_json)
    cfg = MimrlConfig.from_json(cfg_json).replace(
        data_dir=data, task_dir=base, resume=run)

    def resumed(device, name, resume=run):
        solver = Solver(cfg.replace(task_name=name, resume=resume),
                        device=device)
        solver.writer.close()
        return solver

    cpu = resumed("cpu", "cpu")
    batches = list(cpu.train_loader)
    bs, k = cfg.batch_size, cfg.k_neighbor
    valid = int(cpu.bank.valid.sum())
    rng = np.random.default_rng(7)
    anchors = [{name: torch.from_numpy(rng.choice(valid, bs // k,
                                                  replace=False))
                for name in ("ac_t", "ta_c", "vc_t", "tv_c", "tc_a", "tc_v")}
               for _ in range(len(batches) + 1)]

    def epoch(solver):
        """Stage 2 then stage 1 from the resumed state: the train steps'
        losses and MI values, then the first critic step's (the later
        ones read critics that Adam moved on rounding noise: the seeded
        moments are small, and some critic gradients are zero in exact
        arithmetic)."""
        dev = solver.device
        out = []
        solver.new_bank.zero_()
        for i, b in enumerate(batches):
            mb, labels, _ = solver._prep(b)
            knn = {n: a.to(dev) for n, a in anchors[i].items()}
            loss, mis, _ = steps.train_step(
                solver.model, solver.opt_main, solver.opt, mb, labels,
                solver.bank, solver.new_bank, i * bs, None, True, knn)
            out += [loss.item()] + mis.tolist()
        mb, labels, _ = solver._prep(batches[0])
        knn = {n: a.to(dev) for n, a in anchors[len(batches)].items()}
        loss, mis = steps.critic_step(solver.model, solver.opt_vmi,
                                      solver.opt, mb, labels, solver.bank,
                                      None, knn)
        return np.asarray(out + [loss.item()] + mis.tolist())

    def gap(got, want):
        g = np.abs(got - want) / (1.0 + np.abs(want))
        return float(g.max()) if np.isfinite(g).all() else math.inf

    def resumed_state(solver):
        """What a resume loads, on the host: weights, moments, bank."""
        out = {f"model.{k}": v for k, v in solver.model.state_dict().items()}
        for name in ("opt_main", "opt_vmi"):
            out.update({f"{name}.{k}": v for k, v in zip(
                ("count", "mu", "nu"), getattr(solver, name).state())})
        out.update({f"bank.{k}": v for k, v in solver.bank.state_dict().items()})
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    want = epoch(cpu)
    card_solver = resumed(device, "card")
    state = dict(start_epoch=card_solver.start_epoch,
                 loader_passes=card_solver.train_loader.passes,
                 count_main=card_solver.opt_main.count.item(),
                 count_vmi=card_solver.opt_vmi.count.item(),
                 mu_dtype=str(card_solver.opt_main.mu.dtype))
    msgpack_state = resumed_state(card_solver)
    got = epoch(card_solver)
    del card_solver
    moment_trees = convert._moment_trees

    def nu_as_mu(opt_state, what):
        count, mu, _ = moment_trees(opt_state, what)
        return count, mu, _widened(mu)

    with patched([(convert, "_moment_trees", nu_as_mu)]):
        faulty = resumed(device, "nu_as_mu")
    fault = epoch(faulty)
    del faulty, cpu
    log = open(f"{base}/card/Running.log").read()
    record = dict(phase="resume", step="mimrl_tpu_slot", card=card(),
                  slot_bytes=os.path.getsize(f"{run}/latest_model.msgpack"),
                  values=len(want), gap=gap(got, want),
                  gap_per_value=(np.abs(got - want)
                                 / (1.0 + np.abs(want))).tolist(),
                  fault_gap=gap(fault, want), limit=JAX_SLOT_TOL,
                  log=[ln for ln in log.splitlines()
                       if "mimrl_tpu slot" in ln], **state)
    emit(**record)
    require(record["gap"] <= JAX_SLOT_TOL,
            f"mimrl_tpu slot resumed: card against CPU {record['gap']}")
    require(record["fault_gap"] >= 10 * JAX_SLOT_TOL,
            f"the nu-as-mu fault moved the epoch by {record['fault_gap']} "
            "only")

    # the same tree as an orbax slot, in a run directory of its own
    t_orbax = time.perf_counter()
    orun = f"{base}/orbax_run"
    os.makedirs(orun, exist_ok=True)
    with open(f"{orun}/config.json", "w") as f:
        f.write(cfg_json)
    t0 = time.perf_counter()
    orbax_slot.write(f"{orun}/latest_model.orbax", slot)
    write_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    from_orbax = orbax_slot.read(f"{orun}/latest_model.orbax")
    read_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    from_msgpack = flax_msgpack.read(f"{run}/latest_model.msgpack")
    msgpack_read_ms = 1e3 * (time.perf_counter() - t0)

    def by_path(tree):
        return sorted(orbax_slot.leaf_digests(tree),
                      key=lambda leaf: leaf["path"])

    leaves = by_path(from_orbax)
    same_leaves = leaves == by_path(from_msgpack)
    slot_bytes = sum(leaf_nbytes(x) for x in tree_leaves(from_orbax))
    orbax_solver = resumed(device, "card_orbax", orun)
    orbax_state = resumed_state(orbax_solver)
    unequal = [k for k, v in msgpack_state.items()
               if not (v.dtype == orbax_state[k].dtype
                       and torch.equal(v, orbax_state[k]))]
    got_orbax = epoch(orbax_solver)
    del orbax_solver
    # where the epochs differ: a second msgpack resume on the card is the
    # control of what the card repeats
    control = got if got_orbax.tobytes() == got.tobytes() else epoch(
        resumed(device, "card_control"))
    control_equal = control.tobytes() == got.tobytes()
    limit = 0.0 if control_equal else RESUME_GAP_FACTOR * gap(control, got)
    predictor = Predictor(orun, config_overrides={"data_dir": data},
                          device=device)
    preds, _ = predictor.predict_loader(predictor.test_loader)
    del predictor
    orbax_log = open(f"{base}/card_orbax/Running.log").read()
    orbax_record = dict(
        phase="resume", step="mimrl_tpu_orbax_slot", card=card(),
        leaves=len(leaves), read_equals_msgpack_read=same_leaves,
        resumed_state_tensors=len(msgpack_state),
        resumed_state_unequal=unequal[:5],
        epoch_bit_equal_msgpack=got_orbax.tobytes() == got.tobytes(),
        control_bit_equal=control_equal, control_gap=gap(control, got),
        gap_msgpack=gap(got_orbax, got), limit_msgpack=limit,
        gap_cpu=gap(got_orbax, want), limit_cpu=JAX_SLOT_TOL,
        served_rows=int(preds.shape[0]),
        served_finite=bool(np.isfinite(preds).all()),
        slot_bytes=slot_bytes, write_ms=write_ms, read_ms=read_ms,
        read_mb_per_s=slot_bytes / 1e6 / (read_ms / 1e3),
        msgpack_read_ms=msgpack_read_ms,
        seconds=time.perf_counter() - t_orbax,
        log=[ln for ln in orbax_log.splitlines() if "mimrl_tpu slot" in ln])
    emit(**orbax_record)
    require(same_leaves, "orbax slot: the reader's leaves differ from the "
            "msgpack reader's")
    require(not unequal, f"orbax slot resumed into another state: {unequal[:5]}")
    require(orbax_record["gap_msgpack"] <= limit,
            f"orbax resume: epoch against the msgpack resume's "
            f"{orbax_record['gap_msgpack']} (limit {limit})")
    require(orbax_record["gap_cpu"] <= JAX_SLOT_TOL,
            f"orbax resume: card against CPU {orbax_record['gap_cpu']}")
    require(orbax_record["served_finite"] and preds.shape[1] == 1
            and orbax_record["log"], f"orbax slot served: {preds.shape}, "
            f"log {orbax_record['log']}")
    return record


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def leaf_nbytes(x) -> int:
    import numpy as np

    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


ORBAX_FIXTURE = "tests/fixtures/mimrl_tpu_orbax"
ORBAX_LEAF = (30522, 768)  # BERT-base's word embedding
DECODE_REPEATS = 50


def orbax_readings(root: str) -> dict:
    """The committed ``mimrl_tpu`` orbax fixture (written by JAX's orbax:
    zstd frames with Huffman literals and FSE sequences) decoded on this
    machine by the port's reader and native decoder: every leaf's sha256
    against its ``leaves.json``; the reader's ms and MB/s on it and on one
    large leaf written by the port's writer (``ORBAX_LEAF`` float32), and
    the decoder's MB/s over the fixture's frames."""
    import hashlib
    import os

    import numpy as np

    from mimrl_tpu_torch import native
    from mimrl_tpu_torch.core import orbax_slot

    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, ORBAX_FIXTURE)
    with open(f"{fixture}/leaves.json") as f:
        listed = sorted(json.load(f), key=lambda leaf: leaf["path"])
    t0 = time.perf_counter()
    tree = orbax_slot.read(f"{fixture}/latest_model.orbax")
    fixture_ms = 1e3 * (time.perf_counter() - t0)
    got = sorted(orbax_slot.leaf_digests(tree), key=lambda leaf: leaf["path"])
    fixture_bytes = sum(leaf_nbytes(x) for x in tree_leaves(tree)
                        if not isinstance(x, dict))
    # each chunk's frame and its size (orbax's frames do not declare it)
    kv = orbax_slot.read_kv(f"{fixture}/latest_model.orbax")
    frames, sizes = [], []
    for key, value in kv.items():
        name, _, chunk = key.decode().rpartition("/")
        if chunk == ".zarray":
            continue
        meta = json.loads(kv[f"{name}/.zarray".encode()])
        if meta["compressor"] is not None:
            item = 2 if meta["dtype"] == "bfloat16" else np.dtype(
                meta["dtype"]).itemsize
            frames.append(value)
            sizes.append(item * int(np.prod(meta["chunks"], dtype=np.int64)))
    decoded = [native.zstd_decompress(v, n) for v, n in zip(frames, sizes)]
    t0 = time.perf_counter()
    for _ in range(DECODE_REPEATS):
        for v, n in zip(frames, sizes):
            native.zstd_decompress(v, n)
    decode_s = time.perf_counter() - t0
    decode_bytes = DECODE_REPEATS * sum(sizes)

    # the decoder is the port's own: the library links no libzstd
    ldd = subprocess.run(["ldd", str(native.library_path())],
                         capture_output=True, text=True, timeout=60).stdout
    links = [ln.split()[0] for ln in ldd.splitlines() if ln.strip()]
    require(not any("zstd" in name for name in links),
            f"the native library links {links}")

    rng = np.random.default_rng(11)
    leaf = (0.05 * rng.standard_normal(ORBAX_LEAF)).astype(np.float32)
    big = f"{root}/orbax_leaf/latest_model.orbax"
    os.makedirs(os.path.dirname(big), exist_ok=True)
    tree_big = {"params_bert": {"embeddings": {"word_embeddings": {
        "embedding": leaf}}}}
    t0 = time.perf_counter()
    orbax_slot.write(big, tree_big)
    big_write_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    back = orbax_slot.read(big)
    big_read_ms = 1e3 * (time.perf_counter() - t0)
    back = back["params_bert"]["embeddings"]["word_embeddings"]["embedding"]
    record = dict(
        phase="resume", step="orbax_readings", card=card(),
        fixture_leaves=len(listed), fixture_sha256_match=got == listed,
        fixture_frames=len(frames), fixture_bytes=fixture_bytes,
        fixture_read_ms=fixture_ms,
        fixture_read_mb_per_s=fixture_bytes / 1e6 / (fixture_ms / 1e3),
        decode_mb_per_s=decode_bytes / 1e6 / decode_s,
        decode_compressed_bytes=sum(len(v) for v in frames),
        decode_bytes=sum(sizes),
        decoded_nonempty=all(d.size == n for d, n in zip(decoded, sizes)),
        leaf_shape=list(ORBAX_LEAF), leaf_bytes=leaf.nbytes,
        leaf_write_ms=big_write_ms, leaf_read_ms=big_read_ms,
        leaf_read_mb_per_s=leaf.nbytes / 1e6 / (big_read_ms / 1e3),
        leaf_bit_equal=hashlib.sha256(back.tobytes()).digest()
        == hashlib.sha256(leaf.tobytes()).digest(),
        library=str(native.library_path()), library_links=links,
        seconds=time.perf_counter() - t_start)
    emit(**record)
    require(record["fixture_sha256_match"],
            "the committed orbax fixture decodes to other leaves than "
            "leaves.json lists")
    require(record["leaf_bit_equal"], "the large orbax leaf read back "
            "differs from what was written")
    return record


def _widened(tree):
    """A slot subtree with bfloat16 leaves as float32 tensors."""
    import torch

    if isinstance(tree, dict):
        return {k: _widened(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float()
    return tree


def native_check(root: str) -> dict:
    """The host library (``native/collate.cpp``, built with g++ at first
    use) against the numpy forms at MOSI's split: each split's padded
    audio and video and its token ids (a vocab.txt tokenizer, so the
    WordPiece encoder runs in C++) bit for bit, and the host ms of each."""
    import os

    import numpy as np

    from mimrl_tpu_torch import native
    from mimrl_tpu_torch.data import pipeline
    from mimrl_tpu_torch.data.declab import load_dec_dataset
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.data.tokenizer import (SPECIAL_TOKENS,
                                                WordPieceTokenizer)

    data = f"{root}/native_mosi"
    make_dec_fixture(data, "mosi", n_per_split=MOSI_SPLIT, d_audio=5,
                     d_video=20, max_len=TIME_LEN + 1, seed=4)
    splits = {m: load_dec_dataset("mosi_Dec", m, data)
              for m in ("train", "valid", "test")}
    words = sorted({w.lower() for ds in splits.values()
                    for ws in ds.text_words for w in ws})
    # half the words whole, the rest as a first letter and a suffix piece
    pieces = words[::2] + sorted({w[0] for w in words[1::2]}
                                 | {"##" + w[1:] for w in words[1::2] if w[1:]})
    vocab = os.path.join(data, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(SPECIAL_TOKENS + pieces) + "\n")
    tok = WordPieceTokenizer.from_vocab_file(vocab)
    out = {}
    for mode, ds in splits.items():
        before = dict(native.calls)
        t0 = time.perf_counter()
        pipe = pipeline.BatchPipeline(ds, BATCH, TIME_LEN, tokenizer=tok)
        native_ms = 1e3 * (time.perf_counter() - t0)
        calls = {k: native.calls[k] - before[k] for k in before}
        texts = [" ".join(w[:TIME_LEN]) for w in ds.text_words]
        t0 = time.perf_counter()
        plain = (pipeline._pad_stack_plain(ds.audio, TIME_LEN),
                 pipeline._pad_stack_plain(ds.video, TIME_LEN),
                 *tok.batch_encode_plain(texts, TIME_LEN))
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = (pipe._audio, pipe._video, *pipe._tokens)
        equal = all(np.array_equal(g, w) and g.dtype == w.dtype
                    for g, w in zip(got, plain))
        unk = float((got[2] == tok.unk_id).mean())
        out[mode] = dict(samples=len(ds), native_ms=native_ms,
                         plain_ms=plain_ms, calls=calls, bit_equal=equal,
                         unk_share=unk)
        require(equal, f"native {mode}: differs from the numpy forms")
        require(calls["pad_stack"] == 2 and calls["tokenizer"] == 1,
                f"native {mode}: the loader did not take the library "
                f"({calls})")
    emit(phase="families", step="native", library=str(native.library_path()),
         vocab_tokens=len(SPECIAL_TOKENS) + len(pieces), **out)
    return out


def busy_readings(prof, union_ms: float) -> dict:
    """A rank's busy readings of one profiled step: the union of every
    device record (``eager_step_busy_ms``) and this rank's own records by
    correlation (``eager_step_own``: ``own_device_ms``); on a card that two
    ranks share both keys end in ``_shared``: a record's span there also
    holds the time the card ran the other rank's work."""
    import torch

    tag = "_shared" if torch.cuda.device_count() < 2 else ""
    return {f"eager_step_busy_ms{tag}": union_ms,
            f"eager_step_own{tag}": own_device_ms(prof)}


def own_device_ms(prof) -> dict:
    """This process's device time in a profile, by the records' correlation
    to the CUDA runtime calls it made (kineto's correlation ids): the
    union of its kernels' spans and that of its copies and memsets, and
    the device records it could not tie to a call of its own. On one card
    shared by two ranks a record's span also holds the time the card gave
    the other process, so these are labelled shared there."""
    import torch

    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    calls = {e.correlation_id() for e in events
             if e.device_type() == cpu and e.correlation_id()}
    kernels, copies, loose = [], [], 0
    for e in events:
        if e.device_type() == cpu:
            continue
        ids = {e.correlation_id(), e.linked_correlation_id()} - {0}
        if not ids & calls:
            loose += 1
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        name = e.name().lower()
        (copies if "memcpy" in name or "memset" in name else kernels).append(
            span)

    def union_ms(spans):
        total, end = 0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e6

    return dict(kernels_ms=union_ms(kernels), copies_ms=union_ms(copies),
                kernel_records=len(kernels), copy_records=len(copies),
                uncorrelated_records=loose)


def seq_memory_rank(rank, device, data, root, n_model):
    """One rank of the ``--seq_shard`` memory reading: on ``data 1 x model
    n_model``, without and then with ``--seq_shard``, the canonical bf16
    recipe at SEQ_READ_LAYERS BERT layers, one eager train_step to warm
    up and one timed: its ms and the peak memory it allocated, and the
    memory held before it (parameters, moments, banks). Returns (rank 0)
    every rank's readings."""
    import torch
    import torch.distributed as dist

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    mine = []
    for seq in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        argv = mesh_argv(data, "--mesh_data", "1", "--mesh_model",
                         str(n_model), "--bert_layers", str(SEQ_READ_LAYERS),
                         "--task_dir", f"{root}/runs", "--task_name",
                         f"seq_memory_{int(seq)}", "--no_save_models",
                         *(["--seq_shard"] if seq else []))
        solver = Solver(parse_args(argv), device=device)
        mb, labels, _ = solver._prep(next(iter(solver.train_loader)))

        def step():
            steps.train_step(solver.model, solver.opt_main, solver.opt, mb,
                             labels, solver.bank, solver.new_bank, 0,
                             solver.generator, True)
            torch.cuda.synchronize(device)

        step()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        step()
        mine.append(dict(
            rank=rank, seq_shard=seq, mesh=repr(solver.mesh),
            step_ms=1e3 * (time.perf_counter() - t0),
            peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
            held_gb=held / 1e9, blocks=len(solver.model_blocks)))
        del solver, mb, labels
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def whole_by_choice(n_model: int) -> dict:
    """The parameters that JAX's ``param_sharding_rule`` would split over
    ``model`` and the port holds whole on every rank on purpose (the
    critics' MLPs, ``W_t``, the GRUs, CubeMLP: ``shard_params`` splits
    only BERT's four dense kernels and the experts), at the canonical
    recipe: their float32 bytes, and what splitting them with Adam's
    moments (bf16 mu, float32 nu) would save a rank."""
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.models.model import build_model
    from mimrl_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh,
                                               _sharded_forward, param_specs)

    model = build_model(parse_args(CANONICAL_MOSI + CANONICAL_TRAIN),
                        MESH_VOCAB, 5, 20, "meta")
    params = dict(model.named_parameters())
    whole = sum(params[n].numel() for n, spec in param_specs(
        Mesh({MODEL_AXIS: n_model}), model).items()
                if MODEL_AXIS in spec and not _sharded_forward(n))
    return dict(model=n_model, whole_param_bytes=4 * whole,
                saved_per_rank_bytes=(4 + 2 + 4) * whole * (1 - 1 / n_model))


def seq_memory_emit(ranks, backend: str, n_model: int) -> None:
    """The ``--seq_shard`` memory readings, per rank; the peak with it
    must be lower than without it on every rank."""
    emit(phase="mesh", step="held_whole", **whole_by_choice(n_model))
    for per_rank in ranks:
        off, on = per_rank
        emit(phase="mesh", step="seq_memory", backend=backend,
             model=n_model, card=card(), rank=off["rank"],
             peak_gb=dict(whole=off["peak_gb"], seq_shard=on["peak_gb"]),
             saved_gb=off["peak_gb"] - on["peak_gb"],
             held_gb=dict(whole=off["held_gb"], seq_shard=on["held_gb"]),
             step_ms=dict(whole=off["step_ms"], seq_shard=on["step_ms"]),
             blocks=dict(whole=off["blocks"], seq_shard=on["blocks"]),
             mesh=on["mesh"])
        require(on["peak_gb"] < off["peak_gb"],
                f"--seq_shard rank {off['rank']}: peak {on['peak_gb']} GB, "
                f"not below {off['peak_gb']} GB without it")


def order_controls(argv, root: str, device: str = "cuda:0") -> dict:
    """The one-card canonical run of ``argv`` four times: as it is, with
    every forward's rows in two blocks summed in the other order
    (``check._split_forward``: the data axis's order), with BERT's stack
    on the pipeline's microbatches (``check._micro_forward``: the pipe
    axis's order), and with both (a ``data 2 x pipe 2`` rank's order),
    through both epochs; each run's scores."""
    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.parallel import check
    from mimrl_tpu_torch.train import steps

    out = {}
    for name, forward in (("plain", None),
                          ("rows_reordered", check._split_forward((1, 0))),
                          ("microbatched", check._micro_forward(PIPE_MICRO)),
                          ("both", check._split_forward((1, 0), PIPE_MICRO))):
        patches = [] if forward is None else [(steps, "forward_batch",
                                               forward)]
        t0 = time.perf_counter()
        with patched(patches):
            out[name] = cli_main(argv + ["--mesh_data", "1", "--task_name",
                                         f"control_{name}"], device=device)
        emit(phase="mesh", step="order_control", run=name, card=card(),
             wall_s=time.perf_counter() - t0, scores=out[name])
    return out


def mesh_main(cases) -> None:
    """``python3 chip_smoke.py --mesh [case ...]``: the build and the
    `mesh` phase's ``cases`` alone (default: the pipe case), over NCCL
    with one rank per card on two or more cards; on four or more cards
    also ``cli.main`` with ``--mesh_data 2 --mesh_pipe 2`` (one rank per
    card, started by ``cli/main.py``) for 2 epochs at 4 BERT layers beside
    the same run on one card."""
    import math

    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.ops import _build

    global MESH_GROUPS
    MESH_GROUPS = (tuple(cases or ("pipe",)),)
    t0 = time.perf_counter()
    _build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         cards=torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as root:
        data = f"{root}/train_data"
        make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                         d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
        t0 = time.perf_counter()
        launches = mesh_phase(root)
        emit(phase="mesh", step="seconds", seconds=time.perf_counter() - t0,
             launches=launches)
        if torch.cuda.device_count() < 4:
            return
        from mimrl_tpu_torch.parallel.check import run_ranks

        t0 = time.perf_counter()
        seq_memory_emit(run_ranks(4, seq_memory_rank, (data, root, 4),
                                  backend="nccl",
                                  devices=[f"cuda:{i}" for i in range(4)],
                                  store_dir=root), "nccl", 4)
        emit(phase="mesh", step="seq_memory_seconds",
             seconds=time.perf_counter() - t0)
        argv = mesh_argv(data, "--flash_attn", "on", "--bert_layers", "4",
                         "--epochs_num", "2", "--no_save_models",
                         "--save_latest_every", "0", "--task_dir",
                         f"{root}/runs")
        # the spread that the reduction order alone moves on one card
        controls = order_controls(argv, root)
        t0 = time.perf_counter()
        name = "data2_pipe2"
        scores = cli_main(argv + ["--mesh_data", "2", "--mesh_pipe", "2",
                                  "--pipe_microbatches", str(PIPE_MICRO),
                                  "--task_name", name])
        log = open(f"{root}/runs/{name}/Running.log").read()
        require(all(math.isfinite(v) for r in scores for v in r.values()),
                f"cli {name}: scores {scores}")
        emit(phase="mesh", step="cli", run=name, card=card(),
             wall_s=time.perf_counter() - t0, scores=scores,
             mesh=[ln for ln in log.splitlines() if "Mesh:" in ln])
        # MAE of the best valid, the best test and the test at the best
        # valid epoch (cli.main's three scores)
        plain = controls["plain"]
        spread = [max(abs(c[i]["mae"] - plain[i]["mae"])
                      for c in controls.values()) for i in range(3)]
        gap = [abs(scores[i]["mae"] - plain[i]["mae"]) for i in range(3)]
        emit(phase="mesh", step="four_card_gap", card=card(),
             mae=dict({k: [r["mae"] for r in c] for k, c in controls.items()},
                      four_cards=[r["mae"] for r in scores]),
             control_spread=spread, four_card_gap=gap,
             wider_than_spread=[g > c for g, c in zip(gap, spread)])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if "--mesh" in sys.argv[1:]:
        from mimrl_tpu_torch.device import resolve_device

        resolve_device()
        mesh_main([a for a in sys.argv[1:] if a != "--mesh"])
        print(card(), flush=True)
        return 0
    from mimrl_tpu_torch.device import resolve_device
    from mimrl_tpu_torch.ops import _build

    resolve_device()  # TF32 off for the float32 checks
    t0 = time.perf_counter()
    libs = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=sorted(v.name for v in libs.values()))

    # seconds from the start of the kernel phase to the end of each phase,
    # for the time limit's budget
    timeline, t_run = {}, time.perf_counter()

    def done(phase):
        timeline[phase] = time.perf_counter() - t_run
        emit(phase=phase, step="done", seconds_after_kernel=timeline[phase])

    fwd, bwd = kernel_phase()
    axis_mlp = axis_mlp_phase()
    int8 = int8_phase()
    # the families phase's shapes, beside the other kernel timings: later
    # in the run the profiler has returned sessions without kernel records
    family_shapes = family_kernel_shapes()
    pipe_shapes = pipe_kernel_shapes()
    # the float32 attention at recipes/run2_manifest.json's mosi_Dec shape,
    # which decompose's third shape runs
    emit(phase="decompose", step="kernel_shape", card=card(),
         kernels=float32_attention_shape(64, 150))
    done("kernel")
    with tempfile.TemporaryDirectory() as root:
        task = write_run(root)
        serve, serve_quant = serve_phase(task)
        done("serve")
        train, argv = train_phase(root)
        train_route_check(argv)
        train_bf16_route_check(argv)
        train_f32_profile(argv)
        determinism_check(argv)
        done("train")
        quant, quant_argv = train_phase(root, "quant", True, "int8")
        quant_route_check(quant_argv)
        quant_mode_steps(quant_argv)
        done("quant")
        resume = resume_phase(root)
        jax_slot_resume(root)
        orbax_readings(root)
        done("resume")
        rungs, rungs_quant = rungs_phase(root)
        done("rungs")
        from mimrl_tpu_torch import native

        for key in native.calls:
            native.calls[key] = 0
        families = families_phase(root)
        require(native.calls["pad_stack"] > 0,
                f"families: the loaders did not pad through native/ "
                f"({native.calls})")
        emit(phase="families", step="native_path", calls=dict(native.calls))
        native_check(root)
        done("families")
        fusions = fusions_phase(root)
        done("fusions")
        hooks = hooks_phase(root)
        done("hooks")
        group = group_phase(root)
        done("group")
        mi_bank = mi_bank_phase(root)
        done("mi_bank")
        standalone_phase()
        done("standalone")
        decompose = decompose_phase()
        done("decompose")
        mesh = mesh_phase(root)
        done("mesh")
    emit(phase="timeline", seconds_after=timeline)

    # launches: each path was driven with all four counts set to 0 just
    # before it and read just after: serving and training without flags,
    # serving and training with --use_pallas --quant int8, and the resumed
    # epoch of the resume phase, the three flag-free rung runs with graphs
    # and the flagged one, the families phase's runs and serving, the three
    # fusions' runs and serving, the hooks run, the group phase's
    # grouped runs, the mi_bank phase's counted steps, and the mesh phase's
    # flagged 2-epoch run on each of its ranks and its one-rank NCCL run
    paths = dict(serve=serve, train=train, serve_quant=serve_quant,
                 train_quant=quant, resume=resume, rungs=rungs,
                 rungs_quant=rungs_quant, families=families, fusions=fusions,
                 hooks=hooks, group=group, mi_bank=mi_bank, mesh=mesh,
                 decompose=decompose)
    records = (fwd, bwd, axis_mlp, int8)
    sources = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
               "cubemlp_axis_mlp.cu", "int8_matmul_wgmma.cu")
    replaces = ("mimrl_tpu/ops/pallas/flash_attention.py:225",
                "mimrl_tpu/ops/pallas/flash_attention.py:458",
                "mimrl_tpu/ops/pallas/cubemlp_kernel.py:109",
                "mimrl_tpu/ops/pallas/int8_matmul.py:65")
    for i, rec in enumerate(records):
        rec.update(name=KERNEL_NAMES[i], route="cuda",
                   source=f"mimrl_tpu_torch/ops/csrc/{sources[i]}",
                   replaces=replaces[i],
                   launches=sum(c[i] for c in paths.values()),
                   shapes_families=family_shapes[KERNEL_NAMES[i]],
                   shapes_pipe=pipe_shapes.get(KERNEL_NAMES[i]),
                   **{f"launches_{k}": c[i] for k, c in paths.items()})
        for key in ("ms_dropout", "shapes", "instance", "profiler_ms",
                    "ms_one_launch", "library_events_ms", "bound_rate",
                    "bound_ms_fp32_pipes", "float32", "library_ms_dw_layer",
                    "library_profiler_ms_dw_layer"):
            rec.setdefault(key, None)
    require(all(r["launches"] > 0 for r in records),
            f"a kernel was never launched: {[r['launches'] for r in records]}")
    require(all(c[2:] == (0, 0) for c in (serve, train, resume, rungs,
                                          fusions, hooks, mi_bank)),
            "the flag-free paths launched a kernel of the flags")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dtype", "instance", "ms_dropout", "profiler_ms", "ms_one_launch",
            "library_events_ms", "bound_rate", "bound_ms_fp32_pipes",
            "float32", "launches_serve", "launches_train",
            "launches_serve_quant", "launches_train_quant", "launches_resume",
            "launches_rungs", "launches_rungs_quant", "launches_families",
            "launches_fusions", "launches_hooks", "launches_group",
            "launches_mi_bank", "launches_mesh", "launches_decompose",
            "library_ms_dw_layer", "library_profiler_ms_dw_layer", "shapes",
            "shapes_families", "shapes_pipe")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
