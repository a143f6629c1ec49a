#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``mimrl_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises (non-zero exit, no result line) on failure:

1. build   ``nvcc`` builds every kernel of the port from ``ops/csrc``
           (five sources, seven libraries), one process per source and
           variant, all started together.
2. kernel  each kernel against its plain PyTorch version on the card, at
           the canonical shape, at T 150, at ragged small shapes, at the
           tensor-core backward's T limit and one past it, and at hd 128,
           with random key padding and a fully padded row, in bf16 (the
           tensor-core instances, but past the limit) and float32 (the SIMT
           ones): the attention forward without and with dropout (same
           Philox mask on both sides, keep rate, same seed same bits), the
           attention backward without and with dropout (two runs bit-equal);
           the fused CubeMLP axis MLP at the six shapes of the
           canonical encoder with and without bias and at one ragged shape
           per axis; the int8 GEMM at the four forward shapes of a BERT
           layer (bf16 out), the four weight-gradient shapes (float32 out,
           two runs bit-equal, also timed in the operand layouts the dw
           product hands over) and two ragged shapes, bit for bit, the
           eight canonical ones on the wgmma instance, whose library must
           hold GMMA instructions (cuobjdump -sass); times with CUDA
           events (median of 25 after 5 warm-up runs, 10-20 queued launches
           per pair of events) and by the profiler's kernel records, beside
           the plain version, the one-call PyTorch equivalent (timed only,
           both ways) and the bound.
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
           batch, every int8 launch on the wgmma instance.
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
           ``Predictor`` must score the checkpoint the run wrote.
5. quant   the same run again with ``--use_pallas --quant int8``: launches
           of all four kernels per epoch (a train step 12 + 12 attention,
           6 axis-MLP, 96 int8 GEMM; a critic step or an eval batch
           12 + 0, 6, 48; every int8 launch on the wgmma instance),
           finite losses and MI channels, ``Predictor`` on
           its checkpoint with the flags it recorded; one float32 train
           step through the two new kernels against the same step through
           their plain versions (bit-equal where only the int8 kernel is
           exchanged); one bf16 train step each in ``int8_fwd`` (48 int8
           launches) and ``int8_all`` (144).

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

N_HEADS, HEAD_DIM, BATCH, TIME_LEN = 12, 64, 128, 100
SERVE_SHAPE = (BATCH, N_HEADS, TIME_LEN, HEAD_DIM)
# timed as well: the AVEC2019 operating point of the JAX package (T 150)
AVEC_SHAPE = (BATCH, N_HEADS, 150, HEAD_DIM)
N_TEST = 4 * BATCH + 57  # 5 batches; the last one is cycle-padded
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# tensor cores (bf16, int8); FP32 pipes
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
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
N_TRAIN = 3 * BATCH  # 3 train batches; 1 valid and 1 test batch
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
# (K, N) of a BERT-base layer's four dense products; M = bs * time_len
ROWS = BATCH * TIME_LEN
INT8_LAYER_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
INT8_MAIN = (ROWS, 768, 3072)
# K % 16 != 0 (mma_sync); ragged M and N with a K tail under stream-K (wgmma)
INT8_RAGGED = [(333, 1000, 77), (200, 12800 + 48, 136)]

CANONICAL_MOSI = [
    "--dataset", "mosi_Dec", "--log_scale", "0-0-0", "--normalize", "0-1-1",
    "--batch_size", str(BATCH), "--d_common", "128", "--encoders", "gru",
    "--activate", "gelu", "--time_len", str(TIME_LEN),
    "--d_hiddens", "50-3-128=10-3-128", "--d_outs", "50-3-128=10-3-128",
    "--dropout_mlp", "0.0-0.0-0.0", "--dropout", "0.1-0.1-0.1-0.1", "--bias",
    "--res_project", "1-1", "--features_compose_t", "mean",
    "--features_compose_k", "mean", "--num_class", "1",
    "--compute_dtype", "bfloat16",
]
CANONICAL_TRAIN = [
    "--critic_type", "separate", "--baseline_type", "constant",
    "--bound_type", "infonce",
    "--loss_mi_coefficient1", "1-1-1-1-1-1-1-1-1-1-1",
    "--loss_mi_coefficient2", "0.01-0.01-0.01-0.01-0.01-0.01-0.01-0.01",
    "--k_neighbor", "2", "--radius", "1.0", "--cmi_last_acticate", "sigmoid",
    "--stage1_n", "2", "--seed", "0", "--loss", "MAE",
    "--gradient_clip", "1.5", "--epochs_num", "2", "--optm", "Adam",
    "--learning_rate", "4e-3", "--bert_freeze", "no",
    "--bert_lr_rate", "0.01", "--lr_decrease", "multi_step",
    "--lr_decrease_iter", "9-60", "--lr_decrease_rate", "0.1",
]


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
    instances = kernel_wrappers()[3].instance_launches
    for key in instances:
        instances[key] = 0


def int8_instances(step: str, launches) -> dict:
    """The int8 launches of a counted run by instance (set to 0 with the
    counts); every one must have taken the wgmma instance."""
    instances = dict(kernel_wrappers()[3].instance_launches)
    require(instances == {"wgmma": launches[3], "mma_sync": 0},
            f"{step}: int8 launches by instance {instances}, want all "
            f"{launches[3]} on wgmma")
    return instances


def sub(c1, c0):
    return tuple(a - b for a, b in zip(c1, c0))


def step_launches(kind: str, use_pallas: bool, quant: str, n: int = 1):
    """Launches of the four kernels in ``n`` steps of one kind ('train',
    'critic' or 'eval') at the canonical depth: 12 attention forwards, in a
    train step 12 attention backwards; 6 axis MLPs (forward only: their
    backward is einsums); 4 int8 products per layer and forward, and in a
    train step as many again for dw ('int8') or twice as many for dw and
    dx ('int8_all')."""
    train = kind == "train"
    int8 = 0 if quant == "none" else 48 + (
        {"int8_fwd": 0, "int8": 48, "int8_all": 96}[quant] if train else 0)
    return (12 * n, 12 * n if train else 0, 6 * n if use_pallas else 0,
            int8 * n)


def add(*cs):
    return tuple(sum(xs) for xs in zip(*cs))


def cuda_ms(fn, warmup: int = 5, reps: int = 25, inner: int = 1) -> float:
    """Median device time of fn() in ms, CUDA events around each run of
    ``inner`` calls. A kernel shorter than its wrapper's time on the host
    is timed with ``inner`` > 1: the launches queue up behind the first and
    the events see the device's time per call, not the host's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


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


def attention_bound(q, bias, backward: bool = False):
    """(ms, 'bytes' | 'operations'). Forward: q, k, v, bias read once and
    out written once at the HBM rate, against 4 * bs * nh * T^2 * hd
    operations (two products) at the peak rate of the input type.
    Backward: q, k, v, dO, bias read and dq, dk, dv written once, against
    10 * bs * nh * T^2 * hd operations (five products)."""
    bs, nh, t, hd = q.shape
    tensors, products = (7, 5) if backward else (4, 2)
    nbytes = (tensors * q.numel() * q.element_size()
              + bias.numel() * bias.element_size())
    ops = 2 * products * bs * nh * t * t * hd
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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

    def checked_forward(q, k, v, bias, seed, dropout_p):
        out = forward(q, k, v, bias, seed, dropout_p)
        errors["fwd"].append(rel_err(out, fa.flash_attention_plain(
            q, k, v, bias, seed, dropout_p)))
        return out

    def checked_backward(ctx, d_out):
        grads = backward(ctx, d_out)
        q, k, v, bias, seed = ctx.saved_tensors
        want = fa.flash_attention_bwd_plain(q, k, v, bias, seed,
                                            d_out.to(q.dtype), ctx.dropout_p)
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
    canonical-shape bf16 records (forward, backward) for the kernels line."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops import flash_attention as fa
    from mimrl_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    main_fwd = main_bwd = None
    limit = fa.max_t_tensor_core_bwd(HEAD_DIM)
    # timed: the canonical and the AVEC shapes; then ragged ones, the
    # tensor-core backward's T limit and one past it (SIMT there), hd 128
    shapes = [SERVE_SHAPE, AVEC_SHAPE, (3, 2, 37, 16), (2, 2, 512, HEAD_DIM),
              (2, 2, limit, HEAD_DIM), (2, 2, limit + 1, HEAD_DIM),
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
                kname = KERNEL_SYMBOLS[("fwd", fwd_instance)]
                rec.update(timings(
                    lambda: flash_attention(q, k, v, bias),
                    lambda: flash_attention(q, k, v, bias, seed, DROPOUT_P),
                    lambda: flash_attention_plain(q, k, v, bias),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                    kname))
                rec["bound_ms"], rec["bound_by"] = attention_bound(q, bias)
                if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                    main_fwd = rec
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
                kname = KERNEL_SYMBOLS[("bwd", bwd_instance)]
                qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
                out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias.to(dtype))
                rec.update(timings(
                    lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, 0.0),
                    lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, DROPOUT_P),
                    lambda: flash_attention_bwd_plain(q, k, v, bias, seed, d_out, 0.0),
                    # the backward alone: the forward's graph is built once
                    lambda: torch.autograd.grad(out, (qq, kk, vv), d_out,
                                                retain_graph=True),
                    kname))
                del out, qq, kk, vv
                rec["bound_ms"], rec["bound_by"] = attention_bound(
                    q, bias, backward=True)
                if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                    main_bwd = rec
            emit(**rec)
    return main_fwd, main_bwd


# the CUDA kernels' names, for the profiler's records
KERNEL_SYMBOLS = {("fwd", "tensor_core"): "flash_fwd_tc_kernel",
                  ("fwd", "simt"): "flash_fwd_kernel",
                  ("bwd", "tensor_core"): "flash_bwd_tc_kernel",
                  ("bwd", "simt"): "flash_bwd_kernel"}


def timings(kernel, kernel_dropout, plain, library, kernel_name) -> dict:
    """The times of one attention record, ms on the device: the kernel with
    20 queued launches per pair of CUDA events ('ms', 'ms_dropout') and by
    the profiler's kernel records ('profiler_ms', 'profiler_ms_dropout');
    one launch per pair ('ms_one_launch', which reads the wrapper's host
    time where that is longer); the plain version; the one-call PyTorch
    yardstick by the profiler ('library_ms', the device time of all of its
    kernels; queued events where the profiler gives no records) and by 20
    queued calls per pair of events ('library_events_ms', which for the
    backward reads autograd's time on the host)."""
    library_events_ms = cuda_ms(library, inner=20)
    library_ms = profiler_ms(library)
    return dict(
        ms=cuda_ms(kernel, inner=20),
        ms_dropout=cuda_ms(kernel_dropout, inner=20),
        profiler_ms=profiler_ms(kernel, kernel_name),
        profiler_ms_dropout=profiler_ms(kernel_dropout, kernel_name),
        ms_one_launch=cuda_ms(kernel),
        plain_ms=cuda_ms(plain, inner=5),
        library_ms=library_events_ms if library_ms is None else library_ms,
        library_events_ms=library_events_ms)


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
    """(ms, 'bytes' | 'operations'): x, the weights and the biases read
    once and y written once at the HBM rate, against
    2 * positions * (d_in * d_hidden + d_hidden * d_out) float32 operations
    at the FP32 rate."""
    d_in, d_hidden = w1.shape
    d_out = w2.shape[1]
    positions = x.numel() // d_in
    floats = (x.numel() + positions * d_out + w1.numel() + w2.numel()
              + (0 if b1 is None else b1.numel() + b2.numel()))
    t_bytes = 4 * floats / PEAK_BYTES_PER_S
    t_ops = 2 * positions * (d_in * d_hidden + d_hidden * d_out) / PEAK_OPS["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def axis_mlp_phase():
    """The fused axis-MLP kernel against its plain version (float32, the
    only type the encoder's input has): the six canonical shapes with and
    without bias, timed, and one ragged shape per axis. Returns the record
    for the kernels line."""
    import torch

    from mimrl_tpu_torch.ops.cubemlp_kernel import (fused_axis_mlp,
                                                    fused_axis_mlp_plain)

    main, per_shape, worst = None, [], 0.0
    cases = [(c, True) for c in AXIS_MLP_SHAPES] + [(c, False) for c in AXIS_MLP_RAGGED]
    for (shape, axis, d_hidden, d_out), timed in cases:
        rec = dict(phase="kernel", kernel="cubemlp_axis_mlp", shape=list(shape),
                   axis=axis, d_hidden=d_hidden, d_out=d_out, dtype="float32",
                   activation="gelu", tol=AXIS_MLP_TOL)
        for use_bias in (True, False):
            args = axis_mlp_inputs(shape, axis, d_hidden, d_out, use_bias,
                                   seed=sum(shape) + axis)
            got = fused_axis_mlp(*args, axis, "gelu")
            want = fused_axis_mlp_plain(*args, axis, "gelu")
            torch.cuda.synchronize()
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
                    lambda: fused_axis_mlp(*args, axis, "gelu"),
                    "axis_mlp_kernel")
                rec["plain_ms"] = cuda_ms(
                    lambda: fused_axis_mlp_plain(*args, axis, "gelu"), inner=20)
                rec["bound_ms"], rec["bound_by"] = axis_mlp_bound(*args, axis)
        if timed:
            # canonical: the model's AxisMLPs have biases
            rec.update(ms=rec["ms_bias"], max_abs_err=rec["max_abs_err_bias"],
                       library_ms=None)  # no single PyTorch call computes it
            worst = max(worst, rec["max_abs_err_bias"], rec["max_abs_err_no_bias"])
            per_shape.append({k: rec[k] for k in (
                "shape", "axis", "d_hidden", "d_out", "ms", "ms_no_bias",
                "ms_one_launch", "profiler_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err")})
            if (shape, axis, d_hidden, d_out) == AXIS_MLP_MAIN:
                main = dict(rec)
        emit(**rec)
    main.update(max_abs_err=worst, shapes=per_shape,
                ms_six_shapes=sum(r["ms"] for r in per_shape),
                profiler_ms_six_shapes=(
                    sum(r["profiler_ms"] for r in per_shape)
                    if all(r["profiler_ms"] for r in per_shape) else None),
                plain_ms_six_shapes=sum(r["plain_ms"] for r in per_shape),
                bound_ms_six_shapes=sum(r["bound_ms"] for r in per_shape))
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
                    r["profiler_ms"] for r in per_shape if r["role"] == "dw"))
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
    predictor.forward = forward
    want = tuple(n * n_batches for n in per_batch)
    require(launches == want,
            f"{step}: launches {dict(zip(KERNEL_NAMES, launches))}, want {want}")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics {metrics}")
    emit(phase="serve", step=step, metrics=metrics, overrides=overrides,
         batches=n_batches, launches=dict(zip(KERNEL_NAMES, launches)),
         int8_instances=instances, batch_ms_median=statistics.median(batch_ms), batch_ms=batch_ms,
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
        preds[name] = p.predict_loader(p.test_loader)[0]
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


def breakdown(predictor, step: str) -> None:
    """Device time of the forward's parts on one bf16 batch (CUDA events;
    median of 25): BERT, the two bi-GRUs, CubeMLP, and the 12 attention
    kernel calls inside BERT."""
    import torch

    from mimrl_tpu_torch.models.encoders import lengths_from_sequence
    from mimrl_tpu_torch.ops.flash_attention import flash_attention

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
            cubemlp=cuda_ms(lambda: m.mlp_encoder(x)),
        )
    emit(phase="serve", step=step, **parts)


def train_phase(root: str, name: str = "train", use_pallas: bool = False,
                quant: str = "none"):
    """``cli.main`` for 2 epochs at full width and depth, without flags
    (phase 'train') or with ``--use_pallas --quant <mode>`` (phase 'quant');
    returns the four launch counts of the counted run."""
    import os

    import numpy as np
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


def train_profile(solver, mb, labels, name: str) -> None:
    """torch.profiler over three bf16 train steps: device time by kernel
    name (the twelve largest, and every row of the port's own kernels,
    whose names carry the sources' kernel names), the device's busy time
    per step (the sum over
    kernels and copies), the device's span of the same three steps (CUDA
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
    busy_ms = sum(r[1] for r in rows) / 3e3
    emit(phase=name, step="profile_train_step", steps=3,
         wall_ms_per_step_profiled=wall_ms, device_busy_ms_per_step=busy_ms,
         device_span_ms_per_step_profiled=span_ms,
         device_idle_share_profiled=(1.0 - busy_ms / span_ms) if rows else None,
         device_records=bool(rows),
         top=[dict(name=k[:80], ms_per_step=t / 3e3, calls_per_step=c / 3)
              for k, t, c in rows[:12]],
         port_kernels=[dict(name=k[:80], ms_per_step=t / 3e3,
                            calls_per_step=c / 3) for k, t, c in rows
                       if any(n in k for n in PORT_KERNEL_SYMBOLS)])


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
        c0 = fwd_counter.launches, bwd_counter.launches
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
    c0 = counts()
    with patched(patches):
        loss, _, out = steps.train_step(
            solver.model, opt_main, cfg, mb, labels, solver.bank,
            solver.new_bank, 0, solver.generator, False)
    torch.cuda.synchronize()
    launches = sub(counts(), c0)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from mimrl_tpu_torch.device import resolve_device
    from mimrl_tpu_torch.ops import _build

    resolve_device()  # TF32 off for the float32 checks
    t0 = time.perf_counter()
    libs = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=sorted(v.name for v in libs.values()))

    fwd, bwd = kernel_phase()
    axis_mlp = axis_mlp_phase()
    int8 = int8_phase()
    with tempfile.TemporaryDirectory() as root:
        task = write_run(root)
        serve, serve_quant = serve_phase(task)
        train, argv = train_phase(root)
        train_route_check(argv)
        train_bf16_route_check(argv)
        quant, quant_argv = train_phase(root, "quant", True, "int8")
        quant_route_check(quant_argv)
        quant_mode_steps(quant_argv)

    # launches: each path was driven with all four counts set to 0 just
    # before it and read just after: serving and training without flags,
    # serving and training with --use_pallas --quant int8
    paths = dict(serve=serve, train=train, serve_quant=serve_quant,
                 train_quant=quant)
    records = (fwd, bwd, axis_mlp, int8)
    sources = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
               "cubemlp_axis_mlp.cu", "int8_matmul_wgmma.cu")
    replaces = ("mimrl_tpu/ops/pallas/flash_attention.py:225",
                "mimrl_tpu/ops/pallas/flash_attention.py:458",
                "mimrl_tpu/ops/pallas/cubemlp_kernel.py:109",
                "mimrl_tpu/ops/pallas/int8_matmul.py:63")
    for i, rec in enumerate(records):
        rec.update(name=KERNEL_NAMES[i], route="cuda",
                   source=f"mimrl_tpu_torch/ops/csrc/{sources[i]}",
                   replaces=replaces[i],
                   launches=sum(c[i] for c in paths.values()),
                   **{f"launches_{k}": c[i] for k, c in paths.items()})
        for key in ("ms_dropout", "shapes", "instance", "profiler_ms",
                    "ms_one_launch", "library_events_ms"):
            rec.setdefault(key, None)
    require(all(r["launches"] > 0 for r in records),
            f"a kernel was never launched: {[r['launches'] for r in records]}")
    require(serve[2:] == (0, 0) and train[2:] == (0, 0),
            "the flag-free paths launched a kernel of the flags")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dtype", "instance", "ms_dropout", "profiler_ms", "ms_one_launch",
            "library_events_ms", "launches_serve", "launches_train",
            "launches_serve_quant", "launches_train_quant", "shapes")
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
