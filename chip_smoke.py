#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``mimrl_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises (non-zero exit, no result line) on failure:

1. build   ``nvcc`` builds every kernel of the port from ``ops/csrc``,
           one process per source and input type, all started together.
2. kernel  each kernel against its plain PyTorch version on the card, at
           the canonical shape, at T 150 and at ragged small shapes, with
           random key padding and a fully padded row: the attention forward
           without and with dropout (same Philox mask on both sides, keep
           rate, same seed same bits), the attention backward without and
           with dropout; times with CUDA events (median of 25 after 5
           warm-up runs) beside the plain version, the one-call PyTorch
           equivalent (timed only) and the bound.
3. serve   ``Predictor`` on the canonical MOSI config at full width
           (README quick start: bs 128, time_len 100, BERT-base
           12 x 768 x 12 heads, bi-GRU, CubeMLP 50-3-128=10-3-128, bf16)
           with seeded random weights saved as a port checkpoint, over a
           synthetic DeclareLab test split of 5 batches whose last one is
           cycle-padded. The attention kernel must launch 12 times per
           batch. The float32 forward through the kernel must match the
           float32 forward through the plain attention route.
4. train   ``mimrl_tpu_torch.cli.main`` trains the same config for 2
           epochs (3 train batches of 128, 1 valid, 1 test): epoch 0 is
           stage 2 without MI, epoch 1 is stage 1 (2 critic passes) and
           stage 2 with MI. Launches are counted per epoch (a train step
           12 forward + 12 backward, a critic step or an eval batch 12 + 0);
           losses and MI channels must be finite, the critic loss must fall,
           each stage must move its own parameter group only, one float32
           train step through the kernels must match the plain route in its
           loss, and in every parameter's gradient the same step with the
           backward kernel's plain version in its place, and
           ``Predictor`` must score the checkpoint the run wrote.

Output: one JSON object per line; then the ``kernels`` line, the card's
name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits with
status 1 and prints no result.
"""

from __future__ import annotations

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
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores; FP32 pipes
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


def cuda_ms(fn, warmup: int = 5, reps: int = 25) -> float:
    """Median device time of fn() in ms, CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def kernel_phase():
    """Both attention kernels against their plain versions; returns the
    canonical-shape bf16 records (forward, backward) for the kernels line."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    main_fwd = main_bwd = None
    shapes = [SERVE_SHAPE, AVEC_SHAPE, (3, 2, 37, 16), (2, 2, 512, HEAD_DIM)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            timed = shape in (SERVE_SHAPE, AVEC_SHAPE)
            q, k, v, bias = attention_inputs(*shape, dtype, seed=sum(shape))
            seed = torch.tensor([sum(shape)], device=q.device)

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
                       shape=list(shape), dtype=name, max_abs_err=err,
                       max_abs_err_dropout=err_d, tol=KERNEL_TOL[name])
            if timed:
                # keep rate read off the kernel: with v = 1 in one column
                # and no padding, that column of the output is
                # sum_k keep * P / (1 - p), whose mean is 1
                rec["keep_rate"] = keep_rate(shape, dtype, seed)
                require(abs(rec["keep_rate"] - (1.0 - DROPOUT_P)) <= KEEP_RATE_TOL,
                        f"keep rate {rec['keep_rate']} at {shape} {name}")
                mask = bias.to(dtype)
                rec["ms"] = cuda_ms(lambda: flash_attention(q, k, v, bias))
                rec["ms_dropout"] = cuda_ms(
                    lambda: flash_attention(q, k, v, bias, seed, DROPOUT_P))
                rec["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, bias))
                rec["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
                rec["bound_ms"], rec["bound_by"] = attention_bound(q, bias)
                if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                    main_fwd = rec
            emit(**rec)

            # ---- backward, without and with dropout ----
            g = torch.Generator(device=q.device).manual_seed(sum(shape))
            d_out = torch.randn(q.shape, device=q.device, generator=g).to(dtype)
            rec = dict(phase="kernel", kernel="flash_attention_bwd",
                       shape=list(shape), dtype=name, tol=BWD_TOL[name])
            for p_drop, key in ((0.0, "max_rel_err"), (DROPOUT_P, "max_rel_err_dropout")):
                got3 = flash_attention_bwd(q, k, v, bias, seed, d_out, p_drop)
                want3 = flash_attention_bwd_plain(q, k, v, bias, seed, d_out, p_drop)
                torch.cuda.synchronize()
                errs = {}
                for gname, gg, ww in zip(("dq", "dk", "dv"), got3, want3):
                    require(bool(torch.isfinite(gg).all()),
                            f"non-finite {gname} {shape} {name} p={p_drop}")
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
            if timed:
                rec["ms"] = cuda_ms(lambda: flash_attention_bwd(
                    q, k, v, bias, seed, d_out, 0.0))
                rec["ms_dropout"] = cuda_ms(lambda: flash_attention_bwd(
                    q, k, v, bias, seed, d_out, DROPOUT_P))
                rec["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_plain(
                    q, k, v, bias, seed, d_out, 0.0))
                rec["library_ms"] = sdpa_backward_ms(q, k, v, bias.to(dtype), d_out)
                rec["bound_ms"], rec["bound_by"] = attention_bound(
                    q, bias, backward=True)
                if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                    main_bwd = rec
            emit(**rec)
    return main_fwd, main_bwd


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


def sdpa_backward_ms(q, k, v, mask, d_out) -> float:
    """The library column of the backward: ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``, the backward alone (the forward's
    graph is built once, outside the timed region)."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
    return cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), d_out,
                                               retain_graph=True))


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


def serve_phase(task: str):
    """Predictor end to end; returns the (forward, backward) launches of
    the counted run."""
    import numpy as np
    import torch

    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    predictor = Predictor(task)  # CUDA, bf16, flash_attn 'auto' -> kernel
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
    flash_attention.launches = flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    metrics = predictor.evaluate_split("test")
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    bwd_launches = flash_attention_bwd.launches
    predictor.forward = forward
    require(launches == 12 * n_batches,
            f"flash_attention_fwd launched {launches} times, want 12 x {n_batches}")
    require(bwd_launches == 0,
            f"flash_attention_bwd launched {bwd_launches} times while serving")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics {metrics}")
    emit(phase="serve", step="predictor_bf16", metrics=metrics,
         batches=n_batches, kernel_launches=launches,
         bwd_kernel_launches=bwd_launches,
         batch_ms_median=statistics.median(batch_ms), batch_ms=batch_ms,
         samples_per_s=N_TEST / wall, evaluate_s=wall,
         forward_samples_per_s=BATCH / (1e-3 * statistics.median(batch_ms)),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    preds = {"bf16_kernel": predictor.predict_loader(predictor.test_loader)[0]}
    for name, overrides in (("f32_kernel", {"compute_dtype": "float32"}),
                            ("f32_plain", {"compute_dtype": "float32",
                                           "flash_attn": "off"})):
        p = Predictor(task, config_overrides=overrides)
        preds[name] = p.predict_loader(p.test_loader)[0]
        del p
    for name, x in preds.items():
        require(x.shape == (N_TEST, 1) and bool(np.isfinite(x).all()),
                f"{name} predictions: shape {x.shape} or non-finite values")
    f32_diff = float(np.abs(preds["f32_kernel"] - preds["f32_plain"]).max())
    bf16_diff = float(np.abs(preds["bf16_kernel"] - preds["f32_plain"]).max())
    emit(phase="serve", step="route_check", f32_kernel_vs_plain=f32_diff,
         tol=SERVE_F32_TOL, bf16_kernel_vs_f32_plain=bf16_diff,
         pred_abs_max=float(np.abs(preds["f32_plain"]).max()))
    require(f32_diff <= SERVE_F32_TOL,
            f"float32 kernel route vs plain route: {f32_diff} > {SERVE_F32_TOL}")
    breakdown(predictor)
    return launches, bwd_launches


def breakdown(predictor) -> None:
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
                lambda: flash_attention(q, k, vv, bias)),
            bigru_a_v=cuda_ms(lambda: (m.rnn_a(a, la), m.rnn_v(v, lv))),
            cubemlp=cuda_ms(lambda: m.mlp_encoder(x)),
        )
    emit(phase="serve", step="breakdown_ms", **parts)


def train_phase(root: str):
    """``cli.main`` for 2 epochs at full width and depth; returns the
    (forward, backward) launches of the counted run."""
    import numpy as np
    import torch

    from mimrl_tpu_torch.cli.main import main as cli_main
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    data = f"{root}/train_data"
    make_dec_fixture(data, "mosi", n_per_split=(N_TRAIN, BATCH, BATCH),
                     d_audio=5, d_video=20, max_len=TIME_LEN + 1, seed=1)
    argv = CANONICAL_MOSI + CANONICAL_TRAIN + [
        "--data_dir", data, "--task_dir", f"{root}/runs", "--task_name", "train"]

    # The run goes through the normal entry; what it did is read off by
    # wrapping the Solver's methods and the step functions for its duration:
    # launches per epoch, host time per step (a synchronise on each side),
    # and which parameter group each stage moved.
    log = dict(epochs=[], steps=dict(critic_step=[], train_step=[], eval_step=[]),
               moved=dict(critic_step=[], train_step=[]), solver=None)
    originals = dict(train=Solver.train, evaluate=Solver.evaluate,
                     solve=Solver.solve,
                     **{n: getattr(steps, n) for n in log["steps"]})

    def counts():
        return flash_attention.launches, flash_attention_bwd.launches

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

    def timed_step(name):
        def wrapper(model, *args, **kwargs):
            before = probe(model) if name in log["moved"] else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](model, *args, **kwargs)
            torch.cuda.synchronize()
            log["steps"][name].append(1e3 * (time.perf_counter() - t0))
            if before is not None:
                after = probe(model)
                log["moved"][name].append(
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
            train_fwd=c1[0] - c0[0], train_bwd=c1[1] - c0[1],
            eval_fwd=0, eval_bwd=0, train_loss=result[0],
            critic_loss=result[1], train_mis=result[2],
            stage1_pass_losses=list(self.stage1_pass_losses),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
        return result

    def evaluate(self, loader):
        c0 = counts()
        result = originals["evaluate"](self, loader)
        c1 = counts()
        log["epochs"][-1]["eval_fwd"] += c1[0] - c0[0]
        log["epochs"][-1]["eval_bwd"] += c1[1] - c0[1]
        log["epochs"][-1].setdefault("eval_losses", []).append(result[0])
        log["epochs"][-1].setdefault("eval_mis", []).append(result[1])
        return result

    def solve(self):
        log["solver"] = self
        return originals["solve"](self)

    flash_attention.launches = flash_attention_bwd.launches = 0
    Solver.train, Solver.evaluate, Solver.solve = train, evaluate, solve
    for name in log["steps"]:
        setattr(steps, name, timed_step(name))
    try:
        t0 = time.perf_counter()
        scores = cli_main(argv)
        wall = time.perf_counter() - t0
    finally:
        Solver.train, Solver.evaluate, Solver.solve = (
            originals["train"], originals["evaluate"], originals["solve"])
        for name in log["steps"]:
            setattr(steps, name, originals[name])
    launches = counts()

    # ---- launch counts, exactly, per epoch ----
    e0, e1 = log["epochs"]
    want = [dict(train_fwd=36, train_bwd=36, eval_fwd=24, eval_bwd=0),
            dict(train_fwd=72 + 36, train_bwd=36, eval_fwd=24, eval_bwd=0)]
    for e, w in zip((e0, e1), want):
        got = {k: e[k] for k in w}
        require(got == w, f"epoch {e['epoch']} launches {got}, want {w}")
    require(launches == (36 + 24 + 108 + 24, 72),
            f"launches of the run {launches}")

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
    emit(phase="train", step="solver_bf16", epochs=log["epochs"], wall_s=wall,
         train_step_ms=train_ms, critic_step_ms=critic_ms, eval_batch_ms=eval_ms,
         train_step_ms_median=statistics.median(train_ms),
         critic_step_ms_median=statistics.median(critic_ms),
         eval_batch_ms_median=statistics.median(eval_ms),
         train_epoch_samples_per_s=N_TRAIN / e1["train_s"],
         stage2_samples_per_s=N_TRAIN / (1e-3 * sum(train_ms)),
         peak_mem_gb=max(e["peak_mem_gb"] for e in log["epochs"]),
         fwd_launches=launches[0], bwd_launches=launches[1],
         best_valid=scores[0])

    solver = log["solver"]
    train_breakdown(solver)
    del solver
    log["solver"] = None
    torch.cuda.empty_cache()

    # ---- the run's best_valid slot serves ----
    predictor = Predictor(f"{root}/runs/train")
    metrics = predictor.evaluate_split("test")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics of the trained checkpoint {metrics}")
    emit(phase="train", step="predictor_on_best_valid", metrics=metrics)
    del predictor
    torch.cuda.empty_cache()

    train_route_check(argv)
    return launches


def train_breakdown(solver) -> None:
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
            lambda: flash_attention(q, k, v, bias, seed, DROPOUT_P)),
        attention_bwd_kernel_x12=12 * cuda_ms(
            lambda: flash_attention_bwd(q, k, v, bias, seed, d_out, DROPOUT_P)),
    )
    emit(phase="train", step="breakdown_ms", **parts)
    train_profile(solver, mb, labels)


def train_profile(solver, mb, labels) -> None:
    """torch.profiler over three bf16 train steps: device time by kernel
    name (the twelve largest), the device's busy time per step (the sum over
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
    emit(phase="train", step="profile_train_step", steps=3,
         wall_ms_per_step_profiled=wall_ms, device_busy_ms_per_step=busy_ms,
         device_span_ms_per_step_profiled=span_ms,
         device_idle_share_profiled=(1.0 - busy_ms / span_ms) if rows else None,
         device_records=bool(rows),
         top=[dict(name=k[:80], ms_per_step=t / 3e3, calls_per_step=c / 3)
              for k, t, c in rows[:12]])


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
    with tempfile.TemporaryDirectory() as root:
        task = write_run(root)
        serve_launches = serve_phase(task)
        train_launches = train_phase(root)

    # launches: each path was driven with both counts set to 0 just before
    # it and both read just after; the forward kernel is on both paths
    fwd.update(name="flash_attention_fwd", route="cuda",
               source="mimrl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
               replaces="mimrl_tpu/ops/pallas/flash_attention.py:225",
               launches=serve_launches[0] + train_launches[0],
               launches_serve=serve_launches[0],
               launches_train=train_launches[0])
    bwd.update(name="flash_attention_bwd", route="cuda",
               source="mimrl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
               replaces="mimrl_tpu/ops/pallas/flash_attention.py:458",
               launches=serve_launches[1] + train_launches[1],
               launches_serve=serve_launches[1],
               launches_train=train_launches[1])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dtype", "ms_dropout", "launches_serve", "launches_train")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in (fwd, bwd)]}), flush=True)
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
