#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``mimrl_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises (non-zero exit, no result line) on failure:

1. build   ``nvcc`` builds every kernel of the port from ``ops/csrc``,
           one process per source, all started together.
2. kernel  each kernel against its plain PyTorch version on the card, at
           the serving shape, at T 150 and at ragged small shapes, with
           random key padding and a fully padded row; times with CUDA events
           (median of 25 after 5 warm-up runs) beside the plain version,
           the one-call PyTorch equivalent (timed only) and the bound.
3. serve   ``Predictor`` on the canonical MOSI config at full width
           (README quick start: bs 128, time_len 100, BERT-base
           12 x 768 x 12 heads, bi-GRU, CubeMLP 50-3-128=10-3-128, bf16)
           with seeded random weights saved as a port checkpoint, over a
           synthetic DeclareLab test split of 5 batches whose last one is
           cycle-padded. The attention kernel must launch 12 times per
           batch. The float32 forward through the kernel must match the
           float32 forward through the plain attention route.

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
# float32 predictions, kernel route vs plain route, after 12 BERT layers
SERVE_F32_TOL = 1e-3

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


def attention_bound(q, bias):
    """(ms, 'bytes' | 'operations'): q, k, v, bias read once and out
    written once at the HBM rate, against 4 * bs * nh * T^2 * hd
    operations at the peak rate of the input type."""
    bs, nh, t, hd = q.shape
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * bias.element_size()
    ops = 4 * bs * nh * t * t * hd
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    """flash_attention_fwd vs its plain version; returns the serving-shape
    bf16 record for the kernels line."""
    import torch
    import torch.nn.functional as F

    from mimrl_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    main = None
    shapes = [SERVE_SHAPE, AVEC_SHAPE, (3, 2, 37, 16), (2, 2, 512, HEAD_DIM)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            q, k, v, bias = attention_inputs(*shape, dtype, seed=sum(shape))
            got = flash_attention(q, k, v, bias)
            want = flash_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"non-finite output {shape} {name}")
            err = (got.float() - want.float()).abs().max().item()
            rec = dict(phase="kernel", kernel="flash_attention_fwd",
                       shape=list(shape), dtype=name, max_abs_err=err,
                       tol=KERNEL_TOL[name])
            require(err <= KERNEL_TOL[name],
                    f"flash_attention_fwd {shape} {name}: max abs error "
                    f"{err} > {KERNEL_TOL[name]}")
            if shape in (SERVE_SHAPE, AVEC_SHAPE):
                mask = bias.to(dtype)
                rec["ms"] = cuda_ms(lambda: flash_attention(q, k, v, bias))
                rec["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, bias))
                rec["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
                rec["bound_ms"], rec["bound_by"] = attention_bound(q, bias)
                if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                    main = rec
            emit(**rec)
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


def serve_phase(task: str):
    """Predictor end to end; returns the kernel's launches in the counted
    run."""
    import numpy as np
    import torch

    from mimrl_tpu_torch.eval.predict import Predictor
    from mimrl_tpu_torch.ops.flash_attention import flash_attention

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
    flash_attention.launches = 0
    t0 = time.perf_counter()
    metrics = predictor.evaluate_split("test")
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    predictor.forward = forward
    require(launches == 12 * n_batches,
            f"flash_attention_fwd launched {launches} times, want 12 x {n_batches}")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metrics {metrics}")
    emit(phase="serve", step="predictor_bf16", metrics=metrics,
         batches=n_batches, kernel_launches=launches,
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
    return launches


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
         libraries={k: str(v.name) for k, v in libs.items()})

    record = kernel_phase()
    with tempfile.TemporaryDirectory() as root:
        task = write_run(root)
        launches = serve_phase(task)

    record.update(name="flash_attention_fwd", route="cuda",
                  source="mimrl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                  replaces="mimrl_tpu/ops/pallas/flash_attention.py:225",
                  launches=launches)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dtype")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}), flush=True)
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
