"""Serving traffic: one closed-loop client scores a split through
``eval/predict.py::Predictor``, cycling it: each batch goes to
``Predictor.forward`` when the loader hands it over, and its output is
copied to the host, as ``Predictor.predict_loader`` does, before the next
batch goes. A batch's latency runs from the hand-over to the output on the
host.

Set-up writes a run directory (the configuration and a model slot of the
benchmark's seeded weights), loads it into a Predictor, and scores the
split once, which builds and warms every kernel of the window's shape.
After the window the Predictor is freed and the reference scores a seeded
sample of the window's batches with the same weights.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict

import numpy as np
import torch

from benchmark import fixture, harness, trace
from benchmark.reference import data as rdata
from benchmark.reference import model as M
from benchmark.reference import train as rtrain


def run(ctx) -> Dict:
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.eval.predict import Predictor

    args, cfg, mix = ctx.args, ctx.config, ctx.mix
    seed = args.seed
    flags = ctx.flags()
    ds = cfg["dataset"]
    spec = M.Spec(flags, ds["d_audio"], ds["d_video"])
    split_name = mix["split"]

    # set-up: the data set, the run directory, the Predictor
    utts = fixture.utterances(ds, seed)
    data_dir = os.path.join(ctx.scratch, "data")
    fixture.write(data_dir, ds, utts)
    task_dir = os.path.join(ctx.scratch, "run")
    os.makedirs(task_dir, exist_ok=True)
    opt = parse_args(harness.flag_argv(flags) + [
        "--seed", str(seed), "--data_dir", data_dir])
    with open(os.path.join(task_dir, "config.json"), "w") as f:
        f.write(opt.to_json())
    weights = harness.make_weights(M.param_shapes(spec), seed, ctx.device,
                                 cfg.get("weights_fixed"))
    torch.save(weights, os.path.join(task_dir, "best_valid_model.pt"))
    weights_host = {n: w.detach().cpu() for n, w in weights.items()}
    del weights
    pred = Predictor(task_dir, slot="best_valid", device=str(ctx.device))
    for d in (data_dir, task_dir):
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
    if ctx.fault is not None:
        ctx.fault(ctx, pred)
    loader = getattr(pred, f"{split_name}_loader")
    for batch in loader:  # warm-up: every batch of the window's shape
        pred.forward(batch).float().cpu()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t_setup = time.perf_counter() - ctx.t_start

    # the window
    seconds = 0.0 if args.control else args.seconds
    lat, enq, outs, n_real = [], [], [], 0
    session = trace.Session(ctx.device) if args.trace else None
    if session is not None:
        session.start()
    t0 = time.perf_counter()
    with trace.span("window"):
        batches, i = iter(loader), 0
        while True:
            with trace.span("loader"):
                batch = next(batches, None)
                if batch is None:  # the split again, in the same order
                    batches, i = iter(loader), 0
                    batch = next(batches)
            with trace.span("forward"):
                t_ready = time.perf_counter()
                out = pred.forward(batch)
                t_enq = time.perf_counter()
            with trace.span("to_host"):
                host = out.float().cpu()
            t_done = time.perf_counter()
            lat.append(t_done - t_ready)
            enq.append(t_enq - t_ready)
            n_real += int((batch["sample_mask"] > 0.5).sum())
            outs.append((i, host))
            i += 1
            if t_done - t0 >= seconds:
                break
    t_window = t_done - t0
    if session is not None:
        session.stop()
    device = harness.device_info(ctx.device)
    tr = session.reduce() if session is not None else None

    # the reference on a seeded sample of the window's batches
    del pred, session, loader
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    split = rdata.Split(utts[split_name], spec.T, spec.vocab)
    del utts
    idx, mask = rdata.plan(split.n, spec.bs, 0, False)
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(outs), min(len(outs),
                                             int(mix["sample_batches"])),
                              replace=False))
    P = {n: w.to(ctx.device) for n, w in weights_host.items()}

    def scores(tf32: bool):
        if ctx.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        return rtrain.outputs(P, spec, [split.batch(idx[outs[j][0]],
                                                    mask[outs[j][0]],
                                                    ctx.device)
                                        for j in picks])

    ref = scores(False)
    if args.control and cfg["control"].get("tf32"):
        got = scores(True)  # the reference in TF32 in the system's place
    else:
        got = [outs[j][1] for j in picks]
    a, b = torch.cat(got), torch.cat(ref)
    numbers = {
        # the widest gap of a batch against the batch's RMS, and the RMS gap
        "serve_outputs": max(float((x - y).abs().max()
                                   / y.square().mean().sqrt())
                             for x, y in zip(got, ref)),
        "serve_outputs_rms": float((a - b).square().mean().sqrt()
                                   / b.square().mean().sqrt())}
    notes = [f"reference s: {time.perf_counter() - t_ref!r}"]
    notes += [f"number {k}: {v!r}" for k, v in numbers.items()]
    limits = ctx.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    lat_ms = np.asarray(lat) * 1e3
    return {"e2e": {"serve_samples_per_s": n_real / t_window,
                    "serve_batch_ms_p95": float(np.percentile(lat_ms, 95)),
                    "setup_s": t_setup,
                    "peak_mem_gb": device["memory_peak_bytes"] / 1e9},
            "checks": checks, "attempted": len(outs), "failed": 0,
            "device": device, "trace": tr, "flags": flags,
            "counts": {"batches": len(outs), "serve_samples": n_real,
                       "enqueue_ms": float(np.mean(enq) * 1e3)},
            "window_s": t_window, "notes": notes}
