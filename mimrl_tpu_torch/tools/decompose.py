"""Step-cost decomposition of the port's training step (the counterpart of
``mimrl_tpu/tools/decompose.py``).

Times the steps the Solver runs (``train_step``, ``critic_update``,
``features_step``, ``eval_step`` of ``train/steps.py``) and isolated
pieces: the model's forward in train mode, the task loss's forward and
backward alone (no MI, no optimizer; ``train/losses.py``), BERT's forward
and its forward and backward, and ``ChainOptimizer.step`` alone on the
real state. A train split of 1280 rows gives the feature bank JAX's
1280 rows. Each piece is timed eagerly by CUDA events (``--warmup``
calls, then the median of ``--steps``); the four steps that the
``--epoch_scan`` rung replays (``train/graphs.py::StepGraphs``) are also
timed replayed; and each piece's device busy ms is the union of the
profiler's device records over ``--profile`` calls, per call. Then
``implied samples/s`` = bs / (``train_step`` + ``stage1_n`` x
``critic_update``), as JAX prints it.

The step is built by ``tools/step_time.py::seeded_solver`` at the
canonical MOSI recipe of ``tools/step_time.py`` (BERT-base widths, bi-GRU,
CubeMLP, InfoNCE) over a seeded fixture and a seeded feature bank.
Shapes come from JAX's environment variables: ``BENCH_BS`` (128),
``BENCH_TIME_LEN`` (100), ``BENCH_BERT_LAYERS`` (12), ``BENCH_DTYPE``
(bfloat16), ``BENCH_QUANT`` (none). ``BENCH_RNG_IMPL`` has no
counterpart: the port draws from ``torch.Generator``. ``--use_pallas``
runs the flagged path (with ``BENCH_QUANT=int8``, all four kernels).
Any other argument is passed to the config parser after these, for
example ``--bert_hidden 32 --bert_heads 2`` for a tiny CPU run::

    python -m mimrl_tpu_torch.tools.decompose [--steps 20] [--use_pallas]
    BENCH_BS=4 BENCH_TIME_LEN=12 BENCH_BERT_LAYERS=1 python -m \\
        mimrl_tpu_torch.tools.decompose --device cpu --steps 2 \\
        --bert_hidden 32 --bert_heads 2

It runs on the CUDA card, and raises without one unless ``--device cpu``
asks for the CPU (host clock, no busy ms). Output: JAX's text lines
(``name  ms``, then the implied samples/s), and last one JSON line with
every piece and the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

from mimrl_tpu_torch.tools.step_time import (CANONICAL_MOSI, CANONICAL_TRAIN,
                                             card, device_busy_ms,
                                             seeded_solver)

SHAPE_ENV = (("BENCH_BS", "bs", 128), ("BENCH_TIME_LEN", "time_len", 100),
             ("BENCH_BERT_LAYERS", "bert_layers", 12),
             ("BENCH_DTYPE", "dtype", "bfloat16"), ("BENCH_QUANT", "quant",
                                                    "none"))
PIECES = ("train_step", "critic_update", "features_step", "eval_step",
          "model_fwd_train", "task_fwd_bwd_noopt", "bert_fwd",
          "bert_fwd_bwd", "optimizer_only")
# JAX's decompose seeds a 1280-row bank; here a train split of that size
BANK_ROWS = 1280
# the pieces the --epoch_scan rung replays, by their graphs' names
REPLAYED = {"train_step": "train_step_mi", "critic_update": "critic_update",
            "features_step": "features_step", "eval_step": "eval_step_mi"}


def shape_from_env(env=None) -> Dict:
    env = os.environ if env is None else env
    return {key: type(default)(env.get(var, default))
            for var, key, default in SHAPE_ENV}


def _timer(device) -> Callable:
    """ms of one call of fn: CUDA events around it on the card, the host
    clock after a synchronize on the CPU."""
    import torch

    def ms(fn) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    return ms


def _busy_ms(fn, calls: int, device) -> Optional[float]:
    """Device busy ms per call (``step_time.device_busy_ms``: the union
    of the profiler's device records over ``calls`` calls); None on the
    CPU or where the profiler gives no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda" or calls <= 0:
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    union = device_busy_ms(prof)[0]
    return union / calls if union > 0 else None


def decompose(shape: Dict, steps_n: int = 20, warmup: int = 3,
              profile_calls: int = 3, use_pallas: bool = False,
              device: Optional[str] = None, extra=()) -> Dict:
    """Build the step at ``shape`` and time every piece. Returns
    {"shape", "pieces": {name: {"ms", "busy_ms", "replayed_ms"}},
    "implied_samples_per_s", "implied_samples_per_s_replayed",
    "stage1_n", "peak_gb", "device"}."""
    import torch

    from mimrl_tpu_torch.models.model import forward_batch
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.losses import compute_task_loss

    argv = CANONICAL_MOSI + CANONICAL_TRAIN + [
        "--epoch_scan", "--bert_layers", str(shape["bert_layers"]),
        "--compute_dtype", shape["dtype"], "--quant", shape["quant"]]
    argv += ["--use_pallas"] if use_pallas else []
    argv += list(extra)
    with tempfile.TemporaryDirectory() as root:
        s, mb, labels = seeded_solver(root, argv, shape["bs"],
                                      shape["time_len"],
                                      max(1, BANK_ROWS // shape["bs"]),
                                      device=device)
        o, model, gen = s.opt, s.model, s.generator
        ms = _timer(s.device)
        if s.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(s.device)
        feats = steps.features_step(model, mb, gen)
        bert = model.bertmodel
        text = (mb["bert_sentences"], mb["bert_sentence_types"],
                mb["bert_sentence_att_mask"])
        main_params = s.opt_main.params
        bert_params = list(bert.parameters())

        def model_fwd_train():
            model.train()
            with torch.no_grad():
                return forward_batch(model, mb, generator=gen)

        def task_fwd_bwd_noopt():
            model.train()
            out = forward_batch(model, mb, return_features=False,
                                generator=gen)[0]
            loss = compute_task_loss(o.loss, o.num_class, out, labels,
                                     mb.get("sample_mask"))
            return torch.autograd.grad(loss, main_params, allow_unused=True)

        def bert_fwd():
            bert.train()
            with torch.no_grad():
                return bert(*text, generator=gen)

        def bert_fwd_bwd():
            bert.train()
            return torch.autograd.grad(bert(*text, generator=gen).sum(),
                                       bert_params)

        grads = [(p.detach() * 1e-6).to(p.dtype) for p in main_params]
        offset = torch.zeros((), dtype=torch.int64, device=s.device)
        bodies = {
            "train_step": lambda: steps.train_step(
                model, s.opt_main, o, mb, labels, s.bank, s.new_bank, offset,
                gen, True),
            "critic_update": lambda: steps.critic_update(
                model, s.opt_vmi, o, feats, labels, s.bank, gen),
            "features_step": lambda: steps.features_step(model, mb, gen),
            "eval_step": lambda: steps.eval_step(model, o, mb, labels, s.bank,
                                                 gen, True),
            "model_fwd_train": model_fwd_train,
            "task_fwd_bwd_noopt": task_fwd_bwd_noopt,
            "bert_fwd": bert_fwd,
            "bert_fwd_bwd": bert_fwd_bwd,
            "optimizer_only": lambda: s.opt_main.step(grads),
        }
        # the same four bodies as the rung's graphs hold them
        graph_bodies = {
            "train_step": (lambda batch, labels, offset: steps.train_step(
                model, s.opt_main, o, batch, labels, s.bank, s.new_bank,
                offset, gen, True), dict(batch=mb, labels=labels,
                                         offset=offset)),
            "critic_update": (lambda feats, labels: steps.critic_update(
                model, s.opt_vmi, o, feats, labels, s.bank, gen),
                dict(feats=feats, labels=labels)),
            "features_step": (lambda batch: steps.features_step(
                model, batch, gen), dict(batch=mb)),
            "eval_step": (lambda batch, labels: steps.eval_step(
                model, o, batch, labels, s.bank, gen, True)[:3],
                dict(batch=mb, labels=labels)),
        }

        def timed(fn, least_warmup=0):
            for _ in range(max(warmup, least_warmup)):
                fn()
            return statistics.median(ms(fn) for _ in range(steps_n))

        pieces = {}
        for name in PIECES:
            fn = bodies[name]
            pieces[name] = {"ms": timed(fn),
                            "busy_ms": _busy_ms(fn, profile_calls, s.device),
                            "replayed_ms": None}
            if name in graph_bodies:
                body, inputs = graph_bodies[name]
                replay = lambda: s.graphs(REPLAYED[name], body, **inputs)
                # the first call runs eagerly and captures
                pieces[name]["replayed_ms"] = timed(replay, 1)
                pieces[name]["replayed_busy_ms"] = _busy_ms(
                    replay, profile_calls, s.device)
        peak = (torch.cuda.max_memory_allocated(s.device) / 1e9
                if s.device.type == "cuda" else None)
        stage1_n = o.stage1_n
        s.writer.close()

    def implied(key):
        per_batch = (pieces["train_step"][key]
                     + stage1_n * pieces["critic_update"][key])
        return shape["bs"] / per_batch * 1e3

    return {"shape": dict(shape, use_pallas=use_pallas), "pieces": pieces,
            "implied_samples_per_s": implied("ms"),
            "implied_samples_per_s_replayed": implied("replayed_ms"),
            "stage1_n": stage1_n, "peak_gb": peak,
            "device": str(s.device)}


def report(result: Dict) -> str:
    """JAX's text lines: each piece's ms (eager), then the implied
    samples/s; the replayed ms and busy ms beside them."""
    lines = []
    for name, r in result["pieces"].items():
        extra = []
        if r["replayed_ms"] is not None:
            extra.append(f"replayed {r['replayed_ms']:.2f} ms")
        if r["busy_ms"] is not None:
            extra.append(f"busy {r['busy_ms']:.2f} ms")
        lines.append(f"{name:22s} {r['ms']:8.2f} ms"
                     + (f"  ({', '.join(extra)})" if extra else ""))
    n = result["stage1_n"]
    lines.append(f"{'implied samples/s':22s} "
                 f"{result['implied_samples_per_s']:8.1f}  (train_step + "
                 f"{n}x critic_update; replayed "
                 f"{result['implied_samples_per_s_replayed']:.1f})")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--profile", type=int, default=3,
                   help="calls per piece under the profiler (0: no busy ms)")
    p.add_argument("--use_pallas", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args, extra = p.parse_known_args(argv)
    result = decompose(shape_from_env(), args.steps, args.warmup,
                       args.profile, args.use_pallas, args.device, extra)
    print(report(result), flush=True)
    result["card"] = card() if result["device"].startswith("cuda") else None
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
