"""The canonical bf16 recipe's train step on the card, eager and replayed.

Times one checkout's ``mimrl_tpu_torch`` (``--package``, default the one
beside this file) at the canonical shapes (BERT-base, bs 128, T 100,
bfloat16, the canonical MOSI flags below, which ``chip_smoke.py`` and
``tools/decompose.py`` share, ``--epoch_scan``) on a
seeded fixture and a seeded random feature bank, so that two checkouts
can be compared on one card within one call (parent, change, change,
parent)::

    python mimrl_tpu_torch/tools/step_time.py --package DIR --label NAME

Prints one JSON line: the eager ``train_step`` (with MI) and
``critic_step`` ms (CUDA events around each call, median of ``--reps``
after 3 warm-up calls; the eager step is host-bound, so this is the
step's span, launches included), the replayed stage-2 epoch's ms per
train step (``train_epoch`` on the Solver's step graphs, median of 5
epochs), the peak memory allocated, and the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# the canonical recipe: BERT-base, bs 128, T 100, bfloat16
BATCH, TIME_LEN = 128, 100
N_TRAIN = 3 * BATCH  # 3 train batches
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


def device_busy_ms(prof) -> tuple:
    """(union, sum) of a profile's device records in ms: the time the
    device was busy at all (kernels on concurrent streams, as the A/V
    pair's, counted once) and the sum of the records' own times."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    union, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            union += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    union += 0.0 if end is None else end - start
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return union / 1e3, total / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", default=ROOT,
                   help="the checkout whose mimrl_tpu_torch is timed")
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=15)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package))

    import torch

    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 1
    import mimrl_tpu_torch
    from mimrl_tpu_torch.train import steps

    with tempfile.TemporaryDirectory() as root:
        s, mb, labels = seeded_solver(
            root, CANONICAL_MOSI + CANONICAL_TRAIN + ["--epoch_scan"],
            BATCH, TIME_LEN, N_TRAIN // BATCH)
        o = s.opt
        torch.cuda.reset_peak_memory_stats()
        record = dict(
            label=args.label,
            package=os.path.dirname(os.path.abspath(mimrl_tpu_torch.__file__)),
            train_step_ms=cuda_ms(lambda: steps.train_step(
                s.model, s.opt_main, o, mb, labels, s.bank, s.new_bank, 0,
                s.generator, True), 3, args.reps),
            critic_step_ms=cuda_ms(lambda: steps.critic_step(
                s.model, s.opt_vmi, o, mb, labels, s.bank, s.generator),
                3, args.reps))
        batches, labels_e, _, _ = s._stack_epoch(s.train_loader)
        nb = labels_e.shape[0]

        def epoch():
            steps.train_epoch(s.model, s.opt_main, o, batches, labels_e,
                              s.bank, s.new_bank, s.generator, True,
                              run=s.graphs)

        record["replayed_train_step_ms"] = cuda_ms(epoch, 2, 5) / nb
        record["replayed_steps_per_epoch"] = nb
        record["graphs"] = s.graphs.stats()
        record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        s.writer.close()
    record["card"] = card()
    print(json.dumps(record), flush=True)
    return 0


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def seeded_solver(root: str, argv, batch_size: int, time_len: int,
                  n_batches: int, device=None, bank_seed: int = 5):
    """A ``Solver`` for ``argv`` (parsed as the CLI's flags, later flags
    winning) over a seeded DeclareLab fixture under ``root``
    (``n_batches`` train batches of ``batch_size`` and one valid and one
    test batch, audio 5 and video 20 wide, ``time_len + 1`` frames), with
    its feature bank filled from a seeded generator and marked present,
    and the first train batch on its device. Returns (solver, device
    batch, device labels); the model is in train mode."""
    import torch

    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.train.solver import Solver

    data = os.path.join(root, "data")
    make_dec_fixture(data, "mosi", n_per_split=(n_batches * batch_size,
                                                batch_size, batch_size),
                     d_audio=5, d_video=20, max_len=time_len + 1, seed=1)
    cfg = parse_args(list(argv) + [
        "--batch_size", str(batch_size), "--time_len", str(time_len),
        "--data_dir", data, "--task_dir", os.path.join(root, "runs"),
        "--task_name", "step_time", "--no_save_models"])
    s = Solver(cfg, device=device)
    g = torch.Generator(s.device).manual_seed(bank_seed)
    for t in s.bank.tensors()[:5]:
        t.copy_(torch.randn(t.shape, device=s.device, generator=g))
    s.have_bank = True
    mb, labels, _ = s._prep(next(iter(s.train_loader)))
    s.model.train()
    return s, mb, labels


if __name__ == "__main__":
    sys.exit(main())
