"""The canonical bf16 recipe's train step on the card, eager and replayed.

Times one checkout's ``mimrl_tpu_torch`` (``--package``, default the one
beside this file) at ``chip_smoke.py``'s canonical shapes (BERT-base, bs
128, T 100, bfloat16, the canonical MOSI flags, ``--epoch_scan``) on a
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
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _smoke():
    """``chip_smoke.py`` of this checkout: its canonical flags and timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_shapes", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", default=ROOT,
                   help="the checkout whose mimrl_tpu_torch is timed")
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=15)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package))
    cs = _smoke()

    import torch

    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 1
    import mimrl_tpu_torch
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.data.synthetic import make_dec_fixture
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        make_dec_fixture(data, "mosi", n_per_split=(cs.N_TRAIN, cs.BATCH,
                                                    cs.BATCH),
                         d_audio=5, d_video=20, max_len=cs.TIME_LEN + 1,
                         seed=1)
        cfg = parse_args(cs.CANONICAL_MOSI + cs.CANONICAL_TRAIN + [
            "--data_dir", data, "--task_dir", os.path.join(root, "runs"),
            "--task_name", "step_time", "--epoch_scan", "--no_save_models"])
        s = Solver(cfg)
        g = torch.Generator("cuda").manual_seed(5)
        for t in s.bank.tensors()[:5]:
            t.copy_(torch.randn(t.shape, device="cuda", generator=g))
        s.have_bank = True
        o = s.opt
        mb, labels, _ = s._prep(next(iter(s.train_loader)))
        s.model.train()
        torch.cuda.reset_peak_memory_stats()
        record = dict(
            label=args.label,
            package=os.path.dirname(os.path.abspath(mimrl_tpu_torch.__file__)),
            train_step_ms=cs.cuda_ms(lambda: steps.train_step(
                s.model, s.opt_main, o, mb, labels, s.bank, s.new_bank, 0,
                s.generator, True), 3, args.reps),
            critic_step_ms=cs.cuda_ms(lambda: steps.critic_step(
                s.model, s.opt_vmi, o, mb, labels, s.bank, s.generator),
                3, args.reps))
        batches, labels_e, _, _ = s._stack_epoch(s.train_loader)
        nb = labels_e.shape[0]

        def epoch():
            steps.train_epoch(s.model, s.opt_main, o, batches, labels_e,
                              s.bank, s.new_bank, s.generator, True,
                              run=s.graphs)

        record["replayed_train_step_ms"] = cs.cuda_ms(epoch, 2, 5) / nb
        record["replayed_steps_per_epoch"] = nb
        record["graphs"] = s.graphs.stats()
        record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        s.writer.close()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    record["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
