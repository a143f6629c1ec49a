"""A run stopped by SIGTERM and resumed equals the run that was never
stopped, bit for bit, on the CPU.

Three runs of ``mimrl_tpu_torch.cli.main`` on the tiny config of
test_torch_solver.py with dropout on, two critic passes, three epochs, a
``latest`` slot every epoch and a learning-rate milestone at epoch 2 (so
the schedule's restored state matters inside the run): A goes through;
B receives a real SIGTERM in epoch 1 and stops after it; C resumes B for
epoch 2. C's final slot (weights, both optimizers' moments, the feature
bank, the schedule, the loader's passes, the generators) and its epoch-2
telemetry equal A's; the same holds for the ``--epoch_scan`` rung, whose
epochs are dispatched ahead of their host work. Three faulty resumes, each
leaving one piece of the state out, must each end with other weights.
Slots the port cannot read (a ``mimrl_tpu`` msgpack ``latest``, orbax
directories) are refused by name, as is ``--ckpt_backend orbax``.
"""

import json
import os
import signal

import pytest
import torch

from mimrl_tpu_torch.cli.main import main
from mimrl_tpu_torch.core.checkpoint import CheckpointManager
from mimrl_tpu_torch.core.config import parse_args
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.train.optim import LRScheduler
from mimrl_tpu_torch.train.solver import Solver
from test_torch_solver import N_TEST, N_TRAIN, N_VALID, _argv

# one intra-op thread: more threads may split a sum differently from one
# run to the next on a loaded machine
torch.set_num_threads(1)

EXTRA = ["--epochs_num", "3", "--save_latest_every", "1",
         "--lr_decrease_iter", "2-60"]


def _same(a, b) -> bool:
    """Bit-equal trees of tensors and plain values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


def _scalars(task, step):
    rows = [json.loads(line) for line in open(f"{task}/scalars.jsonl")]
    return [(r["tag"], r["value"]) for r in rows if r["step"] == step]


def test_resume_equals_uninterrupted(tmp_path, monkeypatch):
    root = str(tmp_path)
    make_dec_fixture(f"{root}/data", "mosi",
                     n_per_split=(N_TRAIN, N_VALID, N_TEST), d_audio=5,
                     d_video=20, max_len=15, seed=2)
    runs = f"{root}/runs"

    def run(name, *flags):
        main(_argv(root, "--task_name", name, *EXTRA, *flags))
        return CheckpointManager(f"{runs}/{name}").restore("latest")

    a = run("A")
    assert a["epoch"] == 2

    # B: a real SIGTERM in epoch 1; the run's handler takes it, the epoch
    # ends, latest is written, and the previous handlers are back
    calls = []

    def sentinel(signum, frame):
        calls.append(signum)

    train = Solver.train

    def train_with_sigterm(self, epoch):
        if epoch == 1:
            signal.raise_signal(signal.SIGTERM)
        return train(self, epoch)

    prev_term = signal.signal(signal.SIGTERM, sentinel)
    prev_int = signal.getsignal(signal.SIGINT)
    try:
        with monkeypatch.context() as m:
            m.setattr(Solver, "train", train_with_sigterm)
            b = run("B")
        assert signal.getsignal(signal.SIGTERM) is sentinel
        assert signal.getsignal(signal.SIGINT) is prev_int
    finally:
        signal.signal(signal.SIGTERM, prev_term)
    assert not calls
    assert b["epoch"] == 1 and b["have_bank"]
    assert {s for s in range(3) if _scalars(f"{runs}/B", s)} == {0, 1}
    assert "Preemption requested" in open(f"{runs}/B/Running.log").read()

    # C: resume B for epoch 2; everything equals A
    c = run("C", "--resume", f"{runs}/B")
    assert _same(c, a), [k for k in a if not _same(a[k], c[k])]
    # milestone 2 cut the rate after epoch 1, and the cut carried over
    assert c["lr_schedule"] == {"kind": "multi_step",
                                "factor": pytest.approx(0.1), "epoch": 3}
    assert _scalars(f"{runs}/C", 2) == _scalars(f"{runs}/A", 2)
    assert not _scalars(f"{runs}/C", 1)

    # the --epoch_scan rung (pipelined): a SIGTERM while epoch 1 is
    # dispatched stops the run after it, and the resumed run equals the
    # uninterrupted rung run
    dispatch = Solver._train_epoch_scan_dispatch

    def dispatch_with_sigterm(self, epoch):
        if epoch == 1:
            signal.raise_signal(signal.SIGTERM)
        return dispatch(self, epoch)

    scan_a = run("scan_A", "--epoch_scan")
    with monkeypatch.context() as m:
        m.setattr(Solver, "_train_epoch_scan_dispatch", dispatch_with_sigterm)
        scan_b = run("scan_B", "--epoch_scan")
    assert scan_b["epoch"] == 1 and scan_b["loader_passes"] == 2
    scan_c = run("scan_C", "--epoch_scan", "--resume", f"{runs}/scan_B")
    assert _same(scan_c, scan_a), [k for k in scan_a
                                   if not _same(scan_a[k], scan_c[k])]
    assert _scalars(f"{runs}/scan_C", 2) == _scalars(f"{runs}/scan_A", 2)
    assert not _same(scan_a["model"], a["model"])  # one shuffle an epoch

    # faulty resumes: each leaves one piece of the state out
    resume = Solver._resume

    def loader_passes_at_zero(self):
        self.train_loader.passes = 0

    def generator_unrestored(self):
        self.generator.manual_seed(self.opt.seed)

    def critic_moments_zeroed(self):
        for t in self.opt_vmi.state():
            t.zero_()

    for fault in (loader_passes_at_zero, generator_unrestored,
                  critic_moments_zeroed):
        def faulty_resume(self, resume_dir, fault=fault):
            resume(self, resume_dir)
            fault(self)

        with monkeypatch.context() as m:
            m.setattr(Solver, "_resume", faulty_resume)
            f = run(fault.__name__, "--resume", f"{runs}/B")
        assert f["epoch"] == 2
        assert not _same(f["model"], a["model"]), fault.__name__
        assert _scalars(f"{runs}/{fault.__name__}", 2) != _scalars(
            f"{runs}/A", 2), fault.__name__

    # --resume at a directory without a slot starts fresh; a directory with
    # only a mimrl_tpu latest slot is refused
    os.makedirs(f"{root}/empty")
    fresh = Solver(parse_args(_argv(root, "--task_name", "fresh", *EXTRA,
                                    "--resume", f"{root}/empty")))
    fresh.writer.close()
    assert fresh.start_epoch == 0 and not fresh.have_bank
    assert "fresh start" in open(f"{runs}/fresh/Running.log").read()
    # a state of other parameters, fields or kind is refused
    with pytest.raises(ValueError, match="other parameters"):
        fresh.opt_vmi.load_state_dict(a["opt_main"])
    with pytest.raises(ValueError, match="bank field C"):
        fresh.bank.load_state_dict({**a["bank"], "C": a["bank"]["C"][:1]})
    with pytest.raises(ValueError, match="plateau"):
        fresh.lr_schedule.load_state_dict({**a["lr_schedule"],
                                           "kind": "plateau"})
    # the plateau schedule's state carries its best and bad epochs
    plateau = parse_args(_argv(root, "--lr_decrease", "plateau",
                               "--lr_decrease_iter", "1"))
    one, two = LRScheduler(plateau), LRScheduler(plateau)
    for metric in (0.5, 0.4, 0.6):
        one.step(metric)
    two.load_state_dict(one.state_dict())
    assert [one.step(m) for m in (0.7, 0.3)] == [two.step(m) for m in (0.7, 0.3)]
    assert one.state_dict() == two.state_dict() and one.factor < 1
    open(f"{root}/empty/latest_model.msgpack", "wb").close()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Solver(parse_args(_argv(root, "--task_name", "jax", *EXTRA,
                                "--resume", f"{root}/empty")))
    # a mimrl_tpu run of --ckpt_backend orbax holds only orbax directories:
    # --resume and Predictor name the slot instead of starting fresh; the
    # port writes no orbax slot, so the flag is refused
    orbax = f"{root}/orbax"
    os.makedirs(f"{orbax}/latest_model.orbax")
    os.makedirs(f"{orbax}/best_valid_model.orbax")
    with open(f"{orbax}/config.json", "w") as f:
        f.write(open(f"{runs}/A/config.json").read())
    for refused in (
            lambda: Solver(parse_args(_argv(root, "--task_name", "orbax",
                                            *EXTRA, "--resume", orbax))),
            lambda: Predictor(orbax, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="best_valid_model.orbax|latest_model.orbax"):
            refused()
    with pytest.raises(NotImplementedError, match="--ckpt_backend orbax"):
        Solver(parse_args(_argv(root, "--task_name", "orbax",
                                "--ckpt_backend", "orbax")))
