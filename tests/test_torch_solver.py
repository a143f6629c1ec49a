"""The port's training entry point end to end on the CPU: a hermetic
two-epoch run through ``mimrl_tpu_torch.cli.main`` on a synthetic
DeclareLab split (tiny widths, 3 train batches of 8 whose last one is
cycle-padded). Epoch 0 is stage 2 without MI, epoch 1 is stage 1 (two
critic passes) and stage 2 with MI. The artifacts exist, the telemetry has
the reference's channels, and ``Predictor`` loads the ``best_valid`` slot
the run wrote, and its ``latest`` slot holds the whole training state.
Flags whose path is not ported raise; the two kernel flags
(``--use_pallas``, ``--quant``) train and serve through the plain versions.
"""

import json
import os

import numpy as np
import pytest
import torch

from mimrl_tpu_torch.cli.main import main
from mimrl_tpu_torch.core.checkpoint import CheckpointManager
from mimrl_tpu_torch.core.config import parse_args
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.train.solver import MI_NAMES, Solver

torch.set_num_threads(1)

N_TRAIN, N_VALID, N_TEST, BS = 21, 8, 11, 8


def _argv(root, *extra):
    return ("--task_name run --dataset mosi_Dec --normalize 0-1-1 "
            f"--batch_size {BS} --d_common 16 --time_len 12 "
            "--d_hiddens 12-3-16=4-3-16 --d_outs 12-3-16=4-3-16 "
            "--dropout_mlp 0.0-0.0-0.0 --dropout 0.1-0.1-0.1-0.1 --bias "
            "--res_project 1-1 --loss_mi_coefficient1 1-1-1-1-1-1-1-1-1-1-1 "
            "--loss_mi_coefficient2 0.01-0.01-0.01-0.01-0.01-0.01-0.01-0.01 "
            "--k_neighbor 2 --stage1_n 2 --epochs_num 2 --gradient_clip 1.5 "
            "--bert_lr_rate 0.01 --lr_decrease multi_step --lr_decrease_iter 1-60 "
            "--bert_layers 2 --bert_heads 2 --bert_hidden 32 "
            f"--data_dir {root}/data --task_dir {root}/runs --device cpu"
            ).split() + list(extra)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(root, task dir, best scores) of one two-epoch run."""
    root = str(tmp_path_factory.mktemp("train"))
    make_dec_fixture(f"{root}/data", "mosi",
                     n_per_split=(N_TRAIN, N_VALID, N_TEST), d_audio=5,
                     d_video=20, max_len=15, seed=2)
    scores = main(_argv(root, "--save_best_features"))
    return root, f"{root}/runs/run", scores


def test_run_writes_its_artifacts(run):
    _, task, scores = run
    assert len(scores) == 3 and all(np.isfinite(s["mae"]) for s in scores)
    want = {"Running.log", "config.json", "scalars.jsonl",
            "best_valid_model.pt", "best_test_model.pt", "latest_model.pt",
            "predictions_val.npy", "predictions_test.npy",
            "predictions_test_for_valid.npy", "targets_val.npy",
            "targets_test.npy", "features_val.pkl", "features_test.pkl",
            "features_test_for_valid.pkl"}
    assert want <= set(os.listdir(task))
    assert np.load(f"{task}/predictions_val.npy").shape == (N_VALID, 1)
    assert np.load(f"{task}/predictions_test.npy").shape == (N_TEST, 1)
    assert np.load(f"{task}/targets_test.npy").shape[0] == N_TEST
    log = open(f"{task}/Running.log").read()
    assert "Epoch:[  2]" in log and "Best Valid Score" in log
    assert "TrainMI_ft/fa/fv/in/st/sa/sv/cp:[" in log
    assert "pass1:[" in log and "pass2:[" in log  # two critic passes in epoch 1


def test_epoch_zero_has_no_mi_and_epoch_one_does(run):
    _, task, _ = run
    rows = [json.loads(line) for line in open(f"{task}/scalars.jsonl")]
    mi = {step: [r["value"] for r in rows if r["step"] == step
                 and r["tag"] in [f"Train/MI_{n}" for n in MI_NAMES]]
          for step in (0, 1)}
    assert len(mi[0]) == len(mi[1]) == 8
    assert all(v == 0.0 for v in mi[0])
    assert any(v != 0.0 for v in mi[1]) and np.isfinite(mi[1]).all()
    finite = [r["value"] for r in rows]
    assert np.isfinite(finite).all()
    # the schedule steps at the end of an epoch, before the rate is logged
    # (ref: Solver.py:52-57): milestone 1 cuts the base rate 4e-3 tenfold
    lr = [r["value"] for r in rows if r["tag"] == "Lr"]
    assert lr == pytest.approx([4e-4, 4e-4])


def test_predictor_loads_the_best_valid_slot(run):
    _, task, scores = run
    predictor = Predictor(task, device="cpu")
    got = predictor.evaluate_split("valid")
    assert got["mae"] == pytest.approx(scores[0]["mae"], rel=1e-5)
    preds, _ = predictor.predict_loader(predictor.valid_loader)
    np.testing.assert_allclose(preds, np.load(f"{task}/predictions_val.npy"),
                               rtol=1e-5, atol=1e-5)
    # the slots hold the whole training state: the whole model, the
    # estimator bank included, the optimizers, the feature bank, the
    # schedule, the loader's passes and the random generators
    slot = CheckpointManager(task).restore("latest")
    assert set(slot) == {"format", "epoch", "model", "opt_main", "opt_vmi",
                         "bank", "have_bank", "lr_schedule", "loader_passes",
                         "rng"}
    assert slot["epoch"] == 1 and slot["have_bank"]
    state = slot["model"]
    assert set(state) == set(predictor.model.state_dict())
    assert any(k.startswith("vcmi_estimator_tc_v.") for k in state)


def test_two_runs_of_one_seed_agree(run):
    """Weights, batches, kNN anchors and dropout all derive from --seed."""
    root, task, scores = run
    again = main(_argv(root, "--task_name", "again", "--no_save_models"))
    assert again[0]["mae"] == pytest.approx(scores[0]["mae"], rel=1e-6)
    assert not os.path.exists(f"{root}/runs/again/best_valid_model.pt")
    other = main(_argv(root, "--task_name", "other", "--seed", "1",
                       "--no_save_models"))
    assert other[0]["mae"] != pytest.approx(scores[0]["mae"], rel=1e-6)


@pytest.mark.parametrize("flags", [
    ["--epoch_scan"], ["--fast_stage1"], ["--epoch_scan", "--stage1_cached"],
    ["--epoch_group", "2"], ["--check_gradient"],
    ["--custom_loss", "mod:fn"], ["--mesh_model", "2"], ["--mesh_data", "4"],
    ["--fusion", "tfn"], ["--encoders", "lstm"], ["--profile_dir", "x"],
    ["--distributed"]])
def test_unported_flags_raise(run, flags):
    root = run[0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Solver(parse_args(_argv(root, "--task_name", "refused", *flags)))


@pytest.mark.parametrize("flags,error", [
    (["--optm", "SAM"], NotImplementedError)])
def test_unported_kernels_and_sam_raise(run, flags, error):
    with pytest.raises(error):
        main(_argv(run[0], "--task_name", "refused", *flags))


@pytest.mark.parametrize("flags", [
    ["--use_pallas"], ["--quant", "int8"], ["--quant", "int8_fwd"],
    ["--use_pallas", "--quant", "int8_all"]])
def test_kernel_flags_train_and_serve_on_the_cpu(run, flags):
    """``--use_pallas`` and ``--quant int8*`` no longer raise: a two-epoch
    run (stage 2, then stage 1 + stage 2 with MI) goes through the plain
    versions of the two kernels on the CPU, and ``Predictor`` loads its
    checkpoint with the flags the run recorded and repeats its score."""
    root = run[0]
    name = "flags_" + "_".join(f.strip("-") for f in flags)
    scores = main(_argv(root, "--task_name", name, *flags))
    assert all(np.isfinite(v) for s in scores for v in s.values())
    rows = [json.loads(line) for line in open(f"{root}/runs/{name}/scalars.jsonl")]
    assert np.isfinite([r["value"] for r in rows]).all()
    mi = [r["value"] for r in rows if r["step"] == 1
          and r["tag"].startswith("Train/MI_")]
    assert len(mi) == 8 and any(v != 0.0 for v in mi)
    predictor = Predictor(f"{root}/runs/{name}", device="cpu")
    assert predictor.cfg.use_pallas == ("--use_pallas" in flags)
    assert predictor.cfg.quant == (flags[-1] if "--quant" in flags else "none")
    encoder = predictor.model.mlp_encoder.layers_stack[0]
    assert encoder.mlp_l.use_pallas == encoder.mlp_d.use_pallas == (
        "--use_pallas" in flags)
    assert predictor.model.bertmodel.config.quant == predictor.cfg.quant
    got = predictor.evaluate_split("valid")
    assert got["mae"] == pytest.approx(scores[0]["mae"], rel=1e-5)


def test_kernel_flags_keep_parameter_names(run):
    """The flags change routes, not parameters: a checkpoint written
    without them loads strictly with them (``Predictor`` loads strictly),
    and the quantised model's score moves away from the float32 one."""
    _, task, scores = run
    flagged = Predictor(task, device="cpu", config_overrides={
        "use_pallas": True, "quant": "int8"})
    got = flagged.evaluate_split("valid")
    assert np.isfinite(got["mae"])
    assert got["mae"] == pytest.approx(scores[0]["mae"], rel=0.2)
    assert got["mae"] != pytest.approx(scores[0]["mae"], rel=1e-7)


def test_solver_needs_cuda_unless_asked(run, monkeypatch):
    argv = [a for a in _argv(run[0], "--task_name", "nocard")
            if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(parse_args(argv))
    # the caller's device wins over the config's
    solver = Solver(parse_args(argv), device="cpu")
    assert next(solver.model.parameters()).device.type == "cpu"
    assert solver.generator.device.type == "cpu"
    solver.writer.close()
