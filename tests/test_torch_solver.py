"""The port's training entry point end to end on the CPU: a hermetic
two-epoch run through ``mimrl_tpu_torch.cli.main`` on a synthetic
DeclareLab split (tiny widths, 3 train batches of 8 whose last one is
cycle-padded). Epoch 0 is stage 2 without MI, epoch 1 is stage 1 (two
critic passes) and stage 2 with MI. The artifacts exist, the telemetry has
the reference's channels, and ``Predictor`` loads the ``best_valid`` slot
the run wrote, and its ``latest`` slot holds the whole training state.
``--custom_loss``, ``--check_gradient`` and ``--profile_dir`` train
together (``test_hooks_train_on_the_cpu``). ``--epoch_group 2`` equals
the per-epoch ``--epoch_scan`` run bit for bit, and the parity harness
gives JAX's report (``test_epoch_group_equals_per_epoch``). The two
kernel flags (``--use_pallas``, ``--quant``) train and serve through the
plain versions. (``--mesh_pipe`` trains in test_torch_parallel.py.)

The schedule rungs (``test_rungs``): each stage-1 mode's epoch function,
then ``train_epoch`` and ``eval_epoch``, against the JAX package's epoch
programs (``StepFactory``) from the same weights, stacked batches, bank
and kNN anchors (the ones JAX draws, injected), with dropout 0, SGD and
plain XLA / PyTorch attention on both sides (the attention kernels' parity
is held in test_torch_steps.py); and ``cli.main`` for 3 epochs on the rung,
whose ``scalars.jsonl`` ``--no_pipeline_epochs`` repeats exactly. Two
of its cases also train another dataset family per batch and on
``--epoch_scan`` (``_family_runs``): ``mosi_50`` (dense text, no BERT,
with ``Predictor`` serving the run) and AVEC2019 (random words drawn
anew each pass, also in the stacked epochs of ``--epoch_scan``).
Tolerances: losses, MI values, outputs, bank rows and features 1e-4, as in
test_torch_steps.py; parameters 1e-5 after the 6 critic updates or 3 train
updates of a stage (SGD holds every entry; a step's 2e-6 grows with the
steps). Eval runs at the initial weights and reads the seeded bank: at the
updated weights a few fused features moved by up to 6.5e-4, and the new
bank's rows (the tiny model's features) hold near-ties of the kNN order.
"""

import json
import os

import jax
import jax.numpy as jnp

import numpy as np
import pytest
import torch

from mimrl_tpu.train import optim as joptim
from mimrl_tpu.train import steps as jsteps
from mimrl_tpu_torch.cli.main import main
from mimrl_tpu_torch.core.checkpoint import CheckpointManager
from mimrl_tpu_torch.core.config import parse_args
from mimrl_tpu_torch.data.synthetic import (make_avec_fixture,
                                            make_dec_fixture,
                                            make_local_fixture)
from mimrl_tpu_torch.data.universal import (get_data_loader,
                                            get_label_from_datas)
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.train import steps
from mimrl_tpu_torch.train.solver import MI_NAMES, Solver
from test_torch_steps import (BS as S_BS, D_C, MAIN_GROUPS, N_BANK, N_VALID, Pair,
                              _batch, _jax_anchors)

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
    # (and --num_workers 0, stage 2 without its background thread)
    again = main(_argv(root, "--task_name", "again", "--no_save_models",
                       "--num_workers", "0"))
    assert again[0]["mae"] == pytest.approx(scores[0]["mae"], rel=1e-6)
    assert not os.path.exists(f"{root}/runs/again/best_valid_model.pt")
    other = main(_argv(root, "--task_name", "other", "--seed", "1",
                       "--no_save_models"))
    assert other[0]["mae"] != pytest.approx(scores[0]["mae"], rel=1e-6)


GROUP_RUNS = {  # name -> (dataset flags or None, other flags)
    # a 5-epoch DeclareLab run (MAE): epoch 0, then groups (1, 2), (3, 4)
    "mae": (None, ["--save_best_features"]),
    # the plateau schedule stepped on the device, with --stage1_cached
    "plateau": (None, ["--lr_decrease", "plateau", "--lr_decrease_iter", "1",
                       "--lr_decrease_rate", "0.5", "--stage1_cached"]),
    # without best slots the device's best still starts from epoch 0's score
    "acc": ("mosi_50", ["--task", "classification", "--num_class", "2",
                        "--loss", "CE", "--save_best_features",
                        "--no_save_models"]),
    # random words drawn for every split and epoch up front
    "ccc": ("avec2019", []),
}


def _selection_matches_jax():
    """``steps.selection_metric`` against the JAX package's metric
    functions on seeded predictions, and a sequence of decisions by
    ``selection_better`` against its ``current_result_better``."""
    from mimrl_tpu.eval import metrics as jmetrics

    rng = np.random.default_rng(3)
    for sel, (task, num_class, dataset, key) in {
            "mae": ("regression", 1, "mosi_Dec", "mae"),
            "ccc": ("regression", 1, "avec2019", "ccc"),
            "acc": ("classification", 2, "mosi_50", "2-class_acc"),
            "acc1": ("classification", 1, "mosi_50", "1-class_acc")}.items():
        best, best_score = None, None
        for _ in range(6):
            mask = (rng.uniform(size=(3, 8)) > 0.2).astype(np.float32)
            width = num_class if num_class > 1 else 1
            outs = rng.normal(size=(3, 8, width)).astype(np.float32)
            labels = (rng.integers(0, 2, size=(3, 8)) if task ==
                      "classification" else rng.normal(size=(3, 8)))
            labels = labels.astype(np.float32)
            keep = mask.reshape(-1) > 0.5
            preds = outs.reshape(-1, width)[keep]
            score = jmetrics.get_score_from_result(
                preds, labels.reshape(-1)[keep], dataset, task, num_class)
            metric = steps.selection_metric(
                sel[:3], torch.from_numpy(outs), torch.from_numpy(labels),
                torch.from_numpy(mask))
            assert metric.dtype == torch.float32
            assert metric.item() == pytest.approx(score[key], rel=1e-5,
                                                  abs=1e-6), sel
            want = jmetrics.current_result_better(best_score, score, task,
                                                  num_class, dataset)
            got = best is None or bool(steps.selection_better(
                sel[:3], metric, best))
            assert got == want, sel
            if want:
                best, best_score = metric, score


def _group_argv(root, name, dataset, flags, *extra):
    data = []
    if dataset == "mosi_50":
        make_local_fixture(f"{root}/g_{dataset}", dataset,
                           n_per_split=(N_TRAIN, N_VALID, N_TEST),
                           dims=(300, 5, 20), time_len=14, seed=5)
    elif dataset == "avec2019":
        make_avec_fixture(f"{root}/g_{dataset}",
                          n_per_split=(N_TRAIN, N_VALID, N_TEST), seed=5)
    if dataset:
        data = FAMILY_FLAGS[dataset] + ["--data_dir", f"{root}/g_{dataset}"]
    return _argv(root, "--task_name", name, "--epochs_num", "5",
                 "--epoch_scan", *data, *flags, *extra)


def _same(a, b, what):
    """Bit-equality of two slots (nested dicts of tensors and values)."""
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    else:
        assert a == b, what


def _decisions(task):
    """Per epoch, the (valid, test) "Better ... score found" lines that
    the run logged before its epoch line."""
    out, now = [], [False, False]
    for line in open(f"{task}/Running.log"):
        if "Better valid score found" in line:
            now[0] = True
        elif "Better test score found" in line:
            now[1] = True
        elif "Epoch:[" in line:
            out.append(tuple(now))
            now = [False, False]
    return out


def _jax_decisions(scored, cfg):
    """The decisions of the JAX package's ``current_result_better`` on
    its own metric functions over the predictions each epoch scored
    (train, valid, test in turn)."""
    from mimrl_tpu.eval import metrics as jmetrics

    best, out = [None, None], []
    for e in range(len(scored) // 3):
        flags = []
        for j, (preds, targets) in enumerate(scored[3 * e + 1:3 * e + 3]):
            score = jmetrics.get_score_from_result(
                preds, targets, cfg.dataset, cfg.task, cfg.num_class)
            flags.append(jmetrics.current_result_better(
                best[j], score, cfg.task, cfg.num_class, cfg.dataset))
            if flags[-1]:
                best[j] = score
        out.append(tuple(flags))
    return out


def test_epoch_group_equals_per_epoch(run, monkeypatch, tmp_path):
    """``--epoch_scan --epoch_group 2`` against the per-epoch
    ``--epoch_scan`` run of the same seed, 5 epochs each, for the MAE,
    accuracy and CCC rules (AVEC's random words) and the plateau schedule
    on the device (with ``--stage1_cached``): bit for bit in the final
    state, both best slots, every ``scalars.jsonl`` value, the saved
    predictions and features, and every better-epoch decision, which
    also equals the JAX package's ``current_result_better`` on its own
    metric functions over the same predictions. Each split's loader
    passes end where the per-epoch run's do. A grouped run preempted in its
    first group and resumed ends where the uninterrupted one does. The
    selection functions against JAX's metrics; a run that cannot be grouped logs JAX's
    warning and runs per epoch; the parity harness
    (``tools/parity.py``) with ``--epoch_group 2`` gives JAX's keys, and
    its ``compare_reports`` equals JAX's."""
    from mimrl_tpu_torch.cli.main import set_random_seed
    from mimrl_tpu_torch.train import solver as solver_mod

    _selection_matches_jax()
    root = run[0]
    scored = []

    def recording(predictions, targets, *args):
        scored.append((np.array(predictions), np.array(targets)))
        return score_fn(predictions, targets, *args)

    score_fn = solver_mod.get_score_from_result
    monkeypatch.setattr(solver_mod, "get_score_from_result", recording)
    for name, (dataset, flags) in GROUP_RUNS.items():
        solvers = {}
        for mode, extra in (("p", []), ("g", ["--epoch_group", "2"])):
            scored.clear()
            opt = parse_args(_group_argv(root, f"group_{name}_{mode}",
                                         dataset, flags, *extra))
            set_random_seed(opt)
            solvers[mode] = solver = Solver(opt, device="cpu")
            assert solver._group_supported() == (mode == "g")
            solver.solve()
            decisions = _decisions(solver.task_path)
            assert len(decisions) == 5
            assert decisions == _jax_decisions(scored, opt), (name, mode)
        p, g = (solvers[m].task_path for m in "pg")
        log = open(f"{g}/Running.log").read()
        assert log.count("(group of 2)") == 4 and "group dispatch" in log
        assert (open(f"{p}/scalars.jsonl").read()
                == open(f"{g}/scalars.jsonl").read()), name
        assert _decisions(p) == _decisions(g), name
        for slot in ("latest", "best_valid", "best_test"):
            _same(CheckpointManager(p).restore(slot),
                  CheckpointManager(g).restore(slot), f"{name} {slot}")
        for f in sorted(os.listdir(p)):
            if f.endswith((".npy", ".pkl")):
                a, b = (open(f"{d}/{f}", "rb").read() for d in (p, g))
                assert a == b, f"{name} {f}"
        for loader in ("train_loader", "valid_loader", "test_loader"):
            assert (getattr(solvers["p"], loader).passes
                    == getattr(solvers["g"], loader).passes), loader
        if name == "plateau":
            lr = [json.loads(r)["value"] for r in open(f"{g}/scalars.jsonl")
                  if json.loads(r)["tag"] == "Lr"]
            assert min(lr) < max(lr)  # the schedule decayed inside a group
            assert (solvers["g"].lr_schedule.state_dict()
                    == solvers["p"].lr_schedule.state_dict())
        if name == "mae":  # a best taken inside a group, on both sides
            assert 0 < CheckpointManager(g).restore("best_valid")["epoch"]
            _preempted_group_resumes(root, flags, g, monkeypatch)
        if name == "ccc":
            assert solvers["g"].valid_loader.passes == 5
    monkeypatch.undo()

    # unsupported: JAX's warning, then the per-epoch path
    for flags in (["--epoch_group", "2"],
                  ["--epoch_group", "2", "--epoch_scan", "--profile_dir",
                   str(tmp_path / "prof")]):
        solver = Solver(parse_args(_argv(root, "--task_name", "ungrouped",
                                         *flags)), device="cpu")
        assert not solver._group_supported()
        solver.writer.close()
    main(_argv(root, "--task_name", "ungrouped", "--epoch_group", "2",
               "--epochs_num", "1", "--no_save_models"))
    assert solver_mod._GROUP_WARNING in open(
        f"{root}/runs/ungrouped/Running.log").read()

    _parity_matches_jax(tmp_path)


def _preempted_group_resumes(root, flags, want, monkeypatch):
    """A grouped run asked to stop during its first group stops at the
    group's end with ``latest`` at epoch 2; resumed with ``--resume``, it
    runs the last group and ends in the uninterrupted run's ``latest``,
    bit for bit."""
    dispatch = Solver._dispatch_epoch_group

    def preempting(self, e0, g):
        out = dispatch(self, e0, g)
        self.request_preemption()
        return out

    with monkeypatch.context() as m:
        m.setattr(Solver, "_dispatch_epoch_group", preempting)
        main(_group_argv(root, "group_stop", None, flags, "--epoch_group",
                         "2"))
    stopped = f"{root}/runs/group_stop"
    assert CheckpointManager(stopped).restore("latest")["epoch"] == 2
    assert "Preemption requested" in open(f"{stopped}/Running.log").read()
    main(_group_argv(root, "group_resumed", None, flags, "--epoch_group",
                     "2", "--resume", stopped))
    _same(CheckpointManager(f"{root}/runs/group_resumed").restore("latest"),
          CheckpointManager(want).restore("latest"), "resumed latest")


def _jax_report_keys():
    """The keys of the report dict that the JAX harness's ``run_parity``
    builds, read from its source."""
    import ast
    import inspect

    from mimrl_tpu.tools import parity as jparity

    tree = ast.parse(inspect.getsource(jparity.run_parity))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and node.targets[0].id == "report"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no report dict in the JAX harness")


def _parity_matches_jax(tmp_path):
    """A hermetic ``tools/parity.py`` run on the CPU with two epochs in
    groups of 2, and its comparison against itself, a perturbed copy and
    a flat metric dict, by the port's ``compare_reports`` and JAX's."""
    from mimrl_tpu.tools import parity as jparity
    from mimrl_tpu_torch.tools import parity

    out = str(tmp_path / "parity.json")
    report = parity.main(["--synthetic", "--allow_hermetic", "--epochs_num",
                          "2", "--epoch_group", "2", "--device", "cpu",
                          "--task_dir", str(tmp_path / "runs"), "--out", out])
    assert set(report) == _jax_report_keys()
    assert report["config"]["epoch_group"] == 2 and report["hermetic"]
    channels = report["mi_channels"]
    assert len(channels) == 24 and all(len(v) == 2 for v in channels.values())
    assert set(channels) == {f"{s}/{c}" for s in ("Train", "Val", "Test")
                             for c in parity.MI_CHANNELS}
    assert np.isfinite(report["samples_per_sec"])
    scores = report["test_score_at_best_valid"]
    assert np.isfinite(list(scores.values())).all()
    with open(out) as f:
        doc = json.load(f)
    bad = json.loads(json.dumps(doc))
    bad["test_score_at_best_valid"]["mae"] *= 1.05
    flat = dict(scores, mae=scores["mae"] * 1.001, name="paper")
    for ours, ref, tol in ((doc, doc, 0.01), (doc, bad, 0.01),
                           (doc, flat, 0.01), (doc, flat, 1e-4)):
        got = parity.compare_reports(ours, ref, tol)
        assert got == jparity.compare_reports(ours, ref, tol)
    assert parity.compare_reports(doc, doc, 0.0)["pass"]
    assert not parity.compare_reports(doc, bad, 0.01)["pass"]
    bad_path = str(tmp_path / "bad.json")
    with open(bad_path, "w") as f:
        json.dump(bad, f)
    assert parity.main(["--compare", out, out])["pass"]
    with pytest.raises(SystemExit) as stop:
        parity.main(["--compare", out, bad_path])
    assert stop.value.code == 1
    with pytest.raises(SystemExit, match="REFUSING"):
        parity.main(["--synthetic", "--epochs_num", "1", "--device", "cpu",
                     "--task_dir", str(tmp_path / "runs")])
    with pytest.raises(SystemExit) as stop:  # one optimizer code path
        parity.main(["--synthetic", "--allow_hermetic", "--fused_optim"])
    assert stop.value.code == 2


def _regularizers_match_jax():
    """Every function of train/regularizers.py and both built-in hooks of
    train/custom.py against the JAX package's on seeded inputs (1e-6)."""
    from mimrl_tpu.train import custom as jcustom
    from mimrl_tpu.train import regularizers as jreg
    from mimrl_tpu_torch.train import custom, regularizers as reg

    rng = np.random.default_rng(7)

    def arr(*shape, positive=False):
        x = rng.normal(size=shape).astype(np.float32)
        return np.abs(x) + 0.5 if positive else x

    x1, x2 = arr(8, 5), arr(8, 5)
    mu1, mu2, v1, v2 = arr(8, 5), arr(8, 5), arr(8, 5, positive=True), arr(
        8, 5, positive=True)
    seq, mask = arr(4, 6, 3), (rng.uniform(size=(4, 6, 3)) > 0.4).astype(
        np.float32)
    mask[:, 0] = 1.0
    cases = [("cmd", (x1, x2), {}), ("diff_loss", (arr(8, 2, 3), x2), {}),
             ("aug_temporal", (seq,), {}), ("mean_temporal", (seq,), {}),
             ("masked_mean", (seq, mask), {"dim": 1})]
    for red in ("mean", "sum"):
        cases += [("univariate_kld", (mu1, mu2, v1, v2), {"reduction": red}),
                  ("multivariate_kld", (mu1, mu2, v1, v2),
                   {"reduction": red})]
    for name, args, kw in cases:
        want = getattr(jreg, name)(*map(jnp.asarray, args), **kw)
        got = getattr(reg, name)(*map(torch.from_numpy, args), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # the reversed gradient: identity forward, -p * g backward
    x, g = torch.from_numpy(x1).requires_grad_(), arr(8, 5)
    y = reg.reverse_gradient(x, 0.3)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jreg.reverse_gradient(a, 0.3), jnp.asarray(x1))
    assert torch.equal(y.detach(), x.detach())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
    out, labels, feats = arr(8, 1), arr(8), [arr(8, 16) for _ in range(4)]
    for name in ("l2_output", "feature_decorrelation"):
        want = getattr(jcustom, name)(None)(
            jnp.asarray(out), jnp.asarray(labels), tuple(map(jnp.asarray, feats)))
        got = getattr(custom, name)(None)(
            torch.from_numpy(out), torch.from_numpy(labels),
            tuple(map(torch.from_numpy, feats)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_hooks_train_on_the_cpu(run):
    """``--custom_loss``, ``--check_gradient`` and ``--profile_dir`` in one
    two-epoch run; the hook's functions against JAX's; the spec's errors."""
    from mimrl_tpu_torch.train.custom import (feature_decorrelation,
                                              load_custom_loss)

    _regularizers_match_jax()
    cfg = parse_args(_argv(run[0]))
    for spec, error in (
            ("no_colon", "expected 'module.path:factory'"),
            ("no_such_module_xyz:fn", "cannot import"),
            ("mimrl_tpu_torch.train.custom:nope", "has no attribute 'nope'"),
            ("builtins:str", "non-callable str"),
            ("mimrl_tpu.train.custom:l2_output",
             "'mimrl_tpu_torch.train.custom:l2_output'")):
        with pytest.raises(ValueError, match=error):
            load_custom_loss(spec, cfg)
    assert load_custom_loss(None, cfg) is None

    root, task, _ = run
    prof = f"{root}/profile"
    spec = "mimrl_tpu_torch.train.custom:feature_decorrelation"
    scores = main(_argv(root, "--task_name", "hooks", "--custom_loss", spec,
                        "--check_gradient", "--profile_dir", prof,
                        "--epoch_scan", "--no_save_models"))
    assert all(np.isfinite(v) for s in scores for v in s.values())
    log = open(f"{root}/runs/hooks/Running.log").read().splitlines()
    # --check_gradient runs per batch: after each of epoch 1's 6 critic
    # steps and 3 train steps, every non-BERT parameter in sorted order
    names = sorted(n for n in Predictor(task, device="cpu").model.state_dict()
                   if "bert" not in n and "num_batches" not in n)
    blocks = [i for i, line in enumerate(log) if "-->name: " in line]
    assert len(blocks) == 9 * len(names)
    for j, i in enumerate(blocks):
        assert log[i].endswith(f"-->name: {names[j % len(names)]}")
        para = float(log[i + 1].split("-->para: ")[1])
        grad = float(log[i + 2].split("-->grad_value: ")[1])
        assert np.isfinite([para, grad]).all() and log[i + 3].endswith("=" * 25)
    # one epoch traced (epoch 1, after the warm-up epoch): chrome-trace JSON
    assert any(f"Profiler trace written to {prof}" in line for line in log)
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.load(open(f"{prof}/{traces[0]}"))["traceEvents"]
    assert any("train_step" in str(e.get("name")) or e.get("cat") == "cpu_op"
               for e in events)
    # the hook adds its value to the eval loss
    predictor = Predictor(task, device="cpu")
    fn = load_custom_loss(spec, predictor.cfg)
    batch = next(iter(predictor.valid_loader))
    mb, labels = steps.to_device(batch, get_label_from_datas(
        predictor.cfg, batch), "regression", "cpu")
    bank = steps.FeatureBank(8, 8, 16)
    plain = steps.eval_step(predictor.model, predictor.cfg, mb, labels, bank,
                            None, False)
    hooked = steps.eval_step(predictor.model, predictor.cfg, mb, labels, bank,
                             None, False, custom_loss=fn)
    value = feature_decorrelation(None)(plain[2], labels, plain[3])
    assert value > 0
    assert abs(hooked[0] - plain[0] - value).item() <= 1e-6


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
    _decompose_runs_on_the_cpu(monkeypatch)


def _decompose_runs_on_the_cpu(monkeypatch):
    """``tools/decompose.py``: without a card it raises unless asked for
    the CPU; at tiny shapes on the CPU it times JAX's pieces under JAX's
    names (``res[...]`` of ``mimrl_tpu/tools/decompose.py``), the four
    replayable steps also replayed, and prints JAX's text lines, then one
    JSON line."""
    import contextlib
    import inspect
    import io
    import re

    from mimrl_tpu.tools import decompose as jdecompose
    from mimrl_tpu_torch.tools import decompose

    tiny = ["--steps", "1", "--warmup", "1", "--profile", "1",
            "--bert_hidden", "32", "--bert_heads", "2"]
    for var, value in (("BENCH_BS", "8"), ("BENCH_TIME_LEN", "12"),
                       ("BENCH_BERT_LAYERS", "1")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="CUDA"):
        decompose.main(tiny)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert decompose.main(tiny + ["--device", "cpu"]) == 0
    lines = out.getvalue().strip().splitlines()
    doc = json.loads(lines[-1])
    jax_names = re.findall(r'res\["(\w+)"\] =', inspect.getsource(jdecompose))
    assert list(doc["pieces"]) == [n for n in jax_names if n != "bert_error"]
    assert doc["shape"] == dict(bs=8, time_len=12, bert_layers=1,
                                dtype="bfloat16", quant="none",
                                use_pallas=False)
    for name, piece in doc["pieces"].items():
        assert piece["ms"] > 0 and piece["busy_ms"] is None, name
        assert (piece["replayed_ms"] is not None) == (
            name in decompose.REPLAYED), name
    assert doc["card"] is None and doc["device"] == "cpu"
    text = [line.split()[0] for line in lines[-len(doc["pieces"]) - 2:-2]]
    assert text == list(doc["pieces"])
    assert lines[-2].startswith("implied samples/s")
    assert doc["implied_samples_per_s"] == pytest.approx(8e3 / (
        doc["pieces"]["train_step"]["ms"]
        + 2 * doc["pieces"]["critic_update"]["ms"]))


RUNGS = {  # stage-1 mode -> (its runs' flags, the JAX epoch program)
    "fresh": ([["--epoch_scan"]], "critic_epoch_fresh"),
    "fast": ([["--fast_stage1"], ["--epoch_scan", "--fast_stage1"]],
             "critic_epoch"),
    "cached": ([["--epoch_scan", "--stage1_cached"]], "critic_epoch_cached"),
}
_RUNG_PAIR = []


def _rung_pair():
    if not _RUNG_PAIR:
        _RUNG_PAIR.append(Pair(optm="SGD"))
    return _RUNG_PAIR[0]


def _anchors_of(keys):
    return [{k: torch.from_numpy(v) for k, v in _jax_anchors(key).items()}
            for key in keys]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@pytest.mark.parametrize("mode", sorted(RUNGS))
def test_rungs(run, mode):
    """One stage-1 mode of the schedule rungs against the JAX epoch
    programs, then through ``cli.main`` (see the module's docstring)."""
    flag_sets, program = RUNGS[mode]
    p = _rung_pair()
    nb, n_passes = N_BANK // S_BS, 2
    host = [_batch(seed) for seed in range(nb)]
    stacked = {k: np.stack([b[k] for b, _ in host]) for k in host[0][0]}
    labels = np.stack([y for _, y in host])
    jb = {k: jnp.asarray(v) for k, v in stacked.items()}
    main_p, bert_p, vmi_p, jbank = p.jax_state()
    f = p.factory
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    model, opt_main, opt_vmi, bank, new_bank, _, _ = p.port_state()
    pb = {k: torch.from_numpy(v) for k, v in stacked.items()}
    plabels = torch.from_numpy(labels)

    # eval at the initial weights (after the updates below, their 1e-5
    # differences move a few features by more than 1e-4)
    want = f.eval_epoch(main_p, bert_p, vmi_p, jb, jnp.asarray(labels), jbank,
                        k3, use_mi=True)
    got = steps.eval_epoch(model, p.cfg, pb, plabels, bank, None, True,
                           anchors=_anchors_of(jax.random.split(k3, nb)))
    for g, w, what in zip(got[:3] + got[3], want[:3] + tuple(want[3]),
                          ("loss", "MI", "output", "F", "T", "A", "V")):
        _close(g, w, f"eval {what}")

    # stage 1: the anchors of each update, pass-major
    jstate = p.jopt_vmi.init(vmi_p)
    if mode == "cached":
        vmi_p, _, want = f.critic_epoch_cached(
            main_p, bert_p, vmi_p, jstate, jbank, k1, n_passes=n_passes, nb=nb)
        keys = jax.random.split(jax.random.split(k1)[1], nb * n_passes)
        got = steps.critic_epoch_cached(model, opt_vmi, p.cfg, bank, nb, None,
                                        n_passes, anchors=_anchors_of(keys))
    else:
        vmi_p, _, want = getattr(f, program)(
            main_p, bert_p, vmi_p, jstate, jb, jnp.asarray(labels), jbank, k1,
            n_passes=n_passes)
        if mode == "fast":
            keys = jax.random.split(jax.random.split(k1)[1], nb * n_passes)
        else:  # each step splits its key into dropout and kNN keys
            keys = [jax.random.split(k)[1]
                    for k in jax.random.split(k1, nb * n_passes)]
        fn = steps.critic_epoch if mode == "fast" else steps.critic_epoch_fresh
        got = fn(model, opt_vmi, p.cfg, pb, plabels, bank, None, n_passes,
                 anchors=_anchors_of(keys))
    assert got.shape == (n_passes,)
    _close(got.sum(), want, "critic loss")
    vmi_names = tuple(n for n, _ in model.named_children()
                      if n.startswith(("vmi_", "vcmi_")))
    _assert_params(p, model, vmi_p, vmi_names)

    # stage 2 with MI, its features into a new bank
    jstate = p.jopt_main.init(joptim.merge_params(main_p, bert_p))
    (main_p, bert_p, _, losses, mis, outs, jnew) = f.train_epoch(
        main_p, bert_p, vmi_p, jstate, jb, jnp.asarray(labels), jbank,
        jsteps.FeatureBank.create(N_BANK, N_VALID, D_C), k2, use_mi=True)
    keys = [jax.random.split(k)[1] for k in jax.random.split(k2, nb)]
    got = steps.train_epoch(model, opt_main, p.cfg, pb, plabels, bank,
                            new_bank, None, True, anchors=_anchors_of(keys))
    for g, w, what in zip(got, (losses, mis, outs), ("loss", "MI", "output")):
        _close(g, w, f"train {what}")
    for field in "CFTAV":
        _close(getattr(new_bank, field), getattr(jnew, field), f"bank {field}")
    _assert_params(p, model, joptim.merge_params(main_p, bert_p),
                   MAIN_GROUPS)

    # the rung end to end: 3 epochs, pipelined or not, the same scalars
    root = run[0]
    for flags in flag_sets:
        name = "rung_" + "_".join(x.strip("-") for x in flags)
        scores = main(_argv(root, "--task_name", name, "--epochs_num", "3",
                            *flags))
        assert all(np.isfinite(v) for s in scores for v in s.values())
        rows = open(f"{root}/runs/{name}/scalars.jsonl").read()
        mi = [json.loads(r)["value"] for r in rows.splitlines()
              if json.loads(r)["tag"].startswith("Train/MI_")]
        assert len(mi) == 24 and any(v != 0.0 for v in mi[8:])
        log = open(f"{root}/runs/{name}/Running.log").read()
        assert log.count("pass2:[") == 2, name
        if "--epoch_scan" in flags:
            main(_argv(root, "--task_name", name + "_np", "--epochs_num", "3",
                       "--no_pipeline_epochs", *flags))
            assert open(f"{root}/runs/{name}_np/scalars.jsonl").read() == rows
    family = {"fresh": "avec2019", "fast": "mosi_50"}.get(mode)
    if family:
        _family_runs(root, family)


FAMILY_FLAGS = {
    "mosi_50": ["--dataset", "mosi_50"],
    "avec2019": ["--dataset", "avec2019", "--text", "text", "--audio", "mfcc",
                 "--video", "au", "--loss", "CCC"],
}


def _family_runs(root, dataset):
    """A dataset family other than DeclareLab through ``cli.main``, per
    batch and on ``--epoch_scan``, two epochs each: finite scores and MI
    telemetry after epoch 0, and ``Predictor`` repeats the run's valid
    score (AVEC's from the words of the best epoch's pass). ``mosi_50``: no BERT parameter exists and the model reads the
    dense text. AVEC2019: the stacked epochs of ``--epoch_scan`` hold the
    words that the per-batch loader draws for the same pass, other words
    each pass, and the unshuffled splits are not stacked once."""
    data = f"{root}/{dataset}"
    if dataset == "avec2019":
        make_avec_fixture(data, n_per_split=(N_TRAIN, N_VALID, N_TEST), seed=5)
    else:
        make_local_fixture(data, dataset, n_per_split=(N_TRAIN, N_VALID, N_TEST),
                           dims=(300, 5, 20), time_len=14, seed=5)
    flags = FAMILY_FLAGS[dataset] + ["--data_dir", data]
    for scan in ([], ["--epoch_scan"]):
        name = f"{dataset}{'_scan' if scan else ''}"
        scores = main(_argv(root, "--task_name", name, *flags, *scan))
        assert all(np.isfinite(v) for s in scores for v in s.values())
        rows = [json.loads(r) for r in open(f"{root}/runs/{name}/scalars.jsonl")]
        mi = [r["value"] for r in rows if r["step"] == 1
              and r["tag"].startswith("Train/MI_")]
        assert len(mi) == 8 and any(v != 0.0 for v in mi)
        predictor = Predictor(f"{root}/runs/{name}", device="cpu")
        # AVEC's valid words are those of the pass of the best epoch
        predictor.valid_loader.passes = CheckpointManager(
            f"{root}/runs/{name}").restore("best_valid")["epoch"]
        key = "ccc" if dataset == "avec2019" else "mae"
        assert predictor.evaluate_split("valid")[key] == pytest.approx(
            scores[0][key], rel=1e-5)
        params = dict(predictor.model.named_parameters())
        raw = dataset == "avec2019"
        assert any(k.startswith("bertmodel.") for k in params) == raw
        if not raw:
            assert params["W_t.weight"].shape == (16, 300)
            log = open(f"{root}/runs/{name}/Running.log").read()
            assert ", bert 0, " in log

    if dataset != "avec2019":
        return
    solver = Solver(parse_args(_argv(root, "--task_name", "stack", *flags,
                                     "--epoch_scan")), device="cpu")
    twin = get_data_loader(solver.opt, solver.tokenizer)[0]
    stacks = [solver._stack_epoch(solver.train_loader)[0]["bert_sentences"]
              for _ in range(2)]
    for stack in stacks:  # pass 0, then pass 1 of the per-batch loader
        np.testing.assert_array_equal(
            stack.numpy(), np.stack([b["bert_sentences"] for b in twin]))
    assert (stacks[0] != stacks[1]).any()
    for _ in range(2):
        solver._stack_epoch(solver.valid_loader)
    assert solver.valid_loader.passes == 2 and not solver._stacks
    solver.writer.close()


def _assert_params(p, model, jparams, groups):
    """Every entry of the named groups against the JAX tree (SGD)."""
    tree = dict(p.params_np)
    tree.update(jax.tree_util.tree_map(np.asarray, jparams))
    want = state_dict_from_jax(tree, model)
    got = model.state_dict()
    names = [n for n in want if n.split(".")[0] in groups]
    assert names and {n.split(".")[0] for n in names} == set(groups)
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
