"""Accuracy-parity harness (the port's copy of
``mimrl_tpu.tools.parity``; the BASELINE.md protocol).

One command runs the canonical MOSI-Dec recipe end to end
(ref: README.md:17-24 — bs 128, GRU, CubeMLP 50-3-128=10-3-128,
InfoNCE / separate / constant, stage1_n 2, Adam 4e-3, multi-step 9-60
x0.1, 70 epochs) through the port's ``Solver`` and prints one JSON
document with what the comparison protocol needs: the metric dicts of
valid, test and test at best valid, the 8 MI channels per epoch, and
samples/s. The keys are the JAX harness's.

A real-data run needs --bert_vocab and --bert_weights: without them the
tokenizer hashes words into buckets and BERT starts from random weights,
which trains but cannot reproduce the paper's accuracy. The harness
refuses such a run unless --allow_hermetic is given (synthetic fixtures).
A real-data run first checks its inputs with ``data/preflight.py``.

The run is on the CUDA device unless --device cpu asks for the CPU.

    python -m mimrl_tpu_torch.tools.parity \
        --data_dir /path/to/pickles --bert_vocab /path/to/vocab.txt \
        --bert_weights /path/to/pytorch_model.bin --out parity.json

    python -m mimrl_tpu_torch.tools.parity --synthetic --allow_hermetic \
        --epochs_num 2 --epoch_group 2 --device cpu --out /tmp/parity.json

Comparison (the protocol's second half): our report against another
report of this harness (or of the JAX harness), or against a flat
{"mae": ..., "corr": ...} JSON entered by hand from a reference run log
or the paper's MOSI table: per-metric relative deltas, each passing within
--rel_tol (north star: MOSI MAE within 1%); the command exits 1 when one
fails.

    python -m mimrl_tpu_torch.tools.parity --compare ours.json ref.json \
        --rel_tol 0.01
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

MI_CHANNELS = ("MI_ft", "MI_fa", "MI_fv", "MI_in", "MI_spec_t", "MI_spec_a",
               "MI_spec_v", "MI_comp")


def canonical_config(**overrides):
    """The canonical MOSI-Dec parity recipe as a MimrlConfig
    (ref: README.md:17-24; recipes/mosi_dec_canonical.sh)."""
    from mimrl_tpu_torch.core.config import MimrlConfig

    base = dict(
        task_name="parity", dataset="mosi_Dec",
        log_scale=[False, False, False], normalize=[False, True, True],
        batch_size=128, num_workers=8, d_common=128, encoders="gru",
        activate="gelu", time_len=100,
        d_hiddens=[[50, 3, 128], [10, 3, 128]],
        d_outs=[[50, 3, 128], [10, 3, 128]],
        dropout_mlp=[0.0, 0.0, 0.0], dropout=[0.1, 0.1, 0.1, 0.1],
        bias=True, res_project=[True, True],
        critic_type="separate", baseline_type="constant",
        bound_type="infonce", mi_lr_rate=1.0, cmi_lr_rate=1.0,
        loss_mi_coefficient1=[1.0] * 11, loss_mi_coefficient2=[0.01] * 8,
        k_neighbor=2, radius=1.0, cmi_last_acticate="sigmoid", stage1_n=2,
        seed=0, loss="MAE", gradient_clip=1.5, epochs_num=70, optm="Adam",
        learning_rate=4e-3, bert_freeze="no", bert_lr_rate=0.01,
        weight_decay=0.0, lr_decrease="multi_step", lr_decrease_iter="9-60",
        lr_decrease_rate=0.1, save_best_features=True, parallel=True,
    )
    base.update(overrides)
    return MimrlConfig(**base)


def _mi_trajectories(task_path: str) -> dict:
    """Per-epoch MI channel values from scalars.jsonl, keyed
    '<Split>/<channel>' as the reference's TensorBoard tags
    (ref: Solver.py:470-477)."""
    out: dict = {}
    path = os.path.join(task_path, "scalars.jsonl")
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            tag = rec["tag"]
            if any(tag.endswith(c) for c in MI_CHANNELS):
                out.setdefault(tag, []).append(rec["value"])
    return out


def _samples_per_sec(task_path: str) -> float:
    """The median samples/s of the epochs after the first (which captures
    the graphs), from the run log."""
    path = os.path.join(task_path, "Running.log")
    vals = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                m = re.search(r"([0-9.]+) samples/s", line)
                if m:
                    vals.append(float(m.group(1)))
    if not vals:
        return float("nan")
    vals = sorted(vals[1:] or vals)  # drop the first epoch
    return vals[len(vals) // 2]


def run_parity(args) -> dict:
    if args.synthetic:
        root = tempfile.mkdtemp(prefix="parity_syn_")
        from mimrl_tpu_torch.data.synthetic import make_dec_fixture

        # --full_scale: the real split sizes (MOSI 1284/229/686, MOSEI
        # 16326/1871/4659), so the run measures the canonical shapes end
        # to end; else a tiny fixture. --data_seed keeps the fixture fixed
        # while --seed varies the training.
        data_seed = args.seed if args.data_seed is None else args.data_seed
        if args.scale == "mosei":
            splits = ((16326, 1871, 4659) if args.full_scale
                      else (64, 16, 16))
            # Dec-MOSEI's feature widths (ref: DataLoaderCMUDeclareLab.py,
            # covarep 74, facet 35) and its 7-column labels
            make_dec_fixture(root, "mosei", n_per_split=splits,
                             d_audio=74, d_video=35, seed=data_seed)
        else:
            splits = (1284, 229, 686) if args.full_scale else (64, 16, 16)
            make_dec_fixture(root, "mosi", n_per_split=splits,
                             d_audio=5, d_video=20, seed=data_seed)
        data_dir = root
    else:
        data_dir = args.data_dir
        if not data_dir:
            sys.exit("parity: --data_dir is required (or pass --synthetic "
                     "for the hermetic fixture mode)")
        # real data: layout, schema, vocab and weights first, with errors
        # a user can act on (docs/RUNBOOK.md)
        from mimrl_tpu_torch.data.preflight import run_preflight

        findings = run_preflight(
            "mosi_Dec" if args.scale == "mosi" else "mosei_Dec",
            data_dir, bert_vocab=args.bert_vocab,
            bert_weights=args.bert_weights)
        for f in findings:
            print(f, file=sys.stderr)
        if any(f.level == "error" for f in findings):
            sys.exit("parity: preflight failed — fix the errors above "
                     "(see docs/RUNBOOK.md)")

    hermetic = not (args.bert_vocab and args.bert_weights)
    if hermetic and not args.allow_hermetic:
        sys.exit(
            "parity: REFUSING to run without --bert_vocab AND "
            "--bert_weights.\nWithout them the tokenizer falls back to "
            "hash-bucket word ids and BERT starts from RANDOM init — the "
            "run trains, but its accuracy is meaningless as a parity "
            "number against the paper.\nPass --allow_hermetic to "
            "acknowledge this (synthetic-fixture CI does).")

    overrides = dict(
        dataset=("mosei_Dec" if args.scale == "mosei" else "mosi_Dec"),
        data_dir=data_dir, bert_vocab=args.bert_vocab,
        bert_weights=args.bert_weights, task_dir=args.task_dir,
        task_name=args.task_name, epochs_num=args.epochs_num,
        seed=args.seed, epoch_scan=args.epoch_scan,
        stage1_cached=args.stage1_cached,
        epoch_group=args.epoch_group,
        pipeline_epochs=args.pipeline_epochs,
        compute_dtype=args.compute_dtype, quant=args.quant,
        moment_dtype=args.moment_dtype, bank_dtype=args.bank_dtype,
        save_latest_every=0, device=args.device,
    )
    if args.light_artifacts:
        # measurement runs: no best-model slots and no feature pickles
        # (the metrics, MI channels and samples/s are the same)
        overrides.update(save_best_features=False, save_models=False)
    if args.synthetic and not args.full_scale:
        # tiny shapes, so that the hermetic smoke run takes minutes
        overrides.update(
            batch_size=16, time_len=24, d_common=32,
            d_hiddens=[[24, 3, 32], [8, 3, 32]],
            d_outs=[[24, 3, 32], [8, 3, 32]],
            bert_layers=2, bert_heads=2, bert_hidden=32,
            num_workers=0, save_best_features=False)
    elif args.synthetic:
        # the canonical shapes on the synthetic fixture: the solver's
        # throughput end to end (samples/s with the evals), in-process
        # batches
        overrides.update(num_workers=0)

    cfg = canonical_config(**overrides)
    from mimrl_tpu_torch.train.solver import Solver

    t0 = time.time()
    solver = Solver(cfg)
    best = solver.solve()
    wall = time.time() - t0
    task_path = solver.task_path

    report = {
        "protocol": "BASELINE.md canonical MOSI-Dec recipe "
                    "(ref: README.md:17-24)",
        "hermetic": hermetic,
        "config": json.loads(cfg.to_json()),
        "wall_time_sec": round(wall, 2),
        "samples_per_sec": _samples_per_sec(task_path),
        "best_valid_score": best[0],
        "best_test_score": best[1],
        "test_score_at_best_valid": best[2],
        "mi_channels": _mi_trajectories(task_path),
        "task_path": task_path,
    }
    return report


def _extract_scores(doc: dict, score_key: str) -> dict:
    """A whole report (its ``doc[score_key]``) or a flat {metric: value}
    dict (a reference's numbers entered by hand from a run log or the
    paper's table)."""
    if score_key in doc and isinstance(doc[score_key], dict):
        return doc[score_key]
    flat = {k: v for k, v in doc.items() if isinstance(v, (int, float))}
    if not flat:
        sys.exit(f"parity: no '{score_key}' dict and no flat numeric "
                 f"metrics found in comparison input")
    return flat


def compare_reports(ours: dict, ref: dict, rel_tol: float,
                    score_key: str = "test_score_at_best_valid") -> dict:
    """Per-metric relative deltas between our report and a reference
    metric dict; a metric passes when |ours - ref| / max(|ref|, eps)
    <= rel_tol. Only the metrics present on both sides are compared."""
    a = _extract_scores(ours, score_key)
    b = _extract_scores(ref, score_key)
    shared = sorted(set(a) & set(b))
    if not shared:
        sys.exit("parity: the two inputs share no metric keys "
                 f"(ours: {sorted(a)}, ref: {sorted(b)})")
    rows = {}
    for k in shared:
        ours_v, ref_v = float(a[k]), float(b[k])
        rel = abs(ours_v - ref_v) / max(abs(ref_v), 1e-12)
        rows[k] = {"ours": ours_v, "ref": ref_v,
                   "rel_delta": round(rel, 6), "ok": rel <= rel_tol}
    return {
        "score_key": score_key,
        "rel_tol": rel_tol,
        "metrics": rows,
        "compared": shared,
        "pass": all(r["ok"] for r in rows.values()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MIMRL accuracy-parity harness (BASELINE.md protocol)")
    ap.add_argument("--data_dir", default=None,
                    help="root with mosi_{train,valid,test}.pkl (Dec schema)")
    ap.add_argument("--bert_vocab", default=None)
    ap.add_argument("--bert_weights", default=None)
    ap.add_argument("--allow_hermetic", action="store_true",
                    help="run without vocab/weights (hash tokenizer + "
                         "random BERT) — CI/synthetic use only")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a synthetic Dec fixture and run tiny "
                         "shapes (hermetic smoke)")
    ap.add_argument("--full_scale", action="store_true",
                    help="with --synthetic: real MOSI split sizes + the "
                         "canonical shapes (end-to-end throughput measure)")
    ap.add_argument("--stage1_cached", action="store_true",
                    help="perf-mode stage 1 (critics sweep the epoch-stale "
                         "bank; requires epoch_scan)")
    ap.add_argument("--light_artifacts", action="store_true",
                    help="skip best-model checkpoints + feature pickles "
                         "(measurement runs; metrics unaffected)")
    ap.add_argument("--epoch_group", type=int, default=1,
                    help="N whole epochs per dispatch "
                         "(--epoch_group in the solver)")
    ap.add_argument("--epochs_num", type=int, default=70)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_seed", type=int, default=None,
                    help="with --synthetic: fixture RNG seed, decoupled "
                         "from the training seed (default: same as --seed)")
    ap.add_argument("--scale", default="mosi", choices=["mosi", "mosei"],
                    help="with --synthetic: which dataset scale/schema to "
                         "generate (mosei: real Dec dims 74/35, 7-col "
                         "labels, 16326/1871/4659 splits at --full_scale)")
    ap.add_argument("--no_pipeline_epochs", dest="pipeline_epochs",
                    action="store_false", default=True,
                    help="disable the pipelined epoch loop (host work "
                         "for epoch e overlapped with epoch e+1's device "
                         "work; bit-identical, on by default)")
    ap.add_argument("--epoch_scan", action="store_true", default=True)
    ap.add_argument("--no_epoch_scan", dest="epoch_scan",
                    action="store_false")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--moment_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="optimizer first-moment/momentum dtype")
    ap.add_argument("--bank_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="feature-bank storage dtype")
    ap.add_argument("--fused_optim", action="store_true",
                    help="refused: this package has one optimizer code path")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8_fwd", "int8", "int8_all"])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the CUDA device")
    ap.add_argument("--task_dir", default="./TaskRuning")
    ap.add_argument("--task_name", default="parity")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--compare", nargs=2, metavar=("OURS", "REF"),
                    default=None,
                    help="compare two report/metric JSONs instead of "
                         "running; exits 1 when any shared metric "
                         "exceeds --rel_tol")
    ap.add_argument("--rel_tol", type=float, default=0.01,
                    help="relative tolerance for --compare (north star: "
                         "MAE within 1%%)")
    ap.add_argument("--score_key", default="test_score_at_best_valid",
                    choices=["best_valid_score", "best_test_score",
                             "test_score_at_best_valid"],
                    help="which score slot of a full report to compare")
    args = ap.parse_args(argv)
    if args.fused_optim:
        ap.error("--fused_optim selects the JAX package's fused Adam; this "
                 "package has one optimizer code path: run without it")

    if args.compare:
        with open(args.compare[0]) as f:
            ours = json.load(f)
        with open(args.compare[1]) as f:
            ref = json.load(f)
        result = compare_reports(ours, ref, args.rel_tol, args.score_key)
        text = json.dumps(result, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        if not result["pass"]:
            sys.exit(1)
        return result

    report = run_parity(args)
    text = json.dumps(report, indent=2, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return report


if __name__ == "__main__":
    main()
