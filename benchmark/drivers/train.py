"""Training traffic: whole two-stage epochs of MIMRL through
``train/solver.py::Solver.solve`` (pipelined under ``--epoch_scan``: epoch
e + 1 is dispatched before epoch e's host work; grouped under
``--epoch_group``), with the train, valid and test splits and best-model
tracking.

Set-up builds the Solver over a seeded DeclareLab split set, loads the
benchmark's seeded weights and runs ``Solver.solve`` over the mix's warm-up
epochs (epoch 0 is stage 2 alone; epoch 1 has stage 1 and the bank's
terms), which capture every step graph. The steps that the correctness
check compares run on the way, each from a state that the benchmark made:

- epoch 0's first three stage-2 steps, from the seeded weights and the
  generators as the run's seed sets them;
- epoch 0's eval batches, with the seeded weights put back first;
- epoch 1's first three critic steps, and its first three stage-2 steps,
  each with the seeded weights, fresh moments of its optimizer, a seeded
  feature bank and both generators reseeded put in first.

The window then runs ``Solver.solve`` from the next epoch on; once
``--seconds`` have passed, the epoch in progress is the run's last, through
the solver's own stop. The rate counts the real train samples of the
window's epochs over the window's time, eval and selection included.

After the window the system is freed and the reference recomputes the same
steps (``reference/``) from the same states, with the same draws: it reads
only the seeded weights, the seeded bank, the seeds and the data.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark import fixture, harness, trace
from benchmark.reference import data as rdata
from benchmark.reference import model as M
from benchmark.reference import train as rtrain
from benchmark.reference.rng import Draws

CHECKED = ("train_step", "critic_step", "train_step_mi")
# the seeds that epoch 1's checked stages reseed both generators with, as
# offsets from the run's seed
STAGE_SEEDS = {"critic_step": 1, "train_step_mi": 2}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def seeded_bank(bank, n_real: int, seed: int) -> Dict[str, torch.Tensor]:
    """The feature bank that epoch 1's checked stages start from, on the
    host in the system's bank shapes and dtypes: labels uniform in [-3, 3]
    (the fixture's range), normal features, the real rows valid."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for f in bank.FIELDS:
        shape, dtype = getattr(bank, f).shape, getattr(bank, f).dtype
        x = (torch.rand(shape, generator=g) * 6.0 - 3.0 if f == "C"
             else torch.randn(shape, generator=g))
        out[f] = x.to(dtype)
    out["valid"] = torch.arange(bank.valid.shape[0]) < n_real
    return out


class Observer:
    """Puts the benchmark's states into the system before the checked steps
    and reads their results in set-up: the losses of the first three calls
    of each checked step, the optimizer's second moment after the first and
    the parameters after the third, the bank rows that epoch 0's first three
    steps wrote, and epoch 0's eval outputs (its first ``n_eval`` eval
    batches)."""

    def __init__(self, solver, n_eval: int, weights: Dict, bank: Dict,
                 seeds: Dict[str, int]):
        self.s = solver
        self.weights, self.bank, self.seeds = weights, bank, seeds
        self.names = {id(p): n for n, p in solver.model.named_parameters()}
        self.calls: Dict[str, int] = {}
        self.read: Dict[str, Dict] = {k: {"loss": []} for k in CHECKED}
        self.n_eval = n_eval
        self.evals = 0
        self.eval_outs: List[torch.Tensor] = []
        self.bank_rows: List[torch.Tensor] = []

    def _opt(self, kind):
        return self.s.opt_vmi if kind == "critic_step" else self.s.opt_main

    def _leaves(self, opt, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {self.names[id(p)]: x.view(p.shape) for p, x in
                zip(opt.params, flat.split(opt.sizes))}

    @torch.no_grad()
    def _put(self, kind: Optional[str] = None) -> None:
        """The seeded weights into the system; for a checked stage of epoch
        1 also fresh moments of its optimizer, the seeded bank and both
        generators reseeded."""
        s = self.s
        for n, p in s.model.named_parameters():
            p.copy_(self.weights[n])
        if kind is None:
            return
        for t in self._opt(kind).state():
            t.zero_()
        s.bank.load_state_dict(self.bank)
        seed = self.seeds[kind]
        if s.device.type == "cuda":
            torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        s.generator.manual_seed(seed)

    def before(self, kind: str) -> None:
        if kind.startswith("eval_step"):
            if self.evals == 0:
                self._put()
            return
        if kind not in STAGE_SEEDS or self.calls.get(kind, 0):
            return
        if kind == "critic_step":  # what epoch 0's first three steps wrote
            bs = self.s.opt.batch_size
            self.bank_rows = [torch.cat(
                [_host(getattr(self.s.bank, f)[i * bs:(i + 1) * bs])
                 for f in "FTAV"], dim=1) for i in range(3)]
        self._put(kind)

    def after(self, kind: str, result) -> None:
        if kind.startswith("eval_step"):
            self.evals += 1
            if len(self.eval_outs) < self.n_eval:
                self.eval_outs.append(_host(result[2]).float())
            return
        n = self.calls[kind] = self.calls.get(kind, 0) + 1
        if kind not in CHECKED or n > 3:
            return
        rd, opt = self.read[kind], self._opt(kind)
        rd["loss"].append(float(result[0]))
        if n == 1:
            rd["nu1"] = self._leaves(opt, _host(opt.nu))
        if n == 3:
            rd["params3"] = {self.names[id(p)]: _host(p) for p in opt.params}


class GraphsProxy:
    """The Solver's step runner with the observer around each call."""

    def __init__(self, graphs, obs: Observer):
        self.graphs, self.obs = graphs, obs

    def __call__(self, name, body, **inputs):
        self.obs.before(name)
        result = self.graphs(name, body, **inputs)
        self.obs.after(name, result)
        return result

    def __getattr__(self, item):
        return getattr(self.graphs, item)


def _wrap_steps(steps, obs: Observer):
    """Observe the per-batch loop's module-level step calls; returns the
    originals to put back."""
    orig = {n: getattr(steps, n) for n in ("train_step", "critic_step",
                                           "eval_step")}

    def train_step(*a, **k):
        use_mi = a[9] if len(a) > 9 else k["use_mi"]
        kind = "train_step_mi" if use_mi else "train_step"
        obs.before(kind)
        r = orig["train_step"](*a, **k)
        obs.after(kind, r)
        return r

    def critic_step(*a, **k):
        obs.before("critic_step")
        r = orig["critic_step"](*a, **k)
        obs.after("critic_step", r)
        return r

    def eval_step(*a, **k):
        use_mi = a[6] if len(a) > 6 else k["use_mi"]
        kind = "eval_step_mi" if use_mi else "eval_step"
        obs.before(kind)
        r = orig["eval_step"](*a, **k)
        obs.after(kind, r)
        return r

    steps.train_step, steps.critic_step = train_step, critic_step
    steps.eval_step = eval_step
    return orig


DISPATCH = ("_epoch_scan_dispatch", "_dispatch_epoch_group", "train",
            "evaluate")
HOST = ("_finalize_epoch", "_finalize_group")


def solve(solver, first: int, last: int,
          stop: Optional[Callable[[], bool]] = None) -> int:
    """``Solver.solve`` over epochs ``first`` to ``last - 1``; returns the
    epochs it logged. ``stop()`` is asked after each epoch's dispatch and
    host work: once it is true the solver stops as on a preemption, at the
    end of the epoch in progress (under pipelining the one on the device),
    and writes no slot, since the mix writes no checkpoint. The benchmark's
    host spans name the dispatch and the host work."""
    logged: List[int] = []
    patched = []

    def patch(name: str, around) -> None:
        orig = getattr(solver, name)
        setattr(solver, name, lambda *a, **k: around(orig, *a, **k))
        patched.append(name)

    def spanned(label: str):
        def around(orig, *a, **k):
            with trace.span(label):
                result = orig(*a, **k)
            if stop is not None and stop():
                solver._preempted = True
            return result
        return around

    def log_epoch(orig, epoch, *a, **k):
        logged.append(epoch)
        return orig(epoch, *a, **k)

    for name in DISPATCH:
        patch(name, spanned("dispatch"))
    for name in HOST:
        patch(name, spanned("host"))
    patch("_log_epoch", log_epoch)
    patch("_stop_preempted", lambda orig, *a, **k: None)
    solver.start_epoch, solver.opt.epochs_num = first, last
    try:
        solver.solve()
    finally:
        for name in patched:
            delattr(solver, name)
    return len(logged)


def program_readings(obs: Observer, weights_host: Dict) -> Dict:
    """The system's readings, in the reference's terms: each checked kind
    starts from the seeded weights with fresh moments, so the first
    gradient's norm is read from the second moment after one step."""
    out = {}
    for kind in CHECKED:
        rd = obs.read[kind]
        grad = {n: math.sqrt(max(float(nu.double().sum()), 0.0)
                             / (1.0 - rtrain.B2))
                for n, nu in rd["nu1"].items()}
        change = {n: float((p.double() - weights_host[n].double()).norm())
                  for n, p in rd["params3"].items()}
        out[kind] = {"loss": rd["loss"], "grad": grad, "change": change}
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep):
    """Each kept leaf's gap between the two norms, against the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in keep)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}


def compare(prog: Dict, ref: Dict):
    """The numbers compared: per checked kind each step's loss gap against
    the loss's size (``reference/train.py::steps``), the worst leaf's gap
    of the first gradient and of the change over the three steps (leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out), the features that epoch 0's first step wrote to the bank,
    and epoch 0's eval outputs (the widest gap against the reference's
    RMS), with steadier companions: each leaf number's median leaf, the RMS
    gap of the text features (BERT's, before the fusion) and of the eval
    outputs. Returns them and lines that name the worst leaves."""
    tags = {"train_step": "task", "critic_step": "critic",
            "train_step_mi": "mi"}
    out, notes = {}, []
    for kind, tag in tags.items():
        p, r = prog[kind], ref[kind]
        med = statistics.median(r["grad"].values())
        keep = [n for n, g in r["grad"].items() if g >= 1e-3 * med]
        for i, (a, b, size) in enumerate(zip(p["loss"], r["loss"],
                                             r["scale"])):
            out[f"{tag}_loss_{i + 1}"] = abs(a - b) / size
        for what in ("grad", "change"):
            gaps = leaf_gaps(p[what], r[what], keep)
            worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
            out[f"{tag}_{what}"] = gaps[worst[0]]
            out[f"{tag}_{what}_median"] = statistics.median(gaps.values())
            notes.append(f"{tag}_{what}: worst "
                         + ", ".join(f"{n} {gaps[n]!r}" for n in worst)
                         + f"; {len(r[what]) - len(keep)} leaves left out")
    d = prog["bank"][0].shape[1] // 4
    a, b = prog["bank"][0], ref["bank"][0]
    out["bank_features"] = widest(a, b)
    out["text_features"] = rms_gap(a[:, d:2 * d], b[:, d:2 * d])
    a, b = torch.cat(prog["eval"]), torch.cat(ref["eval"])
    out["eval_outputs"] = max(widest(x, y) for x, y in
                              zip(prog["eval"], ref["eval"]))
    out["eval_outputs_rms"] = rms_gap(a, b)
    return out, notes


def widest(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest element gap against the reference's RMS."""
    return float((a - b).abs().max() / b.square().mean().sqrt())


def rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The gap's RMS against the reference's RMS."""
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def reference_readings(ctx, spec: M.Spec, flags: Dict, weights: Dict,
                       splits: Dict, bank: Dict, seeds: Dict[str, int],
                       seed: int, tf32: bool) -> Dict:
    """The reference's readings of the same steps from the same states,
    and of the bank rows and eval outputs."""
    dev = ctx.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    bs = spec.bs
    mu_dtype = (torch.bfloat16 if flags.get("--moment_dtype", "bfloat16")
                == "bfloat16" else torch.float32)
    train = splits["train"]
    scan = bool(flags.get("--epoch_scan"))
    # the schedule's factor in epoch 1 (stepped once): multi_step milestones
    milestones = [int(m) for m in str(flags["--lr_decrease_iter"]).split("-")]
    factor = float(flags["--lr_decrease_rate"]) ** sum(m <= 1 for m in milestones)
    out = {}

    def batches(pass_no: int, split, shuffle: bool, n: int = 3):
        idx, mask = rdata.plan(split.n, bs, seed + pass_no, shuffle)
        return [split.batch(idx[i], mask[i], dev)
                for i in range(min(n, len(idx)))]

    def params() -> Dict:
        return {k: v.to(dev).float().clone().requires_grad_(True)
                for k, v in weights.items()}

    scales = {n: (spec.bert_lr_rate if M.is_bert(n) else 1.0)
              for n in weights}
    main = [n for n in weights if not M.is_estimator(n)]
    est = [n for n in weights if M.is_estimator(n)]

    # epoch 0's first three stage-2 steps, from the seed
    P = params()
    opt = rtrain.Adam(main, P, spec.lr, scales, spec.clip, mu_dtype)
    r = rtrain.steps("task", P, spec, batches(0, train, True), Draws(dev, seed),
                     opt)
    out["train_step"] = r
    out["bank"] = [torch.cat(f, dim=1) for f in r["feats"]]
    del P, opt

    # epoch 1's first three critic steps and stage-2 steps, each from the
    # seeded weights, fresh moments, the seeded bank and reseeded generators
    dev_bank = {f: v.to(dev) for f, v in bank.items()}
    for kind, names, tag in (("critic_step", est, "critic"),
                             ("train_step_mi", main, "mi")):
        P = params()
        lr = spec.lr * factor * (spec.mi_lr_rate if tag == "critic" else 1.0)
        opt = rtrain.Adam(names, P, lr, scales, spec.clip, mu_dtype)
        # a per-batch epoch draws an order for each pass over the loader;
        # a stacked epoch draws one
        first_pass = 1 if tag == "critic" or scan else 1 + spec.stage1_n
        out[kind] = rtrain.steps(tag, P, spec, batches(first_pass, train, True),
                                 Draws(dev, seeds[kind]), opt, dev_bank)
        del P, opt
    del dev_bank

    # epoch 0's eval outputs, from the seeded weights
    P = params()
    evals = []
    for split in (splits["valid"], splits["test"]):
        idx, mask = rdata.plan(split.n, bs, 0, False)
        evals += [o for o in rtrain.outputs(
            P, spec, [split.batch(idx[i], mask[i], dev)
                      for i in range(len(idx))])]
    out["eval"] = evals
    del P
    return out


def run(ctx) -> Dict:
    from mimrl_tpu_torch.core.config import parse_args
    from mimrl_tpu_torch.core.logging import ScalarWriter
    from mimrl_tpu_torch.train import steps
    from mimrl_tpu_torch.train.solver import Solver

    args, cfg, mix = ctx.args, ctx.config, ctx.mix
    seed = args.seed
    flags = ctx.flags()
    ds = cfg["dataset"]
    spec = M.Spec(flags, ds["d_audio"], ds["d_video"])

    # set-up: the data set, the system and its weights
    utts = fixture.utterances(ds, seed)
    data_dir = os.path.join(ctx.scratch, "data")
    fixture.write(data_dir, ds, utts)
    opt = parse_args(harness.flag_argv(flags) + [
        "--seed", str(seed), "--data_dir", data_dir,
        "--task_dir", os.path.join(ctx.scratch, "runs"),
        "--task_name", ctx.cell])
    solver = Solver(opt, device=str(ctx.device))
    for f in os.listdir(data_dir):  # the loaders hold the data now
        os.remove(os.path.join(data_dir, f))
    shapes = M.param_shapes(spec)
    weights = harness.make_weights(shapes, seed, ctx.device,
                                 cfg.get("weights_fixed"))
    solver.model.load_state_dict(weights, strict=True)
    weights_host = {n: _host(w) for n, w in weights.items()}
    del weights
    n_real = len(solver.train_loader.ds)
    bank = seeded_bank(solver.bank, n_real, seed)
    seeds = {k: seed + v for k, v in STAGE_SEEDS.items()}
    if ctx.fault is not None:
        ctx.fault(ctx, solver)

    n_eval = len(solver.valid_loader) + len(solver.test_loader)
    obs = Observer(solver, n_eval, weights_host, bank, seeds)
    if solver.scan_mode:
        real_graphs = solver.graphs
        solver.graphs = GraphsProxy(real_graphs, obs)
        orig = None
    else:
        orig = _wrap_steps(steps, obs)
    warm = int(mix["warmup_epochs"])
    solve(solver, 0, warm)
    if orig is None:
        solver.graphs = real_graphs
    else:
        for n, f in orig.items():
            setattr(steps, n, f)
    solver.writer = ScalarWriter(solver.task_path)  # the warm-up closed it
    t_setup = time.perf_counter() - ctx.t_start

    # the window
    seconds = 0.0 if args.control else args.seconds
    session = trace.Session(ctx.device) if args.trace else None
    if session is not None:
        session.start()
    t0 = time.perf_counter()
    with trace.span("window"):
        epochs = solve(solver, warm, warm + 10 ** 6,
                       stop=lambda: time.perf_counter() - t0 >= seconds)
    t_window = time.perf_counter() - t0
    if session is not None:
        session.stop()
    device = harness.device_info(ctx.device)
    tr = session.reduce() if session is not None else None
    counts = {"epochs": epochs, "train_samples": epochs * n_real,
              "nb_train": len(solver.train_loader), "nb_eval": n_eval}

    # the system's readings; then the reference's, with the system freed
    prog = program_readings(obs, weights_host)
    prog["bank"] = obs.bank_rows
    prog["eval"] = obs.eval_outs
    del solver, session, obs
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    splits = {k: rdata.Split(v, spec.T, spec.vocab) for k, v in utts.items()}
    del utts
    tf32_control = bool(args.control and cfg["control"].get("tf32"))
    ref = reference_readings(ctx, spec, flags, weights_host, splits, bank,
                             seeds, seed, tf32=False)
    if tf32_control:  # the reference in TF32 in the system's place
        prog = reference_readings(ctx, spec, flags, weights_host, splits,
                                  bank, seeds, seed, tf32=True)
    numbers, notes = compare(prog, ref)
    notes.append(f"reference s: {time.perf_counter() - t_ref!r}")
    notes += [f"number {k}: {v!r}" for k, v in numbers.items()]
    limits = ctx.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    mean_rate = (counts["train_samples"] / t_window) if epochs else None
    return {"e2e": {"train_samples_per_s": mean_rate, "setup_s": t_setup,
                    "peak_mem_gb": device["memory_peak_bytes"] / 1e9},
            "checks": checks, "attempted": counts["train_samples"],
            "failed": 0, "device": device, "trace": tr, "counts": counts,
            "flags": flags, "window_s": t_window, "notes": notes}
