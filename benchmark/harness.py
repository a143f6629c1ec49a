"""The benchmark's core: it finds a cell's files by name, makes the seeded
inputs and weights, runs the cell's driver, takes the metrics that
``BENCHMARK.json`` names for the cell, and prints the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- ``configs/<config>.json``: the configuration as it is run (the system's
  flags, the data set's widths and fold sizes, the peak that MFU divides
  by, the control, ``source``, ``assumed``, ``reduced``);
- ``workloads/<cell>.json``: the cell's configuration, traffic mix, the
  limits of its correctness numbers and ``why``;
- ``traffic/<mix>.json``: the mix's parameters and the driver that runs it
  (``drivers/<driver>.py``);
- ``metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mimrl_tpu")
CACHE = os.path.join(HERE, "cache")


def cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout (the system builds
    its own CUDA libraries under ``mimrl_tpu_torch/ops/build/``)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load(kind: str, name: str) -> Dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_spec() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics (those that list the cell, or
    that list no cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def flag_argv(flags: Dict) -> List[str]:
    """{"--flag": value | true} -> the system's command line."""
    argv = []
    for k, v in flags.items():
        if v is True:
            argv.append(k)
        elif v is not False and v is not None:
            argv += [k, str(v)]
    return argv


def make_weights(shapes: Dict, seed: int, device,
                 fixed: Optional[Dict[str, List[float]]] = None):
    """Seeded weights on ``device`` from one normal draw: LayerNorm scales
    1 and shifts 0, other biases 0, BERT's N(0, 0.02) (its initializer
    range), the GRUs' N(0, 1 / sqrt(3 * hidden)) (the spread of their
    uniform init), the rest N(0, 1 / sqrt(fan_in)); then the leaves that
    ``fixed`` names ({name: values}, a configuration's ``weights_fixed``)
    take those values."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        parts = name.split(".")
        leaf, module = parts[-1], parts[-2]
        if "LayerNorm" in parts or module.startswith("ln_"):
            w.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf.startswith("bias"):
            w.zero_()
        elif name.startswith("bertmodel."):
            w.mul_(0.02)
        elif name.startswith(("rnn_a.", "rnn_v.")):
            w.mul_(1.0 / math.sqrt(shape[0]))
        else:
            w.mul_(1.0 / math.sqrt(shape[-1]))
        out[name] = w
    for name, values in (fixed or {}).items():
        out[name].copy_(torch.tensor(values, dtype=out[name].dtype))
    return out


def isolation_violations() -> List[str]:
    """Modules of the JAX side loaded in this process, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


class Context:
    """What a driver gets: the run's arguments, the cell's files, the
    device, the process's start time and a scratch directory."""

    def __init__(self, args, device, t_start: float):
        self.args = args
        self.cell = args.workload
        self.workload = load("workloads", args.workload)
        self.config = load("configs", self.workload["config"])
        self.mix = load("traffic", self.workload["traffic"])
        self.device = device
        self.t_start = t_start
        tmp = os.environ.get("TMPDIR") or "/tmp"
        self.scratch = os.path.join(tmp, f"bench_{os.getpid()}")
        os.makedirs(self.scratch, exist_ok=True)
        # the tests' hook: fault(context, system), called once set-up has
        # built the system
        self.fault: Optional[Callable] = None

    def flags(self) -> Dict:
        flags = dict(self.config["flags"])
        flags.update(self.mix.get("flags", {}))
        if self.args.control:
            flags.update(self.config["control"].get("flags", {}))
        return flags


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", type=int, default=0, choices=(0, 1),
                   help="run the configuration's control in place of the "
                   "system (its readings are expected to fail the limits)")
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None, device=None,
         prepare: Optional[Callable] = None) -> int:
    """Run a cell; ``device`` "cpu" and ``prepare(context)`` serve the
    tests (a CPU run skips the look for a card)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    wl = load("workloads", args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark: no CUDA device", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < wl["chips"]:
            print(f"benchmark: {wl['chips']} cards wanted, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Context(args, device, t_start)
    if prepare is not None:
        prepare(ctx)
    driver = load_module("drivers", ctx.mix["driver"])
    try:
        out = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.scratch, ignore_errors=True)
    spec = bench_spec()
    wanted = cell_metrics(spec, args.workload, bool(args.trace))
    metrics = {}
    for m in wanted:
        if args.trace:
            value = load_module("metrics", m["name"]).read(ctx, out)
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = isolation_violations()
    if bad:
        print(f"benchmark: JAX-side modules loaded: {bad}", file=sys.stderr)
        return 4
    checks = out["checks"]
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": dict(out["device"])}
    if args.trace:
        tr = out["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                               "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for line in out.get("notes", []):
        print(line, file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r}"
              f"{'' if v <= lim else '  FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
