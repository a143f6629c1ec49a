"""A copy of the benchmark with tiny cells beside the real ones, for the CPU
tests: the same files with BERT 2 x 32, bs 8, T 12 and 20 / 9 / 9
utterances, run in a subprocess on the CPU (the look for a card skipped)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY_FLAGS = {"--batch_size": 8, "--time_len": 12, "--d_common": 32,
              "--d_hiddens": "6-3-32=4-3-32", "--d_outs": "6-3-32=4-3-32",
              "--bert_layers": 2, "--bert_hidden": 32, "--bert_heads": 2,
              "--bert_intermediate": 64, "--num_workers": 0}
# numbers that a sound tiny run keeps well inside and each fault leaves
TRAIN_LIMITS = {"task_loss_1": 1e-3, "task_grad": 0.05, "task_change": 0.7,
                "critic_loss_1": 1e-3, "critic_grad": 0.01,
                "mi_loss_1": 1e-3, "mi_grad": 0.05, "bank_features": 0.01,
                "eval_outputs": 1e-3}
SERVE_LIMITS = {"serve_outputs": 1e-3}


def make_copy(dst: str) -> None:
    """``dst`` gets BENCHMARK.json and the benchmark's files, plus a tiny
    ``mosi_bert_f32``, ``tiny_mosi_bert_f32``, with a train and a serve
    cell."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    spec = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    for base in ("mosi_bert_f32",):
        cfg = json.load(open(os.path.join(BENCH, "configs", f"{base}.json")))
        name = f"tiny_{base}"
        cfg["name"] = name
        cfg["dataset"].update(splits=[20, 9, 9], max_len=13, n_words=50)
        cfg["flags"].update(TINY_FLAGS)
        write(dst, "configs", name, cfg)
        for kind, limits in (("train", TRAIN_LIMITS), ("serve", SERVE_LIMITS)):
            wl = json.load(open(os.path.join(BENCH, "workloads",
                                             f"{base}.{kind}.json")))
            wl.update(config=name, limits=limits)
            write(dst, "workloads", f"{name}.{kind}", wl)
            cell = f"{name}.{kind}"
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": kind, "chips": 1,
                                      "why": wl["why"]})
            real = f"{base}.{kind}"
            for m in spec["end_to_end"] + spec["per_layer"]:
                if real in m.get("workloads", []):
                    m["workloads"].append(cell)
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": sorted(TINY_FLAGS),
                                "why": "a tiny copy for tests on the CPU"})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)


def write(dst: str, kind: str, name: str, obj: Dict) -> None:
    with open(os.path.join(dst, "benchmark", kind, f"{name}.json"), "w") as f:
        json.dump(obj, f, indent=1)


RUNNER = """
import sys
sys.path[:0] = [{copy!r}, {root!r}]
from benchmark import harness

def fault(ctx, system):
{fault}

sys.exit(harness.main({argv!r}, device={device!r},
                      prepare=lambda ctx: setattr(ctx, "fault", fault)))
"""


def run_cell(copy: str, cell: str, seed: int = 1234, trace: int = 0,
             fault: Optional[str] = None, timeout: int = 300,
             device: Optional[str] = "cpu"):
    """(exit code, the result line as a dict or None, stderr) of one run
    of ``cell`` in ``copy``, on the CPU unless ``device`` is None (the
    card); ``fault`` is the body of ``fault(ctx, system)``, run after
    set-up builds the system."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", str(trace)]
    body = "    " + (fault or "pass").replace("\n", "\n    ")
    code = RUNNER.format(copy=copy, root=ROOT, fault=body, argv=argv,
                         device=device)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=copy)
    lines = p.stdout.strip().splitlines()
    result = None
    if lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    return p.returncode, result, p.stderr
