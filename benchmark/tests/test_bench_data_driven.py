"""The harness is driven by data: a configuration, a cell and a per-layer
metric are added as new files, and BENCHMARK.json keeps to its contract."""

import hashlib
import json
import os
import re

import pytest

from benchmark.tests import tiny
from benchmark.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key), key


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_each_entry_has_just_the_contracts_keys():
    for kind, (needed, optional) in ENTRY_KEYS.items():
        for entry in SPEC[kind]:
            assert needed <= set(entry) <= needed | optional, (kind, entry)
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert _one_line(entry["why"]), entry["name"]
    for c in SPEC["configs"]:
        assert _one_line(c["source"]) and len(c["reduced"]) <= 16
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace"), m["name"]
    for m in SPEC["per_layer"]:
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter"), m["name"]
        assert _one_line(m["layer"]), m["name"]
    assert all(_one_line(word) for word in SPEC["command"])


def test_every_cell_takes_one_chip_and_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_each_cell_and_configuration_has_its_files():
    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        wl = json.load(open(os.path.join(BENCH, "workloads",
                                         w["name"] + ".json")))
        assert (wl["config"], wl["traffic"], wl["why"]) == (
            w["config"], w["traffic"], w["why"])
        mix = json.load(open(os.path.join(BENCH, "traffic",
                                          w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           mix["driver"] + ".py"))
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_config_cell_and_metric_run_with_no_file_edited(tmp_path):
    copy = str(tmp_path)
    tiny.make_copy(copy)
    before = _digests(os.path.join(copy, "benchmark"))
    # a metric of its own: a new reader file and a BENCHMARK.json entry
    with open(os.path.join(copy, "benchmark", "metrics",
                           "probe_window.train.py"), "w") as f:
        f.write("def read(ctx, out):\n    return out['trace']['window_s']\n")
    spec = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    spec["per_layer"].append({
        "name": "probe_window.train", "unit": "s", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "train_samples_per_s",
        "workloads": ["tiny_mosi_bert_f32.train"]})
    json.dump(spec, open(os.path.join(copy, "BENCHMARK.json"), "w"))
    rc, result, err = tiny.run_cell(copy, "tiny_mosi_bert_f32.train", trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]
    assert result["metrics"]["probe_window.train"]["value"] > 0
    assert "mfu.train" in result["metrics"]
    after = _digests(os.path.join(copy, "benchmark"))
    assert {p: after[p] for p in before} == before


def test_a_run_without_the_system_fails(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark alone exits non-zero
    and prints no result."""
    import subprocess
    import sys
    copy = str(tmp_path)
    tiny.make_copy(copy)
    code = ("import sys; sys.path.insert(0, {copy!r}); "
            "from benchmark import harness; "
            "sys.exit(harness.main(['--workload', "
            "'tiny_mosi_bert_f32.serve', '--seed', '1', '--seconds', '1'], "
            "device='cpu'))").format(copy=copy)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=copy)
    assert p.returncode != 0
    assert not p.stdout.strip().endswith("}")
