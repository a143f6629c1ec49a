"""Nothing the benchmark runs loads the JAX side, and its reference loads
nothing of the system: every module compared by its top-level name, taken
whole (``mimrl_tpu_torch`` is not ``mimrl_tpu``)."""

import ast
import os
import subprocess
import sys

from benchmark.tests.tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mimrl_tpu"}
# files of the repository that measure the JAX package, not the port
WRONG_PROGRAM = ("bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE.",
                 "docs/BENCH_", "docs/FULL_SCALE_", "tools/peak_flops",
                 "tools/microbench_gemm", "tools/ablate_step",
                 "tools/bert_anatomy", "tools/fa_tune", "tools/knob_sweep",
                 "tools/ref_compare", "chip_smoke")


def sources(sub=""):
    base = os.path.join(BENCH, sub)
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("cache", "__pycache__",
                                                "tests")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_side():
    for path in sources():
        assert not FORBIDDEN & set(imported_tops(path)), path


def test_the_reference_imports_nothing_of_the_system():
    for path in sources("reference"):
        assert "mimrl_tpu_torch" not in set(imported_tops(path)), path


def test_no_source_names_a_file_of_the_wrong_program():
    for path in sources():
        text = open(path).read()
        for name in WRONG_PROGRAM:
            assert name not in text, (path, name)


def test_loading_every_module_a_run_loads_keeps_the_jax_side_out():
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "from benchmark import harness, counts, readers, trace, fixture\n"
        "import benchmark.reference.model, benchmark.reference.train\n"
        "for kind, names in (('drivers', ('train', 'serve')), ('metrics', "
        "[f[:-3] for f in __import__('os').listdir({metrics!r}) "
        "if f.endswith('.py')])):\n"
        "    for n in names: harness.load_module(kind, n)\n"
        "import mimrl_tpu_torch.train.solver, mimrl_tpu_torch.eval.predict\n"
        "print(harness.isolation_violations())\n"
        "print(sorted(m for m in sys.modules if m.startswith('mimrl')))\n"
    ).format(root=ROOT, metrics=os.path.join(BENCH, "metrics"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    violations, loaded = p.stdout.strip().splitlines()[-2:]
    assert violations == "[]"
    assert "mimrl_tpu_torch.train.solver" in loaded


def test_the_isolation_check_compares_whole_top_level_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "mimrl_tpu_torch_probe", object())
    assert harness.isolation_violations() == []
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert harness.isolation_violations() == ["jaxlib"]
