"""The port stands alone: importing it loads neither JAX nor any module
of the JAX package, nor flax, msgpack, orbax, tensorstore or zstandard,
and no file of it (nor chip_smoke.py) imports them.

The import check runs in a subprocess, because this test session has
imported JAX already (tests/conftest.py).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import mimrl_tpu_torch

PACKAGE = Path(mimrl_tpu_torch.__file__).resolve().parent
# the card's machine has none of them: checkpoints of mimrl_tpu are read
# by the port's own readers (core/flax_msgpack.py; core/orbax_slot.py,
# whose OCDBT walker and zarr assembly need no tensorstore and whose zstd
# frames native/zstd.cpp decodes, without zstandard or a system libzstd)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax",
             "tensorstore", "zstandard", "mimrl_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax():
    code = ("import json, sys\n"
            "import mimrl_tpu_torch, mimrl_tpu_torch.eval.predict\n"
            "import mimrl_tpu_torch.models.convert, mimrl_tpu_torch.ops._build\n"
            "import mimrl_tpu_torch.cli.main, mimrl_tpu_torch.train.solver\n"
            "import mimrl_tpu_torch.core.flax_msgpack\n"
            "import mimrl_tpu_torch.core.orbax_slot\n"
            "import mimrl_tpu_torch.mi.estimators, mimrl_tpu_torch.mi.knn\n"
            "import mimrl_tpu_torch.models.fusion, mimrl_tpu_torch.train.custom\n"
            "import mimrl_tpu_torch.train.regularizers\n"
            "import mimrl_tpu_torch.tools.parity, mimrl_tpu_torch.data.preflight\n"
            "import mimrl_tpu_torch.mi.standalone, mimrl_tpu_torch.train.sam\n"
            "import mimrl_tpu_torch.parallel.mesh, mimrl_tpu_torch.parallel.check\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(PACKAGE.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mimrl_tpu_torch.eval.predict" in loaded
    assert "mimrl_tpu_torch.train.steps" in loaded
    assert "mimrl_tpu_torch.train.regularizers" in loaded
    assert "mimrl_tpu_torch.tools.parity" in loaded
    assert "mimrl_tpu_torch.mi.standalone" in loaded
    assert "mimrl_tpu_torch.parallel.check" in loaded
    # matplotlib (absent on the card's machine) only for --plot_dir
    assert "matplotlib" not in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_no_source_file_imports_jax():
    """Every file of the package, and chip_smoke.py, which drives it on
    the card."""
    offenders = []
    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(files) > 10
    for sub in ("mi", "train", "cli", "ops", "tools", "parallel"):
        assert any(path.parent.name == sub for path in files), sub
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not offenders
