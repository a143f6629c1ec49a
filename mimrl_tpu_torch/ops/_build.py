"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into shared libraries under ``ops/build/`` (a
directory git ignores), one per variant that ``SOURCES`` names for it. An
attention source holds its kernel for 5 head dims, with and without
dropout, and its two input types compile side by side in half the time;
the CubeMLP source is float32 only, and the int8 GEMM takes its output
type at run time, so each of them is one library. The library's name
carries a hash of the source, of every header in ``csrc/`` and of the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. ``build()`` starts one ``nvcc`` per source and variant, all at
once, and waits for them together. The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside each library as
``.log``.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# variant -> the dtype code the source is compiled for (MIMRL_DTYPE)
VARIANTS = {"float32": 0, "bfloat16": 1, "int8": 2}
# source -> the variants it is built for
SOURCES = {
    "flash_attention_fwd.cu": ("float32", "bfloat16"),
    "flash_attention_bwd.cu": ("float32", "bfloat16"),
    "cubemlp_axis_mlp.cu": ("float32",),
    "int8_matmul.cu": ("int8",),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Tuple[str, str], ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str, variant: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / source).read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{variant}-{digest}.so"


def build(sources: Optional[Iterable[str]] = None
          ) -> Dict[Tuple[str, str], Path]:
    """Compile every (source, variant) of ``sources`` (default: all of
    ``SOURCES``) whose library is missing, all in parallel; returns
    {(source, variant): library path}. Raises with nvcc's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    paths = {}
    for target in ((s, v) for s in sources or SOURCES for v in SOURCES[s]):
        src, variant = target
        lib = library_path(src, variant)
        paths[target] = lib
        if lib.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-DMIMRL_DTYPE={VARIANTS[variant]}",
               "-o", str(tmp), str(CSRC / src)]
        running[target] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
    failed = []
    for (src, variant), (proc, tmp, lib) in running.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} [{variant}] (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(source: str, variant: str) -> ctypes.CDLL:
    """The loaded library of one source and variant. The first use builds
    whatever is missing of every source and variant, side by side: a train
    step needs several of them at once, and all take as long as the slowest."""
    if (source, variant) not in _loaded:
        lib = build()[(source, variant)]
        _loaded[(source, variant)] = ctypes.CDLL(str(lib))
    return _loaded[(source, variant)]
