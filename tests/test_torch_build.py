"""The build and the C interface of the port's CUDA sources, on the CPU.

``ops/_build.py`` runs against a stand-in for ``nvcc`` (a recorder in
place of ``subprocess.Popen``): one compile per source and variant, all
started before any is waited on, each for ``sm_90a`` with its dtype code;
a library reused while its source, headers and flags are unchanged; a
failed compile raises and leaves no library. Every ``extern "C"`` entry
point of ``ops/csrc/*.cu`` is held against the ctypes signature its
wrapper configures: a mismatch there passes arguments in the wrong
registers, and would show only on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mimrl_tpu_torch.ops import _build
from mimrl_tpu_torch.ops import cubemlp_kernel
from mimrl_tpu_torch.ops import flash_attention as fa_mod
from mimrl_tpu_torch.ops import int8_matmul

N_LIBRARIES = sum(len(v) for v in _build.SOURCES.values())


class _Compiles:
    """Stands in for ``subprocess.Popen`` in ``_build``: records each
    command, writes its output file when waited on, and fails the targets
    named in ``fail``."""

    def __init__(self, fail=()):
        self.started, self.started_at_first_wait, self.fail = [], None, fail

    def __call__(self, cmd, **_):
        self.started.append(cmd)
        return _Compile(self, cmd)


class _Compile:
    def __init__(self, owner, cmd):
        self.owner, self.cmd, self.returncode = owner, cmd, None

    def communicate(self):
        if self.owner.started_at_first_wait is None:
            self.owner.started_at_first_wait = len(self.owner.started)
        source = Path(self.cmd[-1]).name
        code = int(next(a for a in self.cmd if a.startswith("-DMIMRL_DTYPE="))
                   .split("=")[1])
        if (source, code) in self.owner.fail:
            self.returncode = 1
            return f"{source}: error: stand-in failure\n", None
        Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"library")
        self.returncode = 0
        return f"ptxas info    : Used 40 registers ({source})\n", None


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    return tmp_path / "build"


def test_build_starts_every_compile_before_waiting(build_dir, monkeypatch):
    compiles = _Compiles()
    monkeypatch.setattr(subprocess, "Popen", compiles)
    paths = _build.build()
    assert len(compiles.started) == compiles.started_at_first_wait == N_LIBRARIES
    assert sorted(paths) == sorted((s, v) for s, vs in _build.SOURCES.items()
                                   for v in vs)
    for cmd in compiles.started:
        assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    for (source, variant), lib in paths.items():
        assert lib == _build.library_path(source, variant)
        assert lib.parent == build_dir and lib.read_bytes() == b"library"
        assert lib.with_suffix(".log").read_text().endswith(f"({source})\n")
        cmd = next(c for c in compiles.started if Path(c[-1]).name == source
                   and f"-DMIMRL_DTYPE={_build.VARIANTS[variant]}" in c)
        assert Path(cmd[-1]) == _build.CSRC / source
    assert not list(build_dir.glob("*.tmp"))


def test_build_reuses_an_unchanged_library(build_dir, monkeypatch):
    monkeypatch.setattr(subprocess, "Popen", _Compiles())
    first = _build.build()
    again = _Compiles()
    monkeypatch.setattr(subprocess, "Popen", again)
    assert _build.build(["int8_matmul.cu"]) == {
        ("int8_matmul.cu", "int8"): first[("int8_matmul.cu", "int8")]}
    assert _build.build() == first and again.started == []


def test_failed_compile_raises_and_keeps_no_library(build_dir, monkeypatch):
    failing = ("flash_attention_bwd.cu", _build.VARIANTS["bfloat16"])
    monkeypatch.setattr(subprocess, "Popen", _Compiles(fail={failing}))
    with pytest.raises(RuntimeError, match=r"flash_attention_bwd\.cu \[bfloat16\]"
                       r" \(exit 1\):\nflash_attention_bwd\.cu: error"):
        _build.build()
    bad = _build.library_path("flash_attention_bwd.cu", "bfloat16")
    assert not bad.exists() and "error" in bad.with_suffix(".log").read_text()
    assert _build.library_path("flash_attention_bwd.cu", "float32").exists()


def test_library_name_follows_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    name = _build.library_path("flash_attention_fwd.cu", "bfloat16").name
    assert re.fullmatch(r"flash_attention_fwd-bfloat16-[0-9a-f]{16}\.so", name)
    assert _build.library_path("flash_attention_fwd.cu", "float32").name != name
    header = csrc / "philox.cuh"
    text = header.read_text()
    header.write_text(text + "\n")
    assert _build.library_path("flash_attention_fwd.cu", "bfloat16").name != name
    header.write_text(text)
    assert _build.library_path("flash_attention_fwd.cu", "bfloat16").name == name
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_attention_fwd.cu", "bfloat16").name != name


@pytest.mark.parametrize("through", ["CUDA_HOME", "PATH"])
def test_nvcc_path_finds_the_compiler(tmp_path, monkeypatch, through):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if through == "CUDA_HOME":
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    else:
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setenv("PATH", str(nvcc.parent))
    assert _build.nvcc_path() == str(nvcc)


_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "unsigned int": ctypes.c_uint, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _c_signatures():
    """{name: (return ctype, [argument ctypes])} of every ``extern "C"``
    function in csrc/*.cu."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for ret, name, params in re.findall(
                r'extern "C" ([a-z ]+?) (mimrl_\w+)\(([^)]*)\)', text):
            args = []
            for param in params.split(","):
                words = param.replace("*", " * ").split()[:-1]
                words = [w for w in words if w != "const"]
                args.append(_CTYPES["void*" if "*" in words else " ".join(words)])
            found[name] = (_CTYPES[ret], args)
    return found


class _Function:
    """What a wrapper sets on a ctypes function: argtypes and restype."""


class _Library:
    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, _Function())


def _configured(monkeypatch, name):
    """The function object ``name`` as its wrapper configures it, from a
    stand-in library."""
    libs = {}

    def load(source, variant):
        return libs.setdefault((source, variant), _Library())

    monkeypatch.setattr(_build, "load", load)
    if name.startswith("mimrl_flash"):
        monkeypatch.setattr(fa_mod, "_entries", {})
        source = fa_mod.SOURCE_BWD if "_bwd" in name else fa_mod.SOURCE
        # device pointers as the wrappers pass them: q k v bias out seed;
        # q k v bias d_out seed dq [dq_acc] dk dv
        n_pointers = {"mimrl_flash_attention_fwd": 6,
                      "mimrl_flash_attention_fwd_tc": 6,
                      "mimrl_flash_attention_bwd": 10,
                      "mimrl_flash_attention_bwd_tc": 9}[name]
        return fa_mod._entry(source, name, n_pointers, torch.bfloat16)
    if "cubemlp" in name:
        monkeypatch.setattr(cubemlp_kernel, "_entry", None)
        cubemlp_kernel._kernel_entry()
        (lib,) = libs.values()
        return lib.functions[name]
    monkeypatch.setattr(int8_matmul, "_entries", {})
    return int8_matmul._entry(name)


# every entry point a wrapper configures; the backward's
# mimrl_flash_attention_bwd_tc_max_t(int) is read only by a card test
ENTRY_POINTS = ("mimrl_flash_attention_fwd", "mimrl_flash_attention_fwd_tc",
                "mimrl_flash_attention_bwd", "mimrl_flash_attention_bwd_tc",
                "mimrl_cubemlp_axis_mlp", "mimrl_cubemlp_axis_mlp_smem",
                "mimrl_int8_matmul", "mimrl_int8_matmul_wgmma")


def test_every_entry_point_is_configured():
    assert set(_c_signatures()) == set(ENTRY_POINTS) | {
        "mimrl_flash_attention_bwd_tc_max_t"}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_ctypes_signature_matches_the_source(monkeypatch, name):
    ret, args = _c_signatures()[name]
    fn = _configured(monkeypatch, name)
    assert fn.restype is ret
    assert list(fn.argtypes) == args
