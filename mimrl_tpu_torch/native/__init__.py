"""ctypes loader for the port's host-pipeline library (``collate.cpp``):
padded-batch assembly and a WordPiece encoder with a plain C interface.

The library is built with ``g++`` at first use into ``ops/build/`` (a
directory git ignores), under a name that carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused; the compiler writes a temporary file that is renamed into place,
so two processes that build at once both load a whole library. Nothing
is built at import time.

Unlike the JAX package's loader, this one does not fall back: a failed
build raises with the compiler's output, and a library that does not
load raises too. The numpy forms in ``data/pipeline.py`` and
``data/tokenizer.py`` stay as the plain versions, which the tests hold
this library against and which a caller may ask for by name.

``calls`` counts each entry point's calls, so a caller can show that a
path went through the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls: Dict[str, int] = {"pad_stack": 0, "tokenizer": 0}

_lib: Optional[ctypes.CDLL] = None
# the NativeWordPiece whose vocabulary the library holds (it keeps one)
_installed: Optional["NativeWordPiece"] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"collate-{digest}.so"


def build() -> Path:
    """Compile ``collate.cpp`` unless its library exists; raises with the
    compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host-pipeline library "
                           f"{SOURCE} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=240)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"the host-pipeline library {path} does not "
                           f"load: {e}") from e
    lib.pad_stack_f32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.pad_stack_f32.restype = None
    lib.tokenizer_init.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.tokenizer_init.restype = ctypes.c_int32
    lib.tokenizer_encode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tokenizer_encode_batch.restype = None
    lib.tokenizer_free.argtypes = []
    lib.tokenizer_free.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def pad_stack(arrays: Sequence[np.ndarray], time_len: int) -> np.ndarray:
    """Stack ``[len_i, d]`` arrays into float32 ``[n, time_len, d]``,
    truncating or zero-padding the time axis."""
    arrs = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    if not arrs or any(a.ndim != 2 or a.shape[1] != arrs[0].shape[1]
                       for a in arrs):
        raise ValueError("pad_stack takes a non-empty list of [len, d] "
                         "arrays of one width d")
    lib = load()
    n, d = len(arrs), arrs[0].shape[1]
    out = np.empty((n, time_len, d), np.float32)
    srcs = (ctypes.c_void_p * n)(*[_ptr(a).value for a in arrs])
    lens = (ctypes.c_int64 * n)(*[a.shape[0] for a in arrs])
    lib.pad_stack_f32(ctypes.cast(srcs, ctypes.POINTER(ctypes.c_void_p)),
                      lens, n, time_len, d, _ptr(out))
    calls["pad_stack"] += 1
    return out


def byte_exact(text: str) -> bool:
    """True when the library's byte-wise rules (ASCII spaces, ASCII
    punctuation, A-Z lowered) split ``text`` as the plain tokenizer's
    Unicode rules do: ASCII without the separators U+001C-U+001F, which
    Python counts as spaces."""
    return text.isascii() and not any("\x1c" <= c <= "\x1f" for c in text)


class NativeWordPiece:
    """The library's WordPiece encoder, with the contract of
    ``WordPieceTokenizer.batch_encode`` for a ``vocab.txt`` vocabulary
    (the hash vocabulary stays in Python). A text that is not
    ``byte_exact`` is encoded by ``plain``, the tokenizer's own Python
    form, so every row equals the plain version's."""

    def __init__(self, vocab_tokens: List[str], pad_id: int, unk_id: int,
                 cls_id: int, sep_id: int, lower: bool, plain) -> None:
        load()
        self._blob = "\n".join(vocab_tokens).encode("utf-8")
        self._ids = (pad_id, unk_id, cls_id, sep_id, 1 if lower else 0)
        self._plain = plain
        self.vocab_size = self._install()

    def _install(self) -> int:
        global _installed
        size = load().tokenizer_init(self._blob, len(self._blob), *self._ids)
        _installed = self
        return size

    def batch_encode(self, texts: Sequence[str], max_length: int):
        if _installed is not self:
            self._install()
        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        types = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        load().tokenizer_encode_batch(
            b"".join(encoded), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_length, _ptr(ids), _ptr(types), _ptr(mask))
        for i, t in enumerate(texts):
            if not byte_exact(t):
                row = self._plain(t, max_length)
                ids[i], types[i], mask[i] = (np.asarray(r, np.int32) for r in row)
        calls["tokenizer"] += 1
        return ids, types, mask
