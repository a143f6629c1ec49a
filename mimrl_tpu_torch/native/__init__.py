"""ctypes loader for the port's native library, two sources with a plain
C interface: ``collate.cpp`` (padded-batch assembly and a WordPiece
encoder) and ``zstd.cpp`` (a Zstandard decoder, XXH64 and CRC-32C, which
``core/orbax_slot.py`` reads ``mimrl_tpu``'s orbax slots with).

The library is built with ``g++`` at first use into ``ops/build/`` (a
directory git ignores), under a name that carries a hash of the sources
and the flags, so an edited source is rebuilt and an unchanged one is
reused; the compiler writes a temporary file that is renamed into place,
so two processes that build at once both load a whole library. Nothing
is built at import time.

Unlike the JAX package's loader, this one does not fall back: a failed
build raises with the compiler's output, a library that does not load
raises too, and so does a zstd frame that does not decode (with the byte
offset of the fault). The numpy forms in ``data/pipeline.py`` and
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("collate.cpp", "zstd.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls: Dict[str, int] = {"pad_stack": 0, "tokenizer": 0, "zstd": 0}

_lib: Optional[ctypes.CDLL] = None
# the NativeWordPiece whose vocabulary the library holds (it keeps one)
_installed: Optional["NativeWordPiece"] = None


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"native-{digest}.so"


def build() -> Path:
    """Compile the sources unless their library exists; raises with the
    compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library of "
                           f"{[s.name for s in SOURCES]} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=240)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {[str(s) for s in SOURCES]} (exit "
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
        raise RuntimeError(f"the native library {path} does not "
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
    lib.zstd_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_decompress.restype = ctypes.c_int64
    lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
    lib.crc32c.restype = ctypes.c_uint32
    _lib = lib
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _buffer(data) -> Tuple[ctypes.c_void_p, int, object]:
    """(address, length, owner) of a bytes-like object, without a copy
    for numpy arrays, bytearrays, writable memoryviews and bytes."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        return _ptr(arr), arr.nbytes, arr
    if isinstance(data, bytes):
        ptr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
        return ptr, len(data), data
    arr = np.frombuffer(data, np.uint8)
    return _ptr(arr), arr.nbytes, arr


def zstd_decompress(data, size: int, out: Optional[np.ndarray] = None,
                    exact: bool = True) -> np.ndarray:
    """The ``size`` bytes that the zstd frames in ``data`` decode to, in a
    new uint8 array or written into ``out`` (a contiguous array of
    ``size`` bytes, any dtype), which is returned; raises ``ValueError``
    with the input offset of a fault, or when the frames hold another
    size (``exact=False``: at most ``size`` bytes, and the uint8 array of
    those is returned)."""
    src, n, keep = _buffer(data)
    if out is None:
        out = np.empty(size, np.uint8)
    if not out.flags.c_contiguous or out.nbytes != size:
        raise ValueError(f"zstd: the output buffer holds {out.nbytes} bytes "
                         f"(contiguous: {out.flags.c_contiguous}), not {size}")
    err = ctypes.create_string_buffer(512)
    got = load().zstd_decompress(src, n, _ptr(out), size, err, len(err))
    del keep
    calls["zstd"] += 1
    if got < 0:
        raise ValueError(err.value.decode())
    if got != size:
        if not exact:
            return out.reshape(-1).view(np.uint8)[:got]
        raise ValueError(f"zstd: the frames hold {got} bytes, not {size}")
    return out


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    src, n, keep = _buffer(data)
    return int(load().crc32c(src, n, crc))


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
