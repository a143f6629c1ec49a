"""A reader of flax's msgpack checkpoints (``flax.serialization.to_bytes``,
the ``*_model.msgpack`` slots that ``mimrl_tpu`` writes), in pure Python:
neither flax nor the ``msgpack`` package is needed.

The format is msgpack (https://msgpack.org) with three extension types
of flax's (``flax/serialization.py``, ``_MsgpackExtType``):

- 1, ndarray: the payload is itself msgpack, ``[shape, dtype name, bytes]``
  with the bytes in C order;
- 2, native complex: the payload is msgpack ``[real, imag]``;
- 3, npscalar: an ndarray payload of shape ``[]``, returned as a scalar.

Arrays above flax's ``MAX_CHUNK_SIZE`` are written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat chunk, ...}}``; ``msgpack_restore`` joins them back.

Leaves come back as numpy arrays, or as torch tensors for ``bfloat16``,
which numpy has no dtype for (the bytes are read as ``uint16`` and viewed
as ``torch.bfloat16``). Sequences come back as lists, maps as dicts.
A byte, extension type or dtype that this module does not know raises
``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: marker -> struct format (big-endian)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed items: marker -> (kind, width of the length)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_WIDTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(want {n} more of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.read_map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.read_array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.read_str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.read_ext(_FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_WIDTH[width])
            return getattr(self, "read_" + kind)(n)
        raise ValueError(f"msgpack: unknown marker 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def read_bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def read_str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def read_array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def read_ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = _whole(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown extension type {code}")


def _whole(data) -> Any:
    """The one msgpack object that fills ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the object")
    return out


def _ndarray(payload):
    """flax's ndarray payload -> a numpy array, or a torch tensor for
    bfloat16 (writable copies: the buffer is the file's)."""
    shape, name, raw = _whole(payload)
    if not isinstance(name, str) or not isinstance(raw, bytes):
        raise ValueError(f"msgpack: malformed ndarray payload ({name!r})")
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: unknown dtype {name!r}") from e
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"msgpack: unsupported dtype {name!r}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked arrays back into one array, everywhere."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = _dict_to_tuple(tree["shape"])
        chunks = _dict_to_tuple(tree["chunks"])
        if all(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> Any:
    """The tree that ``flax.serialization.msgpack_serialize`` (or
    ``to_bytes``) encoded in ``data``, leaves as numpy arrays (torch
    tensors for bfloat16)."""
    return _unchunk(_whole(data))


def read(path: str) -> Any:
    """``msgpack_restore`` of a file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
