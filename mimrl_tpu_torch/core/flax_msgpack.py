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

``msgpack_serialize`` is the inverse for such trees, byte for byte what
``flax.serialization.msgpack_serialize`` writes (msgpack's smallest
encodings, floats as doubles; an ndarray as extension 1, a numpy scalar
as extension 3; no array above flax's chunk size): a program or a test
that has no flax can write a slot in ``mimrl_tpu``'s format with it.
``skeleton`` keeps a tree's layout (every array's dtype and shape, the
values of the small ones, the plain values) as JSON, and ``seeded_tree``
refills it from a seed: a ``mimrl_tpu`` slot of a given config, with
seeded values, where the slot itself would be too large to keep.
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


_MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


def _sized(out: bytearray, n: int, small, markers) -> None:
    """The header of a sized item: ``small`` (a fixed-size marker base
    and its limit) or the first of ``markers`` ((marker, width), ...)
    whose width holds ``n``."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for marker, width in markers:
        if n < 1 << (8 * width):
            out.append(marker)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack: an item of {n} entries is too long")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xff)
    elif x >= 0:
        for marker, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if x < top:
                out.append(marker)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"msgpack: integer {x} out of range")
    else:
        for marker, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                                 (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if x >= low:
                out.append(marker)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"msgpack: integer {x} out of range")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _sized(out, n, None, ((0xc7, 1), (0xc8, 2), (0xc9, 4)))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack ``[shape, dtype name, C-order
    bytes]``; a bfloat16 torch tensor as numpy would hold it."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.bfloat16:
            x = x.numpy()
        else:
            shape, raw = list(x.shape), x.contiguous().view(torch.int16).numpy().tobytes()
            return _pack([shape, "bfloat16", raw])
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"msgpack: unsupported dtype {x.dtype}")
    if x.nbytes > _MAX_CHUNK_SIZE:
        raise ValueError("msgpack: arrays above flax's chunk size are "
                         "written in chunks, which this writer does not do")
    return _pack([list(x.shape), x.dtype.name, x.tobytes("C")])


def _pack_into(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif type(x) is str:
        raw = x.encode("utf-8")
        _sized(out, len(raw), (0xa0, 32), ((0xd9, 1), (0xda, 2), (0xdb, 4)))
        out += raw
    elif type(x) is bytes:
        _sized(out, len(x), None, ((0xc4, 1), (0xc5, 2), (0xc6, 4)))
        out += x
    elif type(x) is list:
        _sized(out, len(x), (0x90, 16), ((0xdc, 2), (0xdd, 4)))
        for item in x:
            _pack_into(out, item)
    elif type(x) is dict:
        _sized(out, len(x), (0x80, 16), ((0xde, 2), (0xdf, 4)))
        for key, value in x.items():
            _pack_into(out, key)
            _pack_into(out, value)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif type(x) is complex:
        _pack_ext(out, _EXT_COMPLEX, _pack([x.real, x.imag]))
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def _pack(x: Any) -> bytes:
    out = bytearray()
    _pack_into(out, x)
    return bytes(out)


def msgpack_serialize(tree: Any) -> bytes:
    """``tree`` (dicts with string keys, lists, Python scalars, numpy
    arrays and scalars, bfloat16 torch tensors) in flax's msgpack format."""
    return _pack(tree)


def write(path: str, tree: Any) -> None:
    """``msgpack_serialize`` of ``tree`` into a file."""
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


SKELETON_VALUES = 64  # arrays up to this many entries keep their values


def skeleton(tree: Any) -> Any:
    """The JSON layout of a tree: an array leaf becomes ``{"dtype",
    "shape"}`` (and ``"values"``, flat, up to ``SKELETON_VALUES``
    entries; a numpy scalar also ``"scalar": true``); dicts, lists and
    plain values stay."""
    if isinstance(tree, dict):
        return {k: skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [skeleton(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        bf16 = isinstance(tree, torch.Tensor)
        arr = tree.float().numpy() if bf16 else np.asarray(tree)
        out = {"dtype": "bfloat16" if bf16 else arr.dtype.name,
               "shape": list(arr.shape)}
        if isinstance(tree, np.generic):
            out["scalar"] = True
        if arr.size <= SKELETON_VALUES:
            out["values"] = arr.reshape(-1).tolist()
        return out
    return tree


def _is_leaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) >= {"dtype", "shape"} and (
        set(node) <= {"dtype", "shape", "values", "scalar"})


def seeded_tree(layout: Any, seed: int) -> Any:
    """A tree of ``skeleton``'s layout whose arrays keep their recorded
    values or are drawn from ``seed`` in the layout's order: under a path
    holding ``nu`` squares of N(0, 1e-3) (Adam's second moment is not
    negative), under ``mu`` N(0, 1e-3), a LayerNorm ``scale`` 1 + N(0,
    0.02), the rest N(0, 0.05). bfloat16 leaves are torch tensors."""
    rng = np.random.default_rng(seed)

    def fill(node, path):
        if _is_leaf(node):
            shape = tuple(node["shape"])
            if "values" in node:
                arr = np.asarray(node["values"], np.float64).reshape(shape)
            else:
                x = rng.standard_normal(shape)
                if "nu" in path:
                    arr = (1e-3 * x) ** 2
                elif "mu" in path:
                    arr = 1e-3 * x
                elif path[-1] == "scale":
                    arr = 1.0 + 0.02 * x
                else:
                    arr = 0.05 * x
            if node["dtype"] == "bfloat16":
                return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
            arr = arr.astype(node["dtype"])
            return arr[()] if node.get("scalar") else arr
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, path + (str(i),)) for i, v in enumerate(node)]
        return node

    return fill(layout, ())
