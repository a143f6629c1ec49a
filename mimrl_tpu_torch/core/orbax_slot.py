"""A reader of ``mimrl_tpu``'s orbax checkpoint slots (the
``{slot}_model.orbax/`` directories that ``--ckpt_backend orbax`` writes),
with neither orbax, tensorstore nor libzstd installed, and a writer of the
same layout for the checks.

``read(path)`` returns the tree that ``flax_msgpack.read`` returns for the
same state saved as msgpack: nested dicts with string keys, numpy arrays
(torch bfloat16 tensors for ``bfloat16``) and Python scalars, so that
``Solver._slot_from_jax`` and ``models/convert.py`` take either.

The directory, as orbax's ``StandardCheckpointHandler`` writes it:

- ``_CHECKPOINT_METADATA``: the commit marker. orbax writes a slot into a
  ``*.orbax-checkpoint-tmp-*`` directory and renames it when the save is
  done, so a directory without the marker (or with that name) is an
  uncommitted save, and reading it raises.
- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to its
  ``key_metadata`` (``key_type`` 2 for a dict key or field name, 1 for a
  sequence index) and ``value_metadata`` (``value_type`` ``np.ndarray``,
  ``jax.Array`` or ``scalar``; ``None``, ``Dict``, ``List`` or ``Tuple``
  with ``skip_deserialize`` for an empty node). Key paths are taken from
  ``key_metadata``, never by splitting a joined name, since a name may
  hold ``.``. Sequence indices become the string keys that flax's msgpack
  gives a tuple. An empty node becomes ``{}``: that is what flax's msgpack
  gives an empty dict, tuple or list and optax's ``EmptyState``, which
  orbax writes as ``None``; orbax writes a Python ``None`` leaf the same
  way, and a ``mimrl_tpu`` slot holds none. A ``scalar`` comes back as a
  Python int or float, as msgpack gives the slot's ``epoch``,
  ``global_step`` and ``lr_factor``.
- An OCDBT key-value store (tensorstore's "optionally-cooperative
  distributed B+tree", described in tensorstore's documentation
  ``kvstore/ocdbt``) at the top (``manifest.ocdbt``, ``d/``), whose values
  lie in the per-process stores' data files (``ocdbt.process_0/d/``).
  Every manifest and B+tree node is a file or file range that opens with a
  magic number (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), its
  length (64 bits), a format version (0) and a compression (0 none, 1 a
  zstd frame), and closes with the CRC-32C of what precedes it, which is
  checked. The manifest holds the config, a data-file table and the
  newest versions (older ones in version-tree nodes, not read); the newest
  version's root is walked through interior nodes (keys and their
  subtree-common prefixes prefix-compressed) to the leaves, whose values
  are inline or a (data file, offset, length) range.
- In that store, zarr v2 arrays named by the key path joined with ``.``:
  ``{name}/.zarray`` (JSON: shape, chunks, dtype ``<f4`` ``<f8`` ``<i4``
  ``<i8`` ``|u1`` ``|b1`` or ``bfloat16``, order C, compressor zstd or
  null, fill value, dimension separator ``.`` or ``/``) and one key per
  chunk (``{name}/0.0``; ``{name}/0`` for a shape ``[]``). Chunks at the
  upper edges are stored whole and cut; a missing chunk is the fill value,
  zeros for a null one (as tensorstore reads it).

zstd frames are decoded by the port's own decoder (``native/zstd.cpp``),
into the array's own buffer where the chunk is the whole array, and the
CRC-32C is computed there too. A truncated file, a bad magic number, a bad
checksum, an unknown version or compression, or a layout this module does
not know raises ``ValueError`` with the file's path.

``write(path, tree)`` writes such a directory from a tree of that form:
one OCDBT leaf node and one data file, one chunk per array, zstd frames of
Raw blocks (no encoder is needed) or uncompressed, and ``_METADATA`` and
``_CHECKPOINT_METADATA`` as orbax writes them, so that orbax reads it
back. It is for the checks and tests; training never writes it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mimrl_tpu_torch import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_LOCATION = (1 << 64) - 1
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
COMMIT_MARKER = "_CHECKPOINT_METADATA"
TMP_INFIX = ".orbax-checkpoint-tmp-"
# orbax's defaults for the store it writes
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
MAX_MANIFEST_BYTES = 1 << 26  # a bound for a manifest of undeclared size
ARRAY_TYPES = ("np.ndarray", "jax.Array")
EMPTY_TYPES = ("None", "Dict", "List", "Tuple")
DTYPES = ("<f4", "<f8", "<i4", "<i8", "|u1", "|b1", "bfloat16")


class _Cursor:
    """Reads varints and fixed fields from a decoded body."""

    def __init__(self, data, where: str):
        self.buf = memoryview(data)
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} at byte {self.pos}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail(f"truncated (want {n} more of {len(self.buf)})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} bytes after the end")


def _frame_size(frame, where: str) -> Optional[int]:
    """The content size that a zstd frame's header declares, or None (a
    frame written by a stream, as tensorstore's larger nodes are)."""
    if len(frame) < 6 or bytes(frame[:4]) != _ZSTD_MAGIC:
        raise ValueError(f"{where}: not a zstd frame")
    fhd = frame[4]
    single = (fhd >> 5) & 1
    n = (0, 2, 4, 8)[fhd >> 6] or (1 if single else 0)
    if n == 0:
        return None
    p = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
    if p + n > len(frame):
        raise ValueError(f"{where}: truncated zstd frame header")
    return int.from_bytes(frame[p:p + n], "little") + (256 if n == 2 else 0)


def _envelope(raw, magic: int, where: str, cap: int) -> bytes:
    """The body of an OCDBT manifest or node, its header and CRC-32C
    checked; ``cap`` bounds a compressed body of undeclared size (the
    buffer's pages that the body does not fill are never touched)."""
    raw = memoryview(raw)
    if len(raw) < 18:
        raise ValueError(f"{where}: truncated ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"{where}: bad magic number 0x{got:08x} "
                         f"(want 0x{magic:08x})")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{where}: truncated: its header says {length} "
                         f"bytes, {len(raw)} are there")
    want = int.from_bytes(raw[-4:], "little")
    crc = native.crc32c(raw[:-4])
    if crc != want:
        raise ValueError(f"{where}: bad crc32c checksum 0x{crc:08x} (stored "
                         f"0x{want:08x})")
    cur = _Cursor(raw[:-4], where)
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        raise ValueError(f"{where}: unknown OCDBT format version {version}")
    compression = cur.varint()
    body = raw[cur.pos:-4]
    if compression == 0:
        return bytes(body)
    if compression != 1:
        raise ValueError(f"{where}: unknown OCDBT compression {compression}")
    size = _frame_size(body, where)
    try:
        out = native.zstd_decompress(body, cap if size is None else size,
                                     exact=size is not None)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    return out.tobytes()


def _data_files(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """An OCDBT data-file table: per file (base path, relative path), the
    base path of the file holding the table prepended."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("data-file path prefix longer than the previous path")
        path = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        if base_len[i] > len(path):
            cur.fail("data-file base path longer than its path")
        prev = path
        files.append((base + path[:base_len[i]].decode(),
                      path[base_len[i]:].decode()))
    return files


def _locations(cur: _Cursor, files, n: int):
    ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
    out = []
    for f, o, k in zip(ids, offsets, lengths):
        if o == _NO_LOCATION and k == _NO_LOCATION:
            out.append(None)
            continue
        if f >= len(files):
            cur.fail(f"data file {f} of a table of {len(files)}")
        out.append((files[f], o, k))
    return out


def _keys(cur: _Cursor, n: int, extra: bool):
    """``n`` prefix-compressed keys (and, for an interior node, each one's
    subtree-common prefix length)."""
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    common = cur.varints(n) if extra else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("key prefix longer than the previous key")
        prev = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        keys.append(prev)
    return keys, common


class _Store:
    """An OCDBT database under ``root``: the newest version's key-value
    pairs, each value inline bytes or a ``(file, offset, length)`` range."""

    def __init__(self, root: str):
        self.root = root
        self._fds: Dict[str, int] = {}  # each data file opened once
        where = os.path.join(root, "manifest.ocdbt")
        if not os.path.exists(where):
            raise ValueError(f"{where}: missing (not an OCDBT database)")
        with open(where, "rb") as f:
            body = _envelope(f.read(), MANIFEST_MAGIC, where,
                             MAX_MANIFEST_BYTES)
        cur = _Cursor(body, where)
        cur.take(16)  # the database's uuid
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind} (numbered manifests are not read)")
        cur.varint()  # max_inline_value_bytes
        self.max_node = cur.varint()
        cur.u8()  # version_tree_arity_log2
        compression = cur.varint()
        if compression == 1:
            cur.take(4)  # zstd level, int32
        elif compression != 0:
            cur.fail(f"unknown compression {compression} in the config")
        files = _data_files(cur, "")
        n = cur.varint()
        if n == 0:
            cur.fail("manifest without a version")
        cur.varints(n)  # generation numbers
        heights = [cur.u8() for _ in range(n)]
        roots = _locations(cur, files, n)
        cur.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
        cur.take(8 * n)  # commit times
        # the older versions' tree nodes: location, generation, count,
        # commit time, height
        m = cur.varint()
        cur.varints(5 * m)
        cur.take(8 * m)
        cur.take(m)
        cur.done()
        self.values: Dict[bytes, Any] = {}
        try:
            if roots[-1] is not None:  # the newest version; None: empty
                self._walk(roots[-1], heights[-1], b"")
        except BaseException:
            self.close()
            raise

    def _fd(self, path: str) -> int:
        fd = self._fds.get(path)
        if fd is None:
            fd = self._fds[path] = os.open(path, os.O_RDONLY)
        return fd

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def read(self, ref) -> memoryview:
        out = np.empty(ref[2], np.uint8)
        self.read_into(ref, out)
        return memoryview(out)

    def read_into(self, ref, out: np.ndarray) -> None:
        (base, rel), offset, length = ref
        path = os.path.join(self.root, base + rel)
        got = os.preadv(self._fd(path), [out.reshape(-1).view(np.uint8)],
                        offset)
        if got != length:
            raise ValueError(f"{path}: truncated: {got} bytes at {offset}, "
                             f"{length} wanted")

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        (base, rel), offset, length = ref
        where = f"{os.path.join(self.root, base + rel)}@{offset}"
        body = _envelope(self.read(ref), NODE_MAGIC, where, self.max_node)
        cur = _Cursor(body, where)
        if cur.u8() != height:
            cur.fail(f"node height other than the {height} its parent says")
        files = _data_files(cur, base)
        n = cur.varint()
        keys, common = _keys(cur, n, height > 0)
        if height > 0:
            children = _locations(cur, files, n)
            cur.varints(3 * n)  # statistics
            cur.done()
            for key, k, child in zip(keys, common, children):
                if child is None or k > len(key):
                    cur.fail("interior entry without a child")
                self._walk(child, height - 1, prefix + key[:k])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i, kind in enumerate(kinds) if kind == 1]
        if any(kind > 1 for kind in kinds):
            cur.fail("unknown value kind")
        ids = cur.varints(len(indirect))
        offsets = cur.varints(len(indirect))
        for i, f, o in zip(indirect, ids, offsets):
            if f >= len(files):
                cur.fail(f"data file {f} of a table of {len(files)}")
            self.values[prefix + keys[i]] = (files[f], o, lengths[i])
        for i, kind in enumerate(kinds):
            if kind == 0:
                self.values[prefix + keys[i]] = bytes(cur.take(lengths[i]))
        cur.done()

    def get(self, key: bytes) -> Optional[Any]:
        return self.values.get(key)

    def bytes_of(self, key: bytes) -> bytes:
        v = self.values[key]
        return v if isinstance(v, bytes) else bytes(self.read(v))


def read_kv(root: str) -> Dict[bytes, bytes]:
    """Every key and value of the OCDBT database under ``root`` (newest
    version), for checks on small stores."""
    store = _Store(root)
    try:
        return {k: store.bytes_of(k) for k in store.values}
    finally:
        store.close()


def _zarray(store: _Store, name: str, where: str) -> dict:
    key = f"{name}/.zarray".encode()
    if store.get(key) is None:
        raise ValueError(f"{where}: no {key.decode()} in the store")
    meta = json.loads(store.bytes_of(key))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: {name} is not a zarr v2 array")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: {name} has order {meta['order']!r}; only "
                         "C order is read")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{where}: {name} has dtype {meta.get('dtype')!r}, "
                         f"not one of {DTYPES}")
    if meta.get("filters"):
        raise ValueError(f"{where}: {name} has filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: {name} has compressor {comp}")
    if meta.get("dimension_separator", ".") not in (".", "/"):
        raise ValueError(f"{where}: {name} has dimension separator "
                         f"{meta['dimension_separator']!r}")
    return meta


def _chunk_into(store: _Store, ref, compressed: bool, out: np.ndarray,
                where: str) -> None:
    """One chunk's value decoded into ``out`` (contiguous, the chunk's
    bytes exactly)."""
    if not compressed:
        if isinstance(ref, bytes):
            if len(ref) != out.nbytes:
                raise ValueError(f"{where}: a chunk of {len(ref)} bytes, "
                                 f"{out.nbytes} expected")
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(ref, np.uint8)
        elif ref[2] != out.nbytes:
            raise ValueError(f"{where}: a chunk of {ref[2]} bytes, "
                             f"{out.nbytes} expected")
        else:
            store.read_into(ref, out)
        return
    if isinstance(ref, bytes):
        data = ref
    else:
        data = np.empty(ref[2], np.uint8)
        store.read_into(ref, data)
    try:
        native.zstd_decompress(data, out.nbytes, out)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None


def _array(store: _Store, name: str, where: str):
    """The zarr array ``name`` as numpy (a torch tensor for bfloat16)."""
    meta = _zarray(store, name, where)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{where}: {name} has chunks {chunks} for shape "
                         f"{shape}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else meta["dtype"])
    compressed = meta.get("compressor") is not None
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    if chunks == shape:  # one chunk: decode in place
        chunk = sep.join(["0"] * len(shape)) or "0"
        ref = store.get(f"{name}/{chunk}".encode())
        if ref is None:
            out.fill(0 if fill is None else fill)
        else:
            _chunk_into(store, ref, compressed, out, f"{where}: {name}")
    else:
        scratch = np.empty(chunks, dtype)
        for idx in np.ndindex(*grid):
            lo = [i * c for i, c in zip(idx, chunks)]
            region = tuple(slice(a, min(a + c, s))
                           for a, c, s in zip(lo, chunks, shape))
            ref = store.get(f"{name}/{sep.join(map(str, idx))}".encode())
            if ref is None:
                out[region] = 0 if fill is None else fill
                continue
            _chunk_into(store, ref, compressed, scratch,
                        f"{where}: {name} chunk {idx}")
            out[region] = scratch[tuple(slice(0, r.stop - r.start)
                                        for r in region)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _check_committed(path: str) -> None:
    if TMP_INFIX in os.path.basename(os.path.normpath(path)):
        raise ValueError(f"{path}: an uncommitted orbax save (a temporary "
                         "directory), not a slot")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no orbax slot directory")
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        raise ValueError(f"{path}: an uncommitted orbax save (no "
                         f"{COMMIT_MARKER}): its write did not finish")


def read(path: str) -> Any:
    """The slot at ``path`` as nested dicts of numpy arrays (torch tensors
    for bfloat16), Python scalars and ``{}`` for empty nodes."""
    _check_committed(path)
    where = os.path.join(path, "_METADATA")
    with open(where) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{where}: use_ocdbt {meta.get('use_ocdbt')}, "
                         f"use_zarr3 {meta.get('use_zarr3')}: only OCDBT "
                         "holding zarr v2 is read")
    store = _Store(path)
    try:
        return _tree(store, meta, where)
    finally:
        store.close()


def _tree(store: _Store, meta: dict, where: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if not keys or any(k.get("key_type") not in (1, 2)
                           for k in entry["key_metadata"]):
            raise ValueError(f"{where}: key path {entry['key_metadata']}")
        kind = entry["value_metadata"]["value_type"]
        if kind in EMPTY_TYPES:
            leaf: Any = {}
        elif kind in ARRAY_TYPES or kind == "scalar":
            leaf = _array(store, ".".join(keys), where)
            if kind == "scalar":
                leaf = leaf.item()
        else:
            raise ValueError(f"{where}: value type {kind!r} of {keys}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"{where}: {keys} passes through a leaf")
        if keys[-1] in node:
            raise ValueError(f"{where}: {keys} appears twice")
        node[keys[-1]] = leaf
    return tree


def leaf_digests(tree: Any, prefix: str = "") -> List[dict]:
    """Each leaf of a tree of ``read``'s form, depth first: its path
    (keys joined by ``/``), dtype, shape and the sha256 of its C-order
    bytes (a bfloat16 tensor's bits; a Python int or float as the int64
    or float64 that orbax stores); an empty node as dtype ``empty``."""
    out = []
    for key, leaf in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(leaf, dict) and leaf:
            out += leaf_digests(leaf, path)
            continue
        if isinstance(leaf, dict):
            out.append({"path": path, "dtype": "empty"})
            continue
        if isinstance(leaf, torch.Tensor):
            name, raw = "bfloat16", leaf.contiguous().view(torch.int16).numpy()
        elif type(leaf) in (int, float):
            name = type(leaf).__name__
            raw = np.asarray(leaf, np.int64 if name == "int" else np.float64)
        else:
            name, raw = leaf.dtype.name, np.ascontiguousarray(leaf)
        out.append({"path": path, "dtype": name, "shape": list(np.shape(leaf)),
                    "sha256": hashlib.sha256(raw.tobytes()).hexdigest()})
    return out


# --------------------------------------------------------------------- #
# The writer
# --------------------------------------------------------------------- #
def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(xs) -> bytes:
    return b"".join(_varint(x) for x in xs)


def _raw_frame(data) -> bytes:
    """A zstd frame of Raw blocks holding ``data``: single segment, the
    content size in 8 bytes, no checksum."""
    data = memoryview(data)
    out = [_ZSTD_MAGIC, b"\xe0", struct.pack("<Q", len(data))]
    block = 128 * 1024
    starts = range(0, len(data), block) if len(data) else [0]
    for s in starts:
        piece = data[s:s + block]
        last = s + block >= len(data)
        out.append(struct.pack("<I", (len(piece) << 3) | int(last))[:3])
        out.append(piece)
    return b"".join(out)


def _seal(magic: int, body: bytes, compress: bool) -> bytes:
    """An OCDBT manifest or node around ``body``."""
    payload = _raw_frame(body) if compress else body
    head = struct.pack(">I", magic)
    tail = _varint(0) + _varint(1 if compress else 0) + payload
    length = len(head) + 8 + len(tail) + 4
    blob = head + struct.pack("<Q", length) + tail
    return blob + struct.pack("<I", native.crc32c(blob))


def _file_table(paths: List[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix, prev = [], b""
    for p in raw:
        k = 0
        while k < min(len(p), len(prev)) and p[k] == prev[k]:
            k += 1
        prefix.append(k)
        prev = p
    return (_varint(len(raw)) + _varints(prefix[1:])
            + _varints(len(p) - k for p, k in zip(raw, prefix))
            + _varints(0 for _ in raw)
            + b"".join(p[k:] for p, k in zip(raw, prefix)))


def _flat(tree: Any, keys: Tuple = (), types: Tuple = ()):
    """(key path, key types, leaf) in order; a dict whose keys are
    ``"0"..."n-1"`` is a sequence, as flax's msgpack writes a tuple."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
        seq = True
    elif isinstance(tree, dict):
        seq = bool(tree) and list(tree) == [str(i) for i in range(len(tree))]
    else:
        yield keys, types, tree
        return
    if not tree:
        yield keys, types, tree
        return
    for k, v in tree.items():
        if not isinstance(k, str):
            raise ValueError(f"orbax writer: key {k!r} is not a string")
        yield from _flat(v, keys + (k,), types + (1 if seq else 2,))


def _leaf_array(leaf, where) -> Tuple[str, np.ndarray]:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype != torch.bfloat16:
            return _leaf_array(leaf.numpy(), where)
        return "bfloat16", leaf.contiguous().view(torch.int16).numpy()
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:  # (ascontiguousarray would make 0-d 1-d)
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return "bfloat16", arr.view(np.uint16)
    name = arr.dtype.str
    if name not in DTYPES:
        raise ValueError(f"orbax writer: {where} has dtype {arr.dtype}")
    return name, arr


def write(path: str, tree: Any, compress: bool = True) -> None:
    """``tree`` (as ``read`` returns it) as an orbax slot directory at
    ``path``, replacing one that is there: written into a temporary
    directory beside it and renamed, the commit marker last."""
    entries: Dict[bytes, Any] = {}
    tree_meta = {}
    for keys, types, leaf in _flat(tree):
        where = "/".join(keys)
        if not keys:
            raise ValueError("orbax writer: the tree is a leaf")
        key_meta = [{"key": k, "key_type": t} for k, t in zip(keys, types)]
        if isinstance(leaf, dict):  # empty: optax's EmptyState in a chain
            value = {"value_type": "None" if types[-1] == 1 else "Dict",
                     "skip_deserialize": True}
        else:
            if type(leaf) in (int, float):
                dtype, arr = ("<i8", np.asarray(leaf, np.int64)) if type(
                    leaf) is int else ("<f8", np.asarray(leaf, np.float64))
                value = {"value_type": "scalar", "skip_deserialize": False}
            elif isinstance(leaf, (np.ndarray, torch.Tensor)):
                dtype, arr = _leaf_array(leaf, where)
                value = {"value_type": "np.ndarray", "skip_deserialize": False,
                         "write_shape": list(arr.shape)}
            else:
                raise ValueError(f"orbax writer: {where} is a "
                                 f"{type(leaf).__name__}")
            name = ".".join(keys)
            zarray = {"chunks": list(arr.shape),
                      "compressor": ({"id": "zstd", "level": 1} if compress
                                     else None),
                      "dimension_separator": ".", "dtype": dtype,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(arr.shape), "zarr_format": 2}
            entries[f"{name}/.zarray".encode()] = json.dumps(
                zarray, separators=(",", ":"), sort_keys=True).encode()
            chunk = ".".join("0" for _ in arr.shape) or "0"
            raw = arr.reshape(-1).view(np.uint8)
            entries[f"{name}/{chunk}".encode()] = (_raw_frame(raw) if compress
                                                   else raw.tobytes())
        tree_meta[str(tuple(keys))] = {"key_metadata": key_meta,
                                       "value_metadata": value}

    keys = sorted(entries)
    digest = hashlib.sha256()
    for k in keys:
        digest.update(k)
        digest.update(hashlib.sha256(entries[k]).digest())
    data_name = f"d/{digest.hexdigest()[:32]}"
    blob = bytearray()
    kinds, refs, inline = [], [], []
    for k in keys:
        v = entries[k]
        if len(v) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            refs.append(len(blob))
            blob += v
        else:
            kinds.append(0)
            inline.append(v)
    prefix, prev = [], b""
    for k in keys:
        n = 0
        while n < min(len(k), len(prev)) and k[n] == prev[n]:
            n += 1
        prefix.append(n)
        prev = k
    body = (b"\x00" + _file_table([data_name] if refs else [])
            + _varint(len(keys)) + _varints(prefix[1:])
            + _varints(len(k) - n for k, n in zip(keys, prefix))
            + b"".join(k[n:] for k, n in zip(keys, prefix))
            + _varints(len(entries[k]) for k in keys) + _varints(kinds)
            + _varints(0 for _ in refs) + _varints(refs) + b"".join(inline))
    node = _seal(NODE_MAGIC, body, compress)
    node_at = len(blob)
    blob += node
    indirect = sum(len(entries[k]) for k, kind in zip(keys, kinds) if kind)
    stamp = time.time_ns()
    manifest = (digest.digest()[:16] + _varint(0)
                + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([4]) + (_varint(1) + struct.pack("<i", 0) if compress
                                else _varint(0))
                + _file_table([data_name])
                + _varint(1) + _varint(1) + b"\x00"  # generation 1, height 0
                + _varint(0) + _varint(node_at) + _varint(len(node))
                + _varint(len(keys)) + _varint(len(node)) + _varint(indirect)
                + struct.pack("<Q", stamp) + _varint(0))

    path = os.path.normpath(path)
    tmp = f"{path}{TMP_INFIX}{stamp}"
    os.makedirs(os.path.join(tmp, "d"))
    with open(os.path.join(tmp, data_name), "wb") as f:
        f.write(blob)
    with open(os.path.join(tmp, "manifest.ocdbt"), "wb") as f:
        f.write(_seal(MANIFEST_MAGIC, manifest, compress))
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": stamp,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
