"""The Orbax checkpoint's storage, read and written without tensorstore:
an OCDBT database (tensorstore's Optionally-Cooperative Distributed
B+Tree) of zarr v2 arrays, every node and chunk a zstd frame.

What the JAX package's ``models/checkpoint.py:save_params`` writes under
``<dir>/params`` (orbax 0.11, ``use_ocdbt`` and not ``use_zarr3``):

  * ``manifest.ocdbt``: the top-level database's manifest. Its one
    version's root is a B-tree node in ``d/<hex>`` whose values lie in
    the per-process database's data files,
    ``ocdbt.process_0/d/<hex>`` (the node's data-file table names them by
    a base path and a relative path);
  * ``ocdbt.process_0/manifest.ocdbt`` and its own nodes: the database
    the process wrote before the top-level one was merged over it;
  * keys ``<param>/.zarray`` (the array's JSON metadata) and
    ``<param>/<i>.<j>...`` (one zstd frame a chunk, C order), the param
    named by its dotted tree path (``layers.wq``).

Every manifest and node file is: a magic (``0c db 3a 2a`` for a
manifest, ``0c db 20 de`` for a node), an 8-byte little-endian length
equal to the node's size, a varint version (0) and a varint compression
format (1: zstd), the body as one zstd frame, and a little-endian
CRC-32C (Castagnoli) of every byte before it. A body is made of varints
and arrays of varints, one array per field (the layout of tensorstore's
``kvstore/ocdbt/format``): keys prefix-compressed against the key before,
data file paths prefix-compressed against the path before, values inline
or indirect (a file of the table, an offset, a length).

:class:`Database` reads such a directory: the manifest, the latest
version's B-tree (leaf and interior nodes, an interior entry's common
prefix carried down), each value inline or read from its data file.
:class:`ZarrArray` reads one array over it: the chunk grid, the fill
value, little-endian C order, ``bfloat16`` (``<V2`` too) through the
uint16 view ``models/convert.py`` uses. A CRC, a length or a magic that
does not check, or a frame that does not decode, raises; nothing is
filled in silently.

:class:`Writer` writes the same two-database layout: every value of a
process's arrays in its data files under ``ocdbt.process_0/d/``, a leaf
node and a manifest for that database, and a top-level leaf node and
manifest that point into it, so the JAX package's ``load_params``
(tensorstore) restores it bit for bit.
"""

from __future__ import annotations

import json
import math
import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
#: the per-process database orbax writes under a checkpoint's params
PROCESS_DIR = "ocdbt.process_0"
#: the config orbax's databases carry
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
#: compression format 1: zstd
ZSTD = 1
#: zarr v2 chunks: zstd at this level, as orbax writes them
CHUNK_LEVEL = 1


class FormatError(ValueError):
    """A file of the database or an array does not read as the format
    says: a magic, a length, a CRC-32C, a frame or a field is wrong."""


# -- CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) -------------------


def _crc_tables() -> List[List[int]]:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF] for i in range(256)])
    return tables


_CRC = _crc_tables()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data`` (slicing by eight, in Python: the files it
    checks are manifests and B-tree nodes, kilobytes)."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC
    crc ^= 0xFFFFFFFF
    n8 = len(data) // 8 * 8
    for (a,) in struct.iter_unpack("<Q", data[:n8]):
        x = crc ^ (a & 0xFFFFFFFF)
        hi = a >> 32
        crc = (t7[x & 0xFF] ^ t6[(x >> 8) & 0xFF] ^ t5[(x >> 16) & 0xFF] ^ t4[x >> 24]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF] ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
    for b in data[n8:]:
        crc = (crc >> 8) ^ t0[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


# -- encoding ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, what: str) -> None:
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise FormatError(f"{self.what}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated ({n} bytes wanted at {self.pos} of {len(self.data)})")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise FormatError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(ns: Sequence[int]) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or node ``blob``, its magic, length
    and CRC-32C checked."""
    if len(blob) < 18:
        raise FormatError(f"{what}: {len(blob)} bytes is too short for a header and a checksum")
    got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise FormatError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(blob):
        raise FormatError(f"{what}: its header says {length} bytes, it has {len(blob)}")
    want = struct.unpack("<I", blob[-4:])[0]
    got = crc32c(blob[:-4])
    if got != want:
        raise FormatError(f"{what}: CRC-32C {got:#010x} does not match the stored {want:#010x}")
    r = _Reader(blob[12:-4], what)
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise FormatError(f"{what}: format version {version} (this reader knows 0)")
    body = r.data[r.pos :]
    if compression == ZSTD:
        return bytes(zstd.decompress(body))
    if compression == 0:
        return body
    raise FormatError(f"{what}: compression format {compression} (0: none, 1: zstd)")


def _frame(body: bytes, magic: int) -> bytes:
    payload = b"\x00" + _varint(ZSTD) + bytes(zstd.compress(body, 0))
    blob = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4) + payload
    return blob + struct.pack("<I", crc32c(blob))


def _read_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths: List[str] = []
    prev = b""
    for i in range(n):
        full = prev[: prefix[i]] + r.raw(suffix[i])
        if base[i] > len(full):
            raise FormatError(f"{r.what}: data file base path longer than its path")
        paths.append(full.decode())
        prev = full
    return paths


def _file_table(paths: Sequence[Tuple[str, str]]) -> bytes:
    """(base path, relative path) pairs, as a data file table."""
    full = [(b + p).encode() for b, p in paths]
    prefix = [_common(full[i - 1], full[i]) for i in range(1, len(full))]
    pre = [0] + prefix
    return (_varint(len(full)) + _varints(prefix) + _varints([len(f) - k for f, k in zip(full, pre)])
            + _varints([len(b.encode()) for b, _ in paths]) + b"".join(f[k:] for f, k in zip(full, pre)))


# -- reading ------------------------------------------------------------------


@dataclass(frozen=True)
class Value:
    """A value of the database: ``inline`` bytes, or ``length`` bytes at
    ``offset`` in the data file ``path`` (relative to the database)."""

    inline: Optional[bytes] = None
    path: str = ""
    offset: int = 0
    length: int = 0

    @property
    def nbytes(self) -> int:
        return len(self.inline) if self.inline is not None else self.length


def _pread(path: str, offset: int, length: int, what: str) -> bytes:
    fd = os.open(path, os.O_RDONLY)
    try:
        out = os.pread(fd, length, offset)
    finally:
        os.close(fd)
    if len(out) != length:
        raise FormatError(f"{what}: {path} holds {len(out)} of the {length} bytes at {offset}")
    return out


class Database:
    """An OCDBT database's latest version, read whole into a key map (the
    values stay on disk; :meth:`read` fetches one)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, MANIFEST_FILE)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise FileNotFoundError(f"no OCDBT manifest at {path}") from e
        r = _Reader(_unframe(blob, MANIFEST_MAGIC, path), path)
        r.raw(16)  # the database's uuid
        kind = r.varint()
        if kind != 0:
            raise FormatError(f"{path}: manifest kind {kind}; this reader knows the single-file manifest (0)")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity, log2
        if r.varint() == ZSTD:
            r.u32()  # zstd level, int32
        files = _read_file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        for _ in range(n):
            r.u64()  # commit time, ns
        if r.varint():
            raise FormatError(f"{path}: versions in version tree nodes; this reader knows inline versions only")
        r.end()
        self.entries: Dict[str, Value] = {}
        if not n:
            return
        i = max(range(n), key=lambda k: generation[k])
        if num_keys[i]:
            self._walk(files[file_id[i]], offset[i], length[i], height[i], b"")
        if len(self.entries) != num_keys[i]:
            raise FormatError(f"{path}: the tree holds {len(self.entries)} keys, its manifest says {num_keys[i]}")

    def _node(self, rel: str, offset: int, length: int) -> Tuple[_Reader, int, List[str]]:
        path = os.path.join(self.root, rel)
        what = f"{path}@{offset}"
        r = _Reader(_unframe(_pread(path, offset, length, what), NODE_MAGIC, what), what)
        height = r.byte()
        return r, height, _read_file_table(r)

    def _keys(self, r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if interior else []
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            prev = prev[: prefix[i]] + r.raw(suffix[i])
            keys.append(prev)
        return keys, common

    def _walk(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        r, got_height, files = self._node(rel, offset, length)
        if got_height != height:
            raise FormatError(f"{r.what}: node of height {got_height} where its parent says {height}")
        n = r.varint()
        if height == 0:
            keys, _ = self._keys(r, n, False)
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise FormatError(f"{r.what}: value kind {max(kinds)} (0: inline, 1: indirect)")
            ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
            where = dict(zip(indirect, zip(ids, offs)))
            for i, key in enumerate(keys):
                if i in where:
                    fid, off = where[i]
                    if fid >= len(files):
                        raise FormatError(f"{r.what}: data file {fid} of a table of {len(files)}")
                    self.entries[(prefix + key).decode()] = Value(path=files[fid], offset=off, length=lengths[i])
            for i, key in enumerate(keys):
                if i not in where:
                    self.entries[(prefix + key).decode()] = Value(inline=r.raw(lengths[i]))
            r.end()
            return
        keys, common = self._keys(r, n, True)
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n)  # keys under each child
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        r.end()
        for i, key in enumerate(keys):
            self._walk(files[ids[i]], offs[i], lens[i], height - 1, prefix + key[: common[i]])

    def read(self, key: str) -> bytes:
        v = self.entries.get(key)
        if v is None:
            raise KeyError(f"{self.root} holds no key {key!r}")
        if v.inline is not None:
            return v.inline
        return _pread(os.path.join(self.root, v.path), v.offset, v.length, f"{self.root}:{key}")


#: zarr v2 dtype strings -> torch dtypes (bf16 as tensorstore names it,
#: and as an opaque two-byte ``<V2``)
ZARR_DTYPES = {
    "bfloat16": torch.bfloat16, "<V2": torch.bfloat16, "<f2": torch.float16, "<f4": torch.float32,
    "<f8": torch.float64, "|i1": torch.int8, "|u1": torch.uint8, "<i2": torch.int16, "<i4": torch.int32,
    "<i8": torch.int64, "|b1": torch.bool,
}
ZARR_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "<f2", torch.float32: "<f4", torch.float64: "<f8",
              torch.int8: "|i1", torch.uint8: "|u1", torch.int16: "<i2", torch.int32: "<i4", torch.int64: "<i8",
              torch.bool: "|b1"}


class ZarrArray:
    """One zarr v2 array of a :class:`Database`: ``name/.zarray`` and its
    chunks ``name/<i>.<j>...``."""

    def __init__(self, db: Database, name: str) -> None:
        self.db, self.name = db, name
        meta = json.loads(db.read(f"{name}/.zarray"))
        what = f"{db.root}:{name}"
        if meta.get("zarr_format") != 2:
            raise FormatError(f"{what}: zarr_format {meta.get('zarr_format')} (this reader knows 2)")
        dt = meta.get("dtype")
        if dt not in ZARR_DTYPES:
            raise FormatError(f"{what}: dtype {dt!r}; this reader knows {sorted(ZARR_DTYPES)}")
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise FormatError(f"{what}: order {meta.get('order')!r}, filters {meta.get('filters')}; C order and no filters")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise FormatError(f"{what}: compressor {comp.get('id')!r}; zstd or none")
        self.compressed = comp is not None
        self.dtype = ZARR_DTYPES[dt]
        self.shape = tuple(int(d) for d in meta["shape"])
        self.chunks = tuple(int(d) for d in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks):
            raise FormatError(f"{what}: chunks {self.chunks} for shape {self.shape}")
        self.separator = meta.get("dimension_separator", ".")
        self.fill_value = meta.get("fill_value")
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()

    @property
    def chunk_nbytes(self) -> int:
        return math.prod(self.chunks) * self.itemsize

    def grid(self) -> Iterator[Tuple[int, ...]]:
        """Every chunk's index, in C order."""
        counts = [-(-s // c) for s, c in zip(self.shape, self.chunks)]
        for flat in range(math.prod(counts)):
            idx = []
            for n in reversed(counts):
                idx.append(flat % n)
                flat //= n
            yield tuple(reversed(idx))

    def region(self, idx: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The part of the array chunk ``idx`` covers (clipped at the
        array's edge; the chunk itself is stored whole)."""
        return tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, self.chunks, self.shape))

    def key(self, idx: Tuple[int, ...]) -> str:
        return f"{self.name}/" + (self.separator.join(str(i) for i in idx) if idx else "0")

    def read_chunk(self, idx: Tuple[int, ...], out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chunk ``idx`` whole (``self.chunks`` shape), decoded into
        ``out`` (a contiguous host tensor of the chunk's bytes) when
        given; a chunk the database lacks is the fill value."""
        if out is None:
            out = torch.empty(self.chunks, dtype=self.dtype)
        view = out.view(-1).view(torch.uint8)
        if view.numel() != self.chunk_nbytes:
            raise ValueError(f"{self.name}: a chunk is {self.chunk_nbytes} bytes, its buffer {view.numel()}")
        key = self.key(idx)
        if key not in self.db.entries:
            self._fill(out)
            return out.view(self.chunks)
        blob = self.db.read(key)
        if self.compressed:
            try:
                zstd.decompress(blob, view.numpy())
            except zstd.ZstdError as e:
                raise FormatError(f"{self.db.root}:{key}: {e}") from e
        else:
            if len(blob) != view.numel():
                raise FormatError(f"{self.db.root}:{key}: {len(blob)} bytes for a {view.numel()}-byte chunk")
            view.numpy()[:] = np.frombuffer(blob, np.uint8)
        return out.view(self.chunks)

    def _fill(self, out: torch.Tensor) -> None:
        # null: zeros, as tensorstore reads it; a float may be spelled "NaN"
        v = self.fill_value
        out.fill_(0 if v is None else float(v) if isinstance(v, str) else v)

    def read(self) -> torch.Tensor:
        """The whole array on the host, its chunks decoded on the zstd
        pool."""
        out = torch.empty(self.shape, dtype=self.dtype)
        chunks = list(self.grid())

        def one(idx):
            region = self.region(idx)
            got = self.read_chunk(idx)
            out[region] = got[tuple(slice(0, r.stop - r.start) for r in region)]

        for f in [zstd.pool().submit(one, idx) for idx in chunks]:
            f.result()
        return out


# -- writing ------------------------------------------------------------------


def zarray(shape: Sequence[int], chunks: Sequence[int], dtype: torch.dtype) -> bytes:
    """The ``.zarray`` JSON tensorstore writes for such an array."""
    return json.dumps({
        "chunks": list(chunks), "compressor": {"id": "zstd", "level": CHUNK_LEVEL}, "dimension_separator": ".",
        "dtype": ZARR_NAMES[dtype], "fill_value": None, "filters": None, "order": "C", "shape": list(shape),
        "zarr_format": 2,
    }, separators=(",", ":"), sort_keys=True).encode()


def _hex_name() -> str:
    return uuid.uuid4().hex


def _leaf_node(entries: Dict[str, Value], files: List[Tuple[str, str]]) -> bytes:
    """A leaf node body over ``entries`` (sorted by key), their indirect
    values in ``files`` (index = data file id, via ``Value.path``)."""
    ids = {b + p: i for i, (b, p) in enumerate(files)}
    keys = sorted(entries)
    raw = [k.encode() for k in keys]
    prefix = [_common(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    pre = [0] + prefix
    vals = [entries[k] for k in keys]
    ind = [v for v in vals if v.inline is None]
    return (b"\x00" + _file_table(files) + _varint(len(keys)) + _varints(prefix)
            + _varints([len(k) - p for k, p in zip(raw, pre)]) + b"".join(k[p:] for k, p in zip(raw, pre))
            + _varints([v.nbytes for v in vals]) + _varints([0 if v.inline is not None else 1 for v in vals])
            + _varints([ids[v.path] for v in ind]) + _varints([v.offset for v in ind])
            + b"".join(v.inline for v in vals if v.inline is not None))


def _manifest(node_path: str, node_len: int, num_keys: int, indirect: int) -> bytes:
    body = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(ZSTD) + struct.pack("<i", 0)
            + _file_table([("", node_path)]) + _varint(1) + _varint(1) + b"\x00" + _varint(0) + _varint(0)
            + _varint(node_len) + _varint(num_keys) + _varint(node_len) + _varint(indirect)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    return _frame(body, MANIFEST_MAGIC)


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


class Writer:
    """Writes a new two-database OCDBT directory at ``root``: each array's
    chunks appended to a data file of its own under
    ``ocdbt.process_0/d/``; :meth:`close` writes the leaf nodes and the
    manifests. Small values (``.zarray``, small chunks) stay inline in
    the nodes, as tensorstore keeps them."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        if os.path.exists(os.path.join(self.root, MANIFEST_FILE)):
            raise FileExistsError(f"{self.root} already holds an OCDBT database")
        os.makedirs(os.path.join(self.root, PROCESS_DIR, "d"), exist_ok=True)
        self.entries: Dict[str, Value] = {}
        self.files: List[str] = []

    def put(self, key: str, value: bytes) -> None:
        """``key`` -> ``value``, inline (it must be small)."""
        if len(value) > MAX_INLINE_VALUE_BYTES:
            raise ValueError(f"{key}: {len(value)} bytes is too large to keep inline")
        self.entries[key] = Value(inline=bytes(value))

    def data_file(self) -> "DataFile":
        """A new data file for large values, appended in order."""
        rel = f"d/{_hex_name()}"
        self.files.append(rel)
        return DataFile(self, rel)

    def close(self) -> None:
        indirect = sum(v.length for v in self.entries.values() if v.inline is None)
        used = sorted({v.path for v in self.entries.values() if v.inline is None})
        # the process's own database: values in its data files
        node = _frame(_leaf_node(self.entries, [("", p) for p in used]), NODE_MAGIC)
        node_rel = f"d/{_hex_name()}"
        _write(os.path.join(self.root, PROCESS_DIR, node_rel), node)
        _write(os.path.join(self.root, PROCESS_DIR, MANIFEST_FILE),
               _manifest(node_rel, len(node), len(self.entries), indirect))
        # the top-level database: the same keys, pointing into the process's files
        top = {k: (v if v.inline is not None else Value(path=f"{PROCESS_DIR}/{v.path}", offset=v.offset,
                                                        length=v.length)) for k, v in self.entries.items()}
        node = _frame(_leaf_node(top, [(f"{PROCESS_DIR}/", p) for p in used]), NODE_MAGIC)
        node_rel = f"d/{_hex_name()}"
        _write(os.path.join(self.root, node_rel), node)
        _write(os.path.join(self.root, MANIFEST_FILE), _manifest(node_rel, len(node), len(top), indirect))


class DataFile:
    """A data file of a :class:`Writer`'s process database."""

    def __init__(self, writer: Writer, rel: str) -> None:
        self.writer, self.rel = writer, rel
        self.f = open(os.path.join(writer.root, PROCESS_DIR, rel), "wb")
        self.offset = 0

    def append(self, key: str, value: bytes) -> None:
        """``key`` -> ``value``, inline when small, else at the file's end."""
        if len(value) <= MAX_INLINE_VALUE_BYTES:
            self.writer.put(key, value)
            return
        self.f.write(value)
        self.writer.entries[key] = Value(path=self.rel, offset=self.offset, length=len(value))
        self.offset += len(value)

    def close(self) -> None:
        self.f.close()


def chunk_shape(shape: Sequence[int], itemsize: int, max_bytes: int) -> Tuple[int, ...]:
    """A chunk of ``shape`` cut along its first dimension to at most
    ``max_bytes`` (at least one row)."""
    if not shape:
        return ()
    row = math.prod(shape[1:]) * itemsize
    return (max(1, min(shape[0], max_bytes // max(1, row))),) + tuple(shape[1:])
