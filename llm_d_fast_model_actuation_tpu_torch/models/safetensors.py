"""The safetensors file format, read over ``mmap`` and written by hand.

The reference reads checkpoints with the ``safetensors`` package
(``models/hf.py:_iter_shard_tensors``); the port keeps its own reader of
the format, which is small: an 8-byte little-endian header length ``N``,
a JSON header of ``N`` bytes mapping each tensor name to its ``dtype``,
``shape`` and ``data_offsets`` (``[begin, end)`` in the data section,
which starts right after the header), then the raw little-endian bytes.
An optional ``__metadata__`` entry holds strings.

:class:`SafetensorsFile` maps the file copy-on-write and hands out each
tensor as a torch view of the mapped bytes: nothing is copied until the
caller copies it, and a page is read from disk when it is first touched.
``BF16``, ``F16`` and ``F32`` are read; any other dtype is refused by
name. bf16 is read as its bits, never through a numpy extension type.

:func:`write_file` writes the same format one tensor at a time (a caller
holding a model on the card copies one tensor at a time to the host);
:func:`save_file` writes a dict of tensors.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Sequence, Tuple

import torch

#: the dtypes this reader serves: format name -> torch dtype
DTYPES: Dict[str, torch.dtype] = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_NAMES = {v: k for k, v in DTYPES.items()}

#: refuse headers larger than this (the format's own reference limit)
MAX_HEADER_BYTES = 100 << 20


class TensorInfo(NamedTuple):
    """One tensor's header entry; ``begin``/``end`` are offsets in the
    data section."""

    dtype: str
    shape: Tuple[int, ...]
    begin: int
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.begin


def read_header(path: str) -> Tuple[Dict[str, TensorInfo], Dict[str, str], int]:
    """(tensors by name in file order, ``__metadata__``, data section
    start) of one file, checked: every dtype readable, every extent equal
    to its shape's bytes and inside the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise ValueError(f"{path}: header length {n} does not fit the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: the header is not JSON: {e}")
    meta = header.pop("__metadata__", None) or {}
    start = 8 + n
    infos: Dict[str, TensorInfo] = {}
    for name, h in header.items():
        dt = h.get("dtype")
        if dt not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dt!r}; readable: {sorted(DTYPES)}")
        begin, end = (int(x) for x in h["data_offsets"])
        info = TensorInfo(dt, tuple(int(x) for x in h["shape"]), begin, end)
        numel = 1
        for s in info.shape:
            numel *= s
        want = numel * DTYPES[dt].itemsize
        if info.nbytes != want or begin < 0 or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans {begin}..{end}, want {want} bytes inside the file")
        infos[name] = info
    return infos, meta, start


class SafetensorsFile:
    """One safetensors file, mapped copy-on-write: :meth:`get` returns a
    tensor that views the mapped bytes (writable; a write changes this
    process's copy only). A view keeps the mapping alive after the file
    object is gone."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.tensors, self.metadata, self._start = read_header(path)
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if os.path.getsize(path) else None

    def keys(self) -> List[str]:
        return list(self.tensors)

    def get(self, name: str) -> torch.Tensor:
        info = self.tensors[name]
        dtype = DTYPES[info.dtype]
        numel = info.nbytes // dtype.itemsize
        if numel == 0:
            return torch.empty(info.shape, dtype=dtype)
        offset = self._start + info.begin
        if offset % dtype.itemsize:
            # an extent the format allows but a typed view cannot start
            # at: its bytes, copied once
            raw = torch.frombuffer(self._map, dtype=torch.uint8, count=info.nbytes, offset=offset)
            return raw.clone().view(dtype).reshape(info.shape)
        return torch.frombuffer(self._map, dtype=dtype, count=numel, offset=offset).reshape(info.shape)


def _header_bytes(entries: Sequence[Tuple[str, torch.dtype, Sequence[int]]], metadata: Mapping[str, str] = None):
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, dtype, shape in entries:
        if dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {dtype} cannot be written; writable: {sorted(DTYPES)}")
        numel = 1
        for s in shape:
            numel *= int(s)
        nbytes = numel * dtype.itemsize
        header[name] = {"dtype": _NAMES[dtype], "shape": [int(s) for s in shape], "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data section starts 8-byte aligned
    return struct.pack("<Q", len(raw)) + raw, offset


def write_file(
    path: str,
    entries: Sequence[Tuple[str, torch.dtype, Sequence[int]]],
    tensor_of: Callable[[str], torch.Tensor],
    metadata: Mapping[str, str] = None,
) -> int:
    """Write ``entries`` ((name, dtype, shape), in file order) to ``path``,
    asking ``tensor_of(name)`` for each tensor's values only when its turn
    comes, so one tensor at a time passes through the host. Returns the
    bytes written."""
    head, data_bytes = _header_bytes(entries, metadata)
    with open(path, "wb") as f:
        f.write(head)
        for name, dtype, shape in entries:
            t = tensor_of(name)
            if t.dtype != dtype or tuple(t.shape) != tuple(int(s) for s in shape):
                raise ValueError(f"tensor {name!r} is {t.dtype} {tuple(t.shape)}, its header says {dtype} {tuple(shape)}")
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                f.write(host.view(-1).view(torch.uint8).numpy().data)
    return len(head) + data_bytes


def save_file(tensors: Mapping[str, torch.Tensor], path: str, metadata: Mapping[str, str] = None) -> int:
    """Write a dict of tensors to ``path``, in the dict's order."""
    return write_file(path, [(k, t.dtype, tuple(t.shape)) for k, t in tensors.items()], tensors.__getitem__, metadata)
