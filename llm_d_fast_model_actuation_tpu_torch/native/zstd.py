"""Zstandard frames through the system's ``libzstd.so.1``, over ctypes.

The Orbax checkpoint format (``models/ocdbt.py``) compresses its B-tree
nodes, its manifests and every zarr chunk with zstd. Neither the
``zstandard`` module nor tensorstore is needed: the calls here are the
library's one-shot ones, ``ZSTD_compress``/``ZSTD_compressBound`` and
``ZSTD_decompress``/``ZSTD_getFrameContentSize``, checked with
``ZSTD_isError``/``ZSTD_getErrorName``. ctypes releases the GIL for the
length of every foreign call, so frames decode and encode side by side on
a thread pool (:func:`pool`).

Without the library every call raises :class:`ZstdUnavailable`, naming
the file it looked for: a reader never returns zeros in place of a frame
it cannot decode.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

LIBRARY = "libzstd.so.1"
#: ZSTD_CONTENTSIZE_UNKNOWN and ZSTD_CONTENTSIZE_ERROR
_SIZE_UNKNOWN = (1 << 64) - 1
_SIZE_ERROR = (1 << 64) - 2
#: threads that decode or encode frames at once (each call releases the GIL)
WORKERS = min(16, os.cpu_count() or 1)


class ZstdUnavailable(RuntimeError):
    """The system has no ``libzstd.so.1`` this process can load."""


class ZstdError(RuntimeError):
    """A frame could not be decoded or encoded."""


_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def lib() -> ctypes.CDLL:
    """The library, loaded and typed on first use."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                z = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise ZstdUnavailable(f"zstd frames need the system's {LIBRARY}, which this machine lacks: {e}") from e
            size_t, cp = ctypes.c_size_t, ctypes.c_void_p
            z.ZSTD_versionNumber.restype = ctypes.c_uint
            z.ZSTD_isError.argtypes, z.ZSTD_isError.restype = [size_t], ctypes.c_uint
            z.ZSTD_getErrorName.argtypes, z.ZSTD_getErrorName.restype = [size_t], ctypes.c_char_p
            z.ZSTD_getFrameContentSize.argtypes = [cp, size_t]
            z.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            z.ZSTD_decompress.argtypes, z.ZSTD_decompress.restype = [cp, size_t, cp, size_t], size_t
            z.ZSTD_compressBound.argtypes, z.ZSTD_compressBound.restype = [size_t], size_t
            z.ZSTD_compress.argtypes, z.ZSTD_compress.restype = [cp, size_t, cp, size_t, ctypes.c_int], size_t
            _lib = z
    return _lib


def version() -> str:
    """The library's version, ``major.minor.release``."""
    n = lib().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def pool() -> ThreadPoolExecutor:
    """The process's frame workers (``WORKERS`` threads, made once)."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(WORKERS, thread_name_prefix="zstd")
    return _pool


def _address(buf) -> tuple:
    """(address, length) of a bytes-like object or a writable buffer."""
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value, len(buf)
    mv = memoryview(buf).cast("B")
    if mv.readonly:
        b = bytes(mv)
        return ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value, len(b), b
    return ctypes.addressof(ctypes.c_char.from_buffer(mv)), len(mv), mv


def _check(z: ctypes.CDLL, r: int, what: str) -> int:
    if z.ZSTD_isError(r):
        raise ZstdError(f"zstd could not {what}: {z.ZSTD_getErrorName(r).decode()}")
    return r


def content_size(frame: bytes) -> Optional[int]:
    """The decoded size a frame's header declares, or None when it
    declares none (a frame written by a streaming encoder, as
    tensorstore's are); raises when ``frame`` is no frame."""
    z = lib()
    n = z.ZSTD_getFrameContentSize(frame, len(frame))
    if n == _SIZE_ERROR:
        raise ZstdError("not a zstd frame")
    return None if n == _SIZE_UNKNOWN else int(n)


def decompress(frame: bytes, out=None, limit: int = 1 << 30) -> memoryview:
    """Decode one frame (or several concatenated): into ``out`` (a
    writable buffer of exactly the decoded size, such as a pinned
    tensor's ``numpy()`` view) when given, else into new bytes (a frame
    that does not declare its size is decoded into growing buffers, at
    most ``limit`` bytes). Raises when the frame is corrupt, or decodes
    to another size than ``out``'s or than it declares."""
    z = lib()
    declared = content_size(frame)
    if out is not None:
        addr, size, *keep = _address(out)
        if declared is not None and declared != size:
            raise ZstdError(f"the zstd frame decodes to {declared} bytes, its destination holds {size}")
        got = _check(z, z.ZSTD_decompress(addr, size, frame, len(frame)), "decode a frame")
        if got != size:
            raise ZstdError(f"the zstd frame decoded to {got} bytes, its destination holds {size}")
        del keep
        return memoryview(out)
    cap = declared if declared is not None else min(limit, max(1 << 16, 8 * len(frame)))
    while True:
        buf = bytearray(cap)
        addr, size, *keep = _address(buf)
        r = z.ZSTD_decompress(addr, size, frame, len(frame))
        if not z.ZSTD_isError(r):
            if declared is not None and r != declared:
                raise ZstdError(f"the zstd frame decoded to {r} bytes of the {declared} it declares")
            return memoryview(buf)[:r]
        if declared is not None or cap >= limit or b"too small" not in z.ZSTD_getErrorName(r):
            _check(z, r, "decode a frame")
        cap = min(limit, 4 * cap)


def compress(data, level: int = 1) -> memoryview:
    """One frame of ``data`` (any bytes-like object) at ``level``; the
    frame declares its decoded size. The frame is encoded into a buffer
    that is never zero-filled or copied while the GIL is held (a chunk of
    a checkpoint is tens of MB): the result is a view of it."""
    import numpy as np

    z = lib()
    addr, size, *keep = _address(data)
    bound = z.ZSTD_compressBound(size)
    dst = np.empty(bound, dtype=np.uint8)
    n = _check(z, z.ZSTD_compress(dst.ctypes.data, bound, addr, size, level), "encode a frame")
    del keep
    return memoryview(dst)[:n]
