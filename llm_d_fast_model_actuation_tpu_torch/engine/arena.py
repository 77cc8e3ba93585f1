"""Device memory at stable addresses for the engine's state.

A captured CUDA graph bakes in every pointer it reads, so the state that
the decode chunk's graphs read — the weights, the KV pool, the RoPE
tables, the scheduler buffers and the noise buffer — must come back to
the same device addresses after a sleep. An :class:`Arena` holds that
state for one device: it reserves one range of virtual addresses when the
engine starts and maps physical memory into it per allocation
(``csrc/arena.cu``, the CUDA driver's virtual memory management: the role
vLLM's CuMemAllocator plays for its GPU engine). A tensor in the arena is
a torch view of its mapped range, so its ``data_ptr()`` never changes.
A sleep unmaps and releases an allocation's physical memory and keeps the
range; a wake maps new physical memory at the same addresses.

Each allocation carries a tag:

  * ``offload`` — weights and the KV pool: copied to pinned host memory
    by a level-1 sleep and back into the same tensors at wake;
  * ``discard`` — RoPE tables, scheduler buffers, the noise buffer:
    released without a copy and written anew after the wake;
  * ``variant`` — a co-resident sibling's changed leaves (the engine's
    ``attach_variant``): written once at the attach, and given back one
    by one at its detach (:meth:`Arena.release`), which unmaps the block
    and keeps its addresses for the next allocation of the same size. A
    sleep never holds one (it is refused while a variant is attached).

Allocations are laid out one after another from the start of the range,
each rounded up to the device's granularity, and only ``variant`` blocks
are freed one by one: an arena lives as long as its engine. The range is the card's whole
memory, which the engine's state can never exceed. A view keeps its arena
alive (``torch.as_tensor`` holds its source), and the arena gives its
memory and its range back when the last view is gone.

A hot-swap hands a block's physical memory to a block of the same size in
another arena (:func:`hand_over`): on the card the allocation handle is
unmapped from the one address and mapped at the other, so the incoming
engine finds the outgoing engine's bytes at its own addresses, where its
captured graphs read them, and zero bytes are copied; a rollback hands it
back the same way.

On the CPU an arena has the same interface and keeps ordinary storage: it
only accounts, and an unmapped allocation is overwritten with ``0xff``
bytes (a NaN or -1 in every element), since the card's memory comes back
from a wake with no defined content; a handover copies the bytes. That is the CPU's version, used when
the CPU is asked for, as the kernels' plain versions are. On a CUDA device
an arena that cannot reserve or map raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import torch

TAGS = ("offload", "discard", "variant")

#: the CUDA driver functions ``csrc/arena.cu`` is handed, in its order (the
#: versioned names are the ones ``cuda.h`` maps the plain names to)
CU_SYMBOLS = (
    "cuDeviceGet", "cuDevicePrimaryCtxRetain", "cuDevicePrimaryCtxRelease_v2",
    "cuCtxPushCurrent_v2", "cuCtxPopCurrent_v2", "cuMemGetAllocationGranularity",
    "cuMemAddressReserve", "cuMemAddressFree", "cuMemCreate", "cuMemMap",
    "cuMemSetAccess", "cuMemUnmap", "cuMemRelease",
)

#: the CPU arena's granularity: the card's (2 MiB on an H100)
CPU_GRANULARITY = 2 << 20


def round_up(n: int, granularity: int) -> int:
    return -(-n // granularity) * granularity


@dataclass
class Block:
    """One allocation: ``nbytes`` (a multiple of the granularity) at
    ``offset`` from the range's start, holding one tensor."""

    name: str
    tag: str
    offset: int
    nbytes: int
    #: the tensor's address: the range's base plus ``offset`` on the card
    ptr: int = 0
    mapped: bool = True
    #: the CUDA driver's allocation handle while mapped (card only)
    handle: int = 0


_native = None


def _lib():
    """``csrc/arena.cu``, built and bound on first use and handed the
    CUDA driver's functions."""
    global _native
    if _native is None:
        from ..ops.cuda.build import library

        lib = library("arena")
        cuda = ctypes.CDLL("libcuda.so.1")
        fns = (ctypes.c_void_p * len(CU_SYMBOLS))(
            *(ctypes.cast(getattr(cuda, s), ctypes.c_void_p) for s in CU_SYMBOLS)
        )
        u64, p64 = ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong)
        lib.fma_arena_set_functions.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fma_arena_granularity.argtypes = [ctypes.c_int, p64]
        lib.fma_arena_reserve.argtypes = [ctypes.c_int, u64, u64, p64]
        lib.fma_arena_free.argtypes = [ctypes.c_int, u64, u64]
        lib.fma_arena_map.argtypes = [ctypes.c_int, u64, u64, p64]
        lib.fma_arena_unmap.argtypes = [ctypes.c_int, u64, u64, u64]
        lib.fma_arena_detach.argtypes = [ctypes.c_int, u64, u64]
        lib.fma_arena_attach.argtypes = [ctypes.c_int, u64, u64, u64]
        for name in ("set_functions", "granularity", "reserve", "free", "map", "unmap", "detach", "attach"):
            getattr(lib, f"fma_arena_{name}").restype = ctypes.c_int
        _check(lib.fma_arena_set_functions(fns, len(CU_SYMBOLS)), "hand the arena the CUDA driver's functions")
        _native = lib
    return _native


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"arena: could not {what}: CUDA error {err}")


# An arena's end of life synchronizes the card and unmaps its range, and a
# device-wide synchronize on any thread invalidates a CUDA graph capture in
# progress on another. The last view of an engine's state can go on any
# thread (a stopped service's digest workers, a finished request's
# handler), so captures and arena teardowns exclude each other.
_capture_lock = threading.RLock()
_capture_thread = threading.local()
#: arenas whose last view went inside a capture on the capturing thread
_deferred: List["Arena"] = []


@contextlib.contextmanager
def capture_guard():
    """Held around a CUDA graph capture: an arena whose last view goes
    meanwhile on another thread waits for the capture's end to give its
    memory back, and one whose last view goes on the capturing thread
    gives it back when the capture ends. Captures on several threads run
    one at a time."""
    with _capture_lock:
        _capture_thread.active = True
        try:
            yield
        finally:
            _capture_thread.active = False
            while _deferred:
                _deferred.pop()._give_back()


def excluding_captures():
    """Held around a call that waits on the whole card (a device-wide
    synchronize, ``cudaFree`` under ``empty_cache``): such a call on any
    thread invalidates a CUDA graph capture in progress on another, so it
    takes the captures' lock and waits for a capture to end first."""
    return _capture_lock


def synchronize(device: "torch.device | str | None" = None) -> None:
    """``torch.cuda.synchronize(device)``, never beside a capture
    (:func:`excluding_captures`). Every device-wide synchronize of the
    port goes through here; an arena's teardown takes the same lock."""
    with _capture_lock:
        torch.cuda.synchronize(device)


class _Window:
    """A mapped byte range as ``__cuda_array_interface__``: what
    ``torch.as_tensor`` views without a copy. It holds the arena, so the
    arena outlives every view."""

    def __init__(self, arena: "Arena", ptr: int, nbytes: int) -> None:
        self.arena = arena
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False), "version": 2, "strides": None,
        }


class Arena:
    """The engine's state on one device, at stable addresses. On the card
    the range reserved is the card's memory and the granularity the
    card's; on the CPU nothing is reserved and the granularity is
    :data:`CPU_GRANULARITY`."""

    def __init__(self, device: "torch.device | str") -> None:
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        self.blocks: List[Block] = []
        #: data_ptr -> block
        self._by_ptr: Dict[int, Block] = {}
        #: the CPU arena's storage per block (the card's is the range)
        self._storage: Dict[int, torch.Tensor] = {}
        #: released ``variant`` blocks, whose addresses a later allocation
        #: of the same size takes again
        self._free: List[Block] = []
        #: seconds spent in the CUDA driver's create/map/set-access calls
        self.map_seconds = 0.0
        self._next = 0
        self.base = 0
        if not self.cuda:
            self.device = device
            self.granularity = CPU_GRANULARITY
            self.reserved_va_bytes = 0
            return
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.device = torch.device("cuda", index)
        lib = _lib()
        g = ctypes.c_ulonglong()
        _check(lib.fma_arena_granularity(index, ctypes.byref(g)), f"read the granularity of {self.device}")
        self.granularity = g.value
        total = torch.cuda.get_device_properties(index).total_memory
        self.reserved_va_bytes = round_up(total, self.granularity)
        va = ctypes.c_ulonglong()
        _check(lib.fma_arena_reserve(index, self.reserved_va_bytes, self.granularity, ctypes.byref(va)),
               f"reserve {self.reserved_va_bytes} bytes of addresses on {self.device}")
        self.base = va.value

    @property
    def mapped_bytes(self) -> int:
        return sum(b.nbytes for b in self.blocks if b.mapped)

    def __contains__(self, t: torch.Tensor) -> bool:
        return t.data_ptr() in self._by_ptr

    def block(self, t: torch.Tensor) -> Block:
        """The block ``t`` (a tensor :meth:`empty` returned) lives in."""
        b = self._by_ptr.get(t.data_ptr())
        if b is None:
            raise ValueError(f"the tensor at {t.data_ptr():#x} is not an allocation of this arena")
        return b

    # -- allocation -------------------------------------------------------

    def empty(self, shape: Sequence[int], dtype: torch.dtype, tag: str, name: str = "") -> torch.Tensor:
        """A new tensor in the arena, mapped, of undefined content."""
        if tag not in TAGS:
            raise ValueError(f"unknown arena tag {tag!r}; known: {TAGS}")
        shape = tuple(int(s) for s in shape)
        numel = 1
        for s in shape:
            numel *= s
        if numel == 0:
            raise ValueError("an arena allocation holds at least one element")
        nbytes = round_up(numel * dtype.itemsize, self.granularity)
        reuse = next((b for b in self._free if b.nbytes == nbytes), None) if tag == "variant" else None
        if reuse is not None:
            self._free.remove(reuse)
            block = Block(name, tag, reuse.offset, nbytes)
        else:
            block = Block(name, tag, self._next, nbytes)
            self._next += nbytes
        if self.cuda:
            self._map(block)
            window = _Window(self, self.base + block.offset, nbytes)
            t = torch.as_tensor(window, device=self.device)[: numel * dtype.itemsize].view(dtype).view(shape)
        else:
            t = torch.empty(shape, dtype=dtype)
            self._storage[t.data_ptr()] = t
        block.ptr = t.data_ptr()
        self.blocks.append(block)
        self._by_ptr[block.ptr] = block
        return t

    def zeros(self, shape: Sequence[int], dtype: torch.dtype, tag: str, name: str = "") -> torch.Tensor:
        return self.empty(shape, dtype, tag, name).zero_()

    def release(self, t: torch.Tensor) -> int:
        """Give a ``variant`` block's memory back to the card: unmap it
        and forget it, its addresses kept for the next allocation of its
        size. The caller drops every view of it and makes sure no queued
        work reads it. Returns the block's bytes."""
        b = self.block(t)
        if b.tag != "variant":
            raise ValueError(f"only variant blocks are released one by one, not {b.name or 'a block'} ({b.tag})")
        self.unmap([t])
        self.blocks.remove(b)
        del self._by_ptr[b.ptr]
        self._storage.pop(b.ptr, None)
        self._free.append(b)
        return b.nbytes

    # -- release and map again ----------------------------------------------

    def _select(self, tensors: Optional[Iterable[torch.Tensor]], tag: Optional[str]) -> List[Block]:
        if tensors is not None:
            return [self.block(t) for t in tensors]
        return [b for b in self.blocks if tag is None or b.tag == tag]

    def unmap(self, tensors: Optional[Iterable[torch.Tensor]] = None, tag: Optional[str] = None) -> None:
        """Release the physical memory of ``tensors`` (allocations of this
        arena), or of every block with ``tag``, or of all; their addresses
        stay reserved. The caller makes sure no queued work reads them."""
        for b in self._select(tensors, tag):
            if not b.mapped:
                continue
            if self.cuda:
                _check(_lib().fma_arena_unmap(self.device.index, b.ptr, b.nbytes, b.handle),
                       f"unmap {b.name or 'a block'} on {self.device}")
                b.handle = 0
            else:
                self._storage[b.ptr].view(-1).view(torch.uint8).fill_(0xFF)
            b.mapped = False

    def map(self, tensors: Optional[Iterable[torch.Tensor]] = None, tag: Optional[str] = None) -> None:
        """Map new physical memory under ``tensors``, or every block with
        ``tag``, or all, at their old addresses. Their content is
        undefined until written."""
        for b in self._select(tensors, tag):
            if b.mapped:
                continue
            if self.cuda:
                self._map(b)
            b.mapped = True

    def _map(self, b: Block) -> None:
        h = ctypes.c_ulonglong()
        t0 = time.perf_counter()
        err = _lib().fma_arena_map(self.device.index, self.base + b.offset, b.nbytes, ctypes.byref(h))
        self.map_seconds += time.perf_counter() - t0
        _check(err, f"map {b.nbytes} bytes for {b.name or 'a block'} on {self.device}")
        b.handle = h.value
        b.mapped = True

    # -- end of life --------------------------------------------------------

    def __del__(self) -> None:
        # the last view is gone; nothing can read the range any more
        if not self.cuda or not self.base or sys.is_finalizing():
            return
        if getattr(_capture_thread, "active", False):
            _deferred.append(self)  # this thread is capturing: given back at its end
            return
        with _capture_lock:
            self._give_back()

    def _give_back(self) -> None:
        torch.cuda.synchronize(self.device)
        self.unmap()
        _check(_lib().fma_arena_free(self.device.index, self.base, self.reserved_va_bytes),
               f"free the address range on {self.device}")
        self.base = 0


def hand_over(src_arena: Arena, src: torch.Tensor, dst_arena: Arena, dst: torch.Tensor) -> None:
    """Move the memory under ``src`` (a mapped allocation of ``src_arena``)
    to ``dst`` (an unmapped allocation of ``dst_arena`` of the same size on
    the same device): afterwards ``dst`` holds ``src``'s bytes at its own
    address and ``src`` is unmapped. On the card the physical allocation
    changes hands (unmapped at one address, mapped at the other: no byte
    is copied); on the CPU the bytes are copied. Nothing queued may still
    use either tensor. Raises if a driver call fails, with ``src`` mapped
    as before."""
    sb, db = src_arena.block(src), dst_arena.block(dst)
    if src_arena.device != dst_arena.device or sb.nbytes != db.nbytes:
        raise ValueError(f"cannot hand {sb.name or 'a block'} ({sb.nbytes} bytes on {src_arena.device}) "
                         f"to {db.name or 'a block'} ({db.nbytes} bytes on {dst_arena.device})")
    if not sb.mapped or db.mapped:
        raise ValueError("a handover needs a mapped source and an unmapped destination")
    if src_arena.cuda:
        lib, index = _lib(), src_arena.device.index
        t0 = time.perf_counter()
        err = lib.fma_arena_detach(index, sb.ptr, sb.nbytes)
        if err == 0:
            err = lib.fma_arena_attach(index, db.ptr, db.nbytes, sb.handle)
            if err != 0:  # put it back where it was
                _check(lib.fma_arena_attach(index, sb.ptr, sb.nbytes, sb.handle),
                       f"map {sb.name or 'a block'} back after a failed handover")
        dst_arena.map_seconds += time.perf_counter() - t0
        _check(err, f"hand {sb.name or 'a block'} over on {src_arena.device}")
        db.handle, sb.handle = sb.handle, 0
    else:
        dst_arena._storage[db.ptr].view(-1).view(torch.uint8).copy_(src_arena._storage[sb.ptr].view(-1).view(torch.uint8))
        src_arena._storage[sb.ptr].view(-1).view(torch.uint8).fill_(0xFF)
    db.mapped, sb.mapped = True, False


def arena_of(arenas: Iterable[Arena], t: torch.Tensor) -> Arena:
    """The arena among ``arenas`` that ``t`` was allocated from."""
    for a in arenas:
        if t in a:
            return a
    raise ValueError(f"the tensor at {t.data_ptr():#x} is in none of the engine's arenas")
