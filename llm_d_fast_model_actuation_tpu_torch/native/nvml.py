"""The machine's NVIDIA cards through NVML, over ctypes: enumeration,
memory in use and utilization.

The counterpart of the JAX package's ``native/tpuinfo.py``: the
launcher's and the requester's real modes enumerate the cards
(:func:`enumerate_gpus`: index, UUID, name), and the requester answers
the controller's memory query from :func:`memory_info` (used, free and
total bytes per UUID). Its ``used`` is what ``nvidia-smi
--query-gpu=memory.used`` reads, the memory processes allocated: it comes
from ``nvmlDeviceGetMemoryInfo_v2``, whose ``used`` leaves out what the
driver reserves for itself (given as ``reserved``), where the library has
it; the first version's ``used`` counts that reservation too.
A TPU runtime cannot see another process's HBM, so the JAX package adds
a cooperative publisher (``native/hbm_publisher.py``) in which each engine
writes its own use; NVML sees every process's use of a card, so that
publisher has no counterpart here.

It loads the system's ``libnvidia-ml.so.1`` (``pynvml`` is not needed).
NVML creates no CUDA context, so a launcher may call it before it forks
engine children. Its index is the PCI bus order; a child pinned by it
needs ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` beside ``CUDA_VISIBLE_DEVICES``
(``parallel/topology.py``).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence

LIBRARY = "libnvidia-ml.so.1"
#: NVML_DEVICE_UUID_V2_BUFFER_SIZE and NVML_DEVICE_NAME_V2_BUFFER_SIZE
UUID_BUFFER = 96
NAME_BUFFER = 96


class NvmlError(RuntimeError):
    """NVML could not be loaded, or one of its calls failed."""


class Memory(ctypes.Structure):
    """nvmlMemory_t: bytes."""

    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


class MemoryV2(ctypes.Structure):
    """nvmlMemory_v2_t: bytes, with the driver's own reservation apart."""

    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong), ("reserved", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


#: nvmlMemory_v2 = NVML_STRUCT_VERSION(Memory, 2): the size, and the version in the top byte
MEMORY_V2 = ctypes.sizeof(MemoryV2) | 2 << 24


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def load() -> Any:
    """The system's NVML library, its functions' types declared; raises
    NvmlError without it."""
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise NvmlError(f"{LIBRARY} cannot be loaded: {e}") from e
    for name, argtypes in (
        ("nvmlInit_v2", []),
        ("nvmlShutdown", []),
        ("nvmlDeviceGetCount_v2", [ctypes.POINTER(ctypes.c_uint)]),
        ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
        ("nvmlDeviceGetUUID", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
        ("nvmlDeviceGetName", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
        ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
        ("nvmlDeviceGetMemoryInfo", [ctypes.c_void_p, ctypes.POINTER(Memory)]),
        ("nvmlDeviceGetUtilizationRates", [ctypes.c_void_p, ctypes.POINTER(Utilization)]),
        ("nvmlDeviceGetMemoryInfo_v2", [ctypes.c_void_p, ctypes.POINTER(MemoryV2)]),
    ):
        if name == "nvmlDeviceGetMemoryInfo_v2" and not hasattr(lib, name):
            continue  # a library older than the call: memory_info uses the first version
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int  # nvmlReturn_t
    return lib


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise NvmlError(f"{call} returned NVML error {rc}")


def enumerate_gpus(lib: Optional[Any] = None) -> List[Dict[str, Any]]:
    """``[{"index", "uuid", "name"}]`` of every card NVML sees, in its
    (PCI bus) order. ``lib`` is the loaded library, :func:`load`'s by
    default."""
    lib = load() if lib is None else lib
    _check(lib.nvmlInit_v2(), "nvmlInit_v2")
    try:
        count = ctypes.c_uint(0)
        _check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)), "nvmlDeviceGetCount_v2")
        out = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            _check(lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(i), ctypes.byref(handle)),
                   "nvmlDeviceGetHandleByIndex_v2")
            uuid = ctypes.create_string_buffer(UUID_BUFFER)
            _check(lib.nvmlDeviceGetUUID(handle, uuid, ctypes.c_uint(UUID_BUFFER)), "nvmlDeviceGetUUID")
            name = ctypes.create_string_buffer(NAME_BUFFER)
            _check(lib.nvmlDeviceGetName(handle, name, ctypes.c_uint(NAME_BUFFER)), "nvmlDeviceGetName")
            out.append({"index": i, "uuid": uuid.value.decode(), "name": name.value.decode()})
        return out
    finally:
        lib.nvmlShutdown()


def _by_uuid(lib: Any, uuids: Sequence[str], read) -> Dict[str, Any]:
    """``{uuid: read(lib, handle)}`` inside one NVML session."""
    _check(lib.nvmlInit_v2(), "nvmlInit_v2")
    try:
        out = {}
        for uuid in uuids:
            handle = ctypes.c_void_p()
            _check(lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(handle)), "nvmlDeviceGetHandleByUUID")
            out[uuid] = read(lib, handle)
        return out
    finally:
        lib.nvmlShutdown()


def _memory(lib: Any, handle: Any) -> Dict[str, int]:
    if hasattr(lib, "nvmlDeviceGetMemoryInfo_v2"):
        mem = MemoryV2(version=MEMORY_V2)
        _check(lib.nvmlDeviceGetMemoryInfo_v2(handle, ctypes.byref(mem)), "nvmlDeviceGetMemoryInfo_v2")
        return {"used": mem.used, "free": mem.free, "total": mem.total, "reserved": mem.reserved}
    mem = Memory()
    _check(lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem)), "nvmlDeviceGetMemoryInfo")
    return {"used": mem.used, "free": mem.free, "total": mem.total}


def _utilization(lib: Any, handle: Any) -> Dict[str, int]:
    util = Utilization()
    _check(lib.nvmlDeviceGetUtilizationRates(handle, ctypes.byref(util)), "nvmlDeviceGetUtilizationRates")
    return {"gpu": util.gpu, "memory": util.memory}


def memory_info(uuids: Sequence[str], lib: Optional[Any] = None) -> Dict[str, Dict[str, int]]:
    """``{uuid: {"used", "free", "total"[, "reserved"]}}`` in bytes, every
    process's use of each card counted (``reserved``, the driver's own,
    where the library answers the second version); raises NvmlError on an
    unknown UUID."""
    return _by_uuid(load() if lib is None else lib, uuids, _memory)


def utilization(uuids: Sequence[str], lib: Optional[Any] = None) -> Dict[str, Dict[str, int]]:
    """``{uuid: {"gpu", "memory"}}``: the percent of the last sample
    period in which a kernel ran, and in which memory was read or
    written."""
    return _by_uuid(load() if lib is None else lib, uuids, _utilization)
