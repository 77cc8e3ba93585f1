"""The machine's NVIDIA cards through NVML, over ctypes: enumeration only.

The counterpart of the JAX package's ``native/tpuinfo.py:enumerate_chips``
for the launcher's real mode. It loads the system's ``libnvidia-ml.so.1``
(``pynvml`` is not needed) and reads each card's index, UUID and name.
NVML creates no CUDA context, so a launcher may call it before it forks
engine children. Its index is the PCI bus order; a child pinned by it
needs ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` beside ``CUDA_VISIBLE_DEVICES``
(``launcher/chiptranslator.py``).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

LIBRARY = "libnvidia-ml.so.1"
#: NVML_DEVICE_UUID_V2_BUFFER_SIZE and NVML_DEVICE_NAME_V2_BUFFER_SIZE
UUID_BUFFER = 96
NAME_BUFFER = 96


class NvmlError(RuntimeError):
    """NVML could not be loaded, or one of its calls failed."""


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
    ):
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
