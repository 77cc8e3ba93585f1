"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Builds happen at first use,
from the sources in the checkout, into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), or the directory
``FMA_KERNEL_BUILD_DIR`` names (a launcher's ``--compile-cache-dir``,
shared by its children); a library is named by the hash of
its source and flags, so an edited source rebuilds and an unchanged one
is reused. All sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.

:func:`launch_probe` is the port of the JAX package's toolchain probe
(``utils/compat.py:pallas_interpret_supported``): an ``[8, 128]`` float32
copy through ``csrc/probe.cu``, which the engine launches once when it
starts on the card (:func:`check_launch`). It is a check, not a switch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel library name -> source file under csrc/
SOURCES = {
    "decode": "decode.cu",
    "prefill": "prefill.cu",
    "ragged": "ragged.cu",
    "probe": "probe.cu",
    "w8a16": "w8a16.cu",
    # host code only: the engine's stable-address memory (engine/arena.py)
    "arena": "arena.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]


@dataclass
class BuiltLibrary:
    name: str
    path: Path
    #: nvcc's output (ptxas resource usage); empty when the library was
    #: already built
    log: str
    #: seconds this call spent compiling it (0 when reused)
    seconds: float


_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``PATH``; raises when there is none."""
    candidates: List[Optional[str]] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)"
    )


def source_digest(src: Path) -> str:
    """The hash a library built from ``src`` is named by: the source, every
    header in ``csrc/`` (``hopper.cuh`` is shared by two kernels) and the
    nvcc flags, so an edit to any of them rebuilds."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build_dir() -> Path:
    """Where libraries are built and found: ``FMA_KERNEL_BUILD_DIR``, else
    :data:`BUILD_DIR`."""
    return Path(os.environ.get("FMA_KERNEL_BUILD_DIR") or BUILD_DIR)


def _target(name: str) -> Path:
    return build_dir() / f"lib{name}-{source_digest(CSRC / SOURCES[name])}.so"


def build_all() -> Dict[str, BuiltLibrary]:
    """Compile every kernel library that is not built yet, all at once
    (one nvcc process per source); raises with nvcc's output if any
    fails."""
    todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
    out = {
        n: BuiltLibrary(n, _target(n), "", 0.0) for n in SOURCES if n not in todo
    }
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for n, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[n]} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
        out[n] = BuiltLibrary(n, todo[n], log, time.monotonic() - t0)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        built = build_all()
        lib = _loaded[name] = ctypes.CDLL(str(built[name].path))
    return lib


PROBE_SHAPE = (8, 128)


def launch_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's function in plain PyTorch: a copy."""
    return x.clone()


_probe_fn = None


def _probe_kernel():
    """``fma_copy_probe_f32``, built and bound on first use: argument
    types are set once."""
    global _probe_fn
    if _probe_fn is None:
        fn = library("probe").fma_copy_probe_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _probe_fn = fn
    return _probe_fn


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """Copy an ``[8, 128]`` float32 tensor. A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/probe.cu`` or raises.
    ``launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return launch_probe_plain(x)
    if not x.is_cuda:
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape) != PROBE_SHAPE or not x.is_contiguous():
        raise ValueError(f"the probe copies a contiguous {PROBE_SHAPE} float32 tensor")
    fn = _probe_kernel()
    out = torch.empty_like(x)
    # the launch goes to the runtime's current device: switch only if needed
    if x.device.index == torch.cuda.current_device():
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err}")
    count_launch(launch_probe)
    return out


launch_probe.launches = 0


def count_launch(wrapper, by: str = "", key=None) -> None:
    """One launch of ``wrapper``'s kernel: add it to ``wrapper.launches``,
    and to ``wrapper.<by>[key]`` when ``by`` is named. Not while the
    current stream is capturing a CUDA graph: a capture records the launch
    and runs nothing (``engine/graphs.py`` reads what a replay runs from
    the captured graph itself)."""
    if torch.cuda.is_current_stream_capturing():
        return
    wrapper.launches += 1
    if by:
        counts = getattr(wrapper, by)
        counts[key] = counts.get(key, 0) + 1


def check_launch(device: torch.device) -> None:
    """Build this checkout's kernels if needed and launch the probe on
    ``device``; raises unless the copy comes back equal. Nothing routes
    on the result."""
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32, device=device)
    x = x.reshape(PROBE_SHAPE)
    if not torch.equal(launch_probe(x), x):
        raise RuntimeError(f"the probe kernel's copy on {device} came back wrong")
