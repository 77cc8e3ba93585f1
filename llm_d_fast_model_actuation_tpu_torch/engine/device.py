"""Device resolution for the port's entry points, and device release.

The engine and the server run on the card unless the caller asks for the
CPU. There is no quiet fallback: with no card and no explicit
``device="cpu"`` they raise, so a CPU run can never pass for a GPU one.

:func:`release_devices` and :func:`reacquire_devices` carry the
reference's names with the GPU's meaning (below): a sleep with
``release=True`` (``--sleep-release-devices always``) gives back the card
memory a sleeping engine would otherwise keep, and the wake captures its
graphs again.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# -- device release -----------------------------------------------------------
#
# The reference's release (its ``engine/device.py``) destroys the PJRT
# client, because a TPU chip admits one live client. CUDA contexts
# coexist on a card, so on a GPU a release means: the process gives back
# every byte of device memory it can and keeps its context. What goes is
# each engine's captured chunk graphs with their private memory pool, the
# caching allocator's free blocks, and cuBLAS's workspaces (only while no
# engine of the process holds a graph: a captured product holds its
# workspace's address). The arenas' reserved address ranges stay
# reserved: they hold no memory, and the wake maps at the same addresses.


def release_devices(engines: Sequence[Any]) -> Dict[str, Any]:
    """Give back the device memory ``engines`` (asleep: their state
    unmapped) hold beyond their CUDA context. Returns what went:
    ``graphs_released`` (engines whose graphs were dropped),
    ``graph_kernel_nodes``, and ``released_bytes``, the caching
    allocator's reserved bytes given back (the graphs' pool, the free
    blocks and cuBLAS's workspaces are all its segments)."""
    import torch

    from .graphs import release_cached_memory

    released = nodes = 0
    devices = []
    for eng in engines:
        for d in eng.arenas:
            if d.type == "cuda" and d not in devices:
                devices.append(d)
    before = sum(torch.cuda.memory_reserved(d) for d in devices)
    for eng in engines:
        g = eng.graphs
        if g is not None and g.captured:
            nodes += sum(n for p in g.programs.values() for n in p.kernels.values())
            g.release()
            released += 1
    for d in devices:
        release_cached_memory(d)
    after = sum(torch.cuda.memory_reserved(d) for d in devices)
    return {"graphs_released": released, "graph_kernel_nodes": nodes, "released_bytes": before - after}


def reacquire_devices(engines: Sequence[Any]) -> float:
    """After a released sleep's wake (the state mapped back): each
    engine's chunk graphs captured again through the path its start took
    (:meth:`~.engine.InferenceEngine.on_reacquire`). Raises if a capture
    fails: there is no eager fallback. Returns the seconds."""
    t0 = time.monotonic()
    for eng in engines:
        eng.on_reacquire()
    return time.monotonic() - t0
