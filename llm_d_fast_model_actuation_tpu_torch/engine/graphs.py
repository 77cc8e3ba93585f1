"""The decode chunk as captured CUDA graphs.

Port of the reference's chunk programs (``ProgramSet.chunk`` and
``_make_chunk``, ``llm_d_fast_model_actuation_tpu/engine/engine.py``):
there the chunk is one compiled program per chunk length, and the serving
path runs no eager op. Here an engine on one CUDA device captures
:meth:`InferenceEngine.chunk_body <..engine.InferenceEngine.chunk_body>`
once per key when it starts, before it serves, and every chunk after
that replays one graph: ``32 layers x T steps`` of launches become one.

Keys: ``T`` in {``decode_chunk``, 1}, the reference's two lengths (a
batch's drain tail runs single steps), times whether any slot samples (the
noise buffer is read or not), so at most four graphs. They share one
memory pool: a graph's outputs are read back (the chunk's one host sync)
before the next replay, which is what makes the sharing safe.

Before each capture the body runs once eagerly, with every slot inactive
(budget 0 when the engine starts): it writes only the null page 0, adds 0
to the token counts, and counts its launches and decode steps like any
run. It runs on the current stream, not on a side stream of its own:
cuBLAS keeps a workspace for every (handle, stream) it has run on, for the
life of the process, and a capture holds the address of its own, so they
may be freed only while no engine of the process holds captured graphs
(:func:`release_cached_memory`). That is done before the first warm-up,
so the workspaces the engine goes on using get segments of their own
instead of pinning a large cached one; after the last capture the cache
is emptied again, so the engine's start leaves nothing else cached.

A capture runs nothing, so the kernel wrappers count no launch while the
stream captures (``ops/cuda/build.py:count_launch``); they count eager
launches only. What a replay runs is read from the captured graph itself:
its kernel nodes, counted by kernel name through the CUDA driver
(:func:`kernel_nodes`), times the program's replays
(:meth:`ChunkGraphs.replayed_launches`).

Everything a graph reads or writes is the engine's static state in its
arenas (``engine/arena.py``): a sleep releases it, a wake maps it back at
the same addresses, and the graphs replay unchanged. A new engine
captures them once its weights are written
(``engine/exec_pool.py:warm_up``), while other threads of the process
may still work on the card: the digest job hashing the weights just
loaded (``engine/chunk_store.py:DigestJob``), a prefetch staging the next
model. So each capture is ``thread_local`` (what another thread does
meanwhile, such as pinned allocations and waits on its own events,
neither breaks nor joins it), on a stream no other thread is handed
(:func:`capture_stream`).

A pooled engine's graphs may be released (:meth:`ChunkGraphs.release`,
the exec pool's budget) and are captured again when the engine serves
again. A capture that fails raises; nothing falls back to the eager
chunk. On a tensor-parallel mesh the chunk stays eager: a graph belongs
to one device, and ranks on two cards have never run.
"""

from __future__ import annotations

import ctypes
import gc
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from .arena import capture_guard, excluding_captures

#: engines that hold captured graphs, for :func:`graphs_alive`
_holders: "weakref.WeakSet[ChunkGraphs]" = weakref.WeakSet()


@dataclass
class Program:
    """One captured chunk: the graph (anything with ``replay()``), its
    ``T`` decode steps, its kernel nodes by kernel name (read from the
    captured graph), its static outputs, which every replay overwrites,
    and the replays it ran."""

    graph: Any
    steps: int
    kernels: Dict[str, int]
    outputs: Tuple = ()
    replays: int = 0


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""

    _fields_ = [
        ("func", ctypes.c_void_p),
        *((n, ctypes.c_uint) for n in ("grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "smem")),
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
    ]


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_driver = None


def _cuda_driver():
    """The CUDA driver's graph-inspection functions, bound on first use."""
    global _driver
    if _driver is None:
        cu = ctypes.CDLL("libcuda.so.1")
        vp, p = ctypes.c_void_p, ctypes.POINTER
        cu.cuGraphGetNodes.argtypes = [vp, p(vp), p(ctypes.c_size_t)]
        cu.cuGraphNodeGetType.argtypes = [vp, p(ctypes.c_int)]
        cu.cuGraphKernelNodeGetParams_v2.argtypes = [vp, p(_KernelNodeParams)]
        cu.cuFuncGetName.argtypes = [p(ctypes.c_char_p), vp]
        cu.cuKernelGetName.argtypes = [p(ctypes.c_char_p), vp]
        _driver = cu
    return _driver


def _cu_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"could not {what} of a captured chunk graph: CUresult {err}")


def kernel_nodes(raw_graph: int) -> Dict[str, int]:
    """The kernel nodes of a captured graph (a ``cudaGraph_t``), counted
    by kernel name as the CUDA driver reports it (mangled): what every
    replay of it launches."""
    cu = _cuda_driver()
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)), "count the nodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)), "list the nodes")
    counts: Dict[str, int] = {}
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    for node in nodes:
        _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "read a node's type")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        _cu_check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)), "read a kernel node")
        if params.func:
            _cu_check(cu.cuFuncGetName(ctypes.byref(name), params.func), "name a kernel node's function")
        else:
            _cu_check(cu.cuKernelGetName(ctypes.byref(name), params.kern), "name a kernel node's kernel")
        key = name.value.decode()
        counts[key] = counts.get(key, 0) + 1
    return counts


#: the stream each device's captures run on (:func:`capture_stream`)
_capture_streams: Dict[torch.device, Any] = {}


def capture_stream(device: torch.device):
    """The stream every capture on ``device`` runs on: one of PyTorch's
    high-priority streams, drawn once and kept. ``torch.cuda.Stream()``
    hands out the pool's low-priority streams round robin (the digest
    job's threads and the loader each draw one), and a capture on a stream
    another thread also enqueues on would take in that thread's copies and
    waits, and fail; nothing else in the port draws a high-priority
    stream."""
    device = torch.device(device)
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device, priority=-1)
    return stream


def graphs_alive() -> bool:
    """Whether any engine of this process holds captured graphs."""
    return len(_holders) > 0


def release_cached_memory(device: torch.device) -> None:
    """Give the caching allocator's free blocks on ``device`` back to the
    card, and cuBLAS's workspaces too while no engine of the process holds
    captured graphs: a workspace is a live allocation that pins its
    segment, and a captured product holds its address (cuBLAS makes a new
    one at its next product)."""
    with torch.cuda.device(device), excluding_captures():
        torch.cuda.synchronize()
        if not graphs_alive():
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


#: glibc's ``mallopt`` parameter M_TOP_PAD, and the pad the port sets
_M_TOP_PAD = -2
MALLOC_TOP_PAD_BYTES = 64 << 20
_malloc_padded = False


def pad_malloc_heaps() -> None:
    """Have the C library grow, and keep, each thread's malloc heap
    ``MALLOC_TOP_PAD_BYTES`` at a time (glibc's ``mallopt(M_TOP_PAD)``;
    once per process, and nothing where the C library has no
    ``mallopt``). A capture makes the CUDA driver allocate and free many
    small objects on the capturing thread. With glibc's default pad, a
    thread other than the main one (the service's engine thread, which
    runs a swap's build and a re-capture) grows and shrinks its own heap
    in small steps, and its first captures took 5-6 s against 1.2-1.7 s
    on the main thread, on an H100's host (``capture_overlap.py``)."""
    global _malloc_padded
    if _malloc_padded:
        return
    _malloc_padded = True
    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        mallopt(_M_TOP_PAD, MALLOC_TOP_PAD_BYTES)


class ChunkGraphs:
    """The captured chunk programs of one engine on one CUDA device."""

    def __init__(self, engine) -> None:
        pad_malloc_heaps()
        self.engine = engine
        self.programs: Dict[Tuple[int, bool], Program] = {}
        #: the memory pool the captures share (``torch.cuda.graph_pool_handle``)
        self.pool = None
        #: kernel nodes times replays of graphs released since
        self.released_launches: Dict[str, int] = {}

    def keys(self) -> List[Tuple[int, bool]]:
        lengths = sorted({self.engine.cfg.decode_chunk, 1}, reverse=True)
        return [(T, sampled) for T in lengths for sampled in (False, True)]

    def capture(self) -> float:
        """Capture every key's graph; returns the seconds it took, warm-up
        runs included. The warm-ups and captures run on the engine's
        :meth:`~.engine.InferenceEngine.blank_scheduler` (every slot
        inactive: they write only the null page), so an engine may capture
        with requests mid-stream.
        The card's cached blocks are given back before the first capture,
        so the workspaces the engine goes on using get segments of their
        own (module docstring), and again after the last. A capture that
        fails leaves none captured."""
        t0 = time.monotonic()
        release_cached_memory(self.engine.device)
        try:
            with self.engine.blank_scheduler():
                for key in self.keys():
                    self.programs[key] = self._capture(*key)
        except BaseException:
            self.release()
            raise
        finally:
            if self.programs:
                _holders.add(self)
            release_cached_memory(self.engine.device)  # keeps the workspaces: the graphs hold them now
        return time.monotonic() - t0

    def _capture(self, T: int, sampled: bool) -> Program:
        eng = self.engine
        with torch.cuda.device(eng.device), torch.no_grad():
            eng.chunk_eager(T, sampled)  # the warm-up
            # the graph kept after instantiation, so its nodes can be read
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # an arena's teardown synchronizes the card, which would
            # invalidate the capture: none runs beside it (capture_guard),
            # and no collection runs inside it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with capture_guard(), torch.cuda.graph(graph, pool=self.pool, stream=capture_stream(eng.device),
                                                       capture_error_mode="thread_local"):
                    outputs = eng.chunk_body(T, sampled)
            finally:
                if collecting:
                    gc.enable()
            graph.instantiate()
        eng.graph_captures += 1
        return Program(graph, T, kernel_nodes(graph.raw_cuda_graph()), outputs)

    @property
    def captured(self) -> bool:
        return bool(self.programs)

    def pool_bytes(self) -> int:
        """Card bytes of the caching allocator's segments in the graphs'
        memory pool (0 with nothing captured)."""
        if self.pool is None or not self.programs:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))

    def release(self) -> None:
        """Drop the captured graphs, their outputs and their memory pool
        (a pooled engine over the exec pool's budget); the kernel nodes
        their replays ran stay counted. :meth:`capture` makes them again."""
        if not self.programs:
            return
        for p in self.programs.values():
            for name, n in p.kernels.items():
                self.released_launches[name] = self.released_launches.get(name, 0) + n * p.replays
        self.programs.clear()
        self.pool = None
        _holders.discard(self)
        gc.collect()
        if self.engine.device.type == "cuda":
            release_cached_memory(self.engine.device)

    def replay(self, T: int, sampled: bool) -> tuple:
        """Replay the chunk of ``T`` steps; returns its static outputs. It
        counts ``T`` decode steps and one replay, as the eager chunk counts
        its steps."""
        program = self.programs.get((T, sampled))
        if program is None:
            raise RuntimeError(f"no chunk graph was captured for T={T}, sampled={sampled}")
        with torch.cuda.device(self.engine.device):  # on its device's current stream
            program.graph.replay()
        program.replays += 1
        self.engine.decode_steps += T
        self.engine.graph_replays += 1
        return program.outputs

    def replayed_launches(self) -> Dict[str, int]:
        """The kernel launches the replays ran, by kernel name: each
        program's kernel nodes times its replays."""
        out: Dict[str, int] = dict(self.released_launches)
        for p in self.programs.values():
            for name, n in p.kernels.items():
                out[name] = out.get(name, 0) + n * p.replays
        return out
