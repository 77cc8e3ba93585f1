"""Sleep/wake: move live model state between the card and host memory
without ending the process.

Port of ``llm_d_fast_model_actuation_tpu/engine/sleep.py`` (levels 1 and 2;
device release, transfer quantization, multi-host staging, hot-swap and
tracing are not ported yet). Sleep levels (vLLM vocabulary):

  level 1 — weights and KV pages are copied into pinned host tensors on a
            dedicated copy stream, then their device memory is unmapped
            and released; wake maps new memory and copies them back.
  level 2 — weights and KV are released without a copy; wake maps new
            memory and writes a re-initialized state into it in place
            (the checkpoint reread, for an engine loaded from one).

The state lives in the engine's arenas (``engine/arena.py``): device
memory at addresses reserved when the engine starts. A sleep releases the
physical memory under every allocation of them — the ``offload`` ones
(weights, KV) after their copies have landed, the ``discard`` ones (RoPE
tables, scheduler buffers, the noise buffer) without a copy — and a wake
maps new memory at the same addresses before anything is copied back.
So the state's tensors keep their objects, their storage and their
``data_ptr()`` across a cycle: the model, its ``Parameter`` objects, the
engine's pool and scheduler buffers stay valid, and the chunk's CUDA
graphs (``engine/graphs.py``) replay unchanged after a wake. The owner
rewrites the ``discard`` tensors when it is told the state is back.

**Meshes.** The state of an engine on a tensor-parallel mesh is every
rank's tensors. Each shard goes to a pinned host tensor of its own and
comes back to the device, and into the tensor object, it left: no
resharding and no gather, each card's shard moves independently (one copy
stream per device). ``bytes_offloaded`` is the state's GLOBAL size, as the
reference's is (a sharded ``jax.Array``'s ``nbytes``): a replicated
parameter (a norm) is moved once per rank but counted once, so a model
reports the same figure at any ``tp``.

**Chunked transfers** (``bucket_bytes``): the flattened state is split into
size-bounded buckets of whole tensors and moved bucket by bucket, each
bucket's source freed as soon as it lands. ``None`` = one bucket.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .arena import Arena, arena_of
from .graphs import release_cached_memory


def partition_buckets(
    nbytes: Sequence[int], bucket_bytes: Optional[int]
) -> List[List[int]]:
    """Greedy contiguous partition of leaf indices into buckets of at most
    ``bucket_bytes`` each. Leaves are never split, so a single leaf larger
    than the bound forms its own bucket. ``bucket_bytes=None`` (or <= 0)
    returns one bucket holding everything."""
    if not nbytes:
        return []
    if not bucket_bytes or bucket_bytes <= 0:
        return [list(range(len(nbytes)))]
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nb in enumerate(nbytes):
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


class SleepLevel(enum.IntEnum):
    AWAKE = 0
    L1_HOST_OFFLOAD = 1
    L2_DISCARD = 2


def flatten_state(state: Any) -> List[torch.Tensor]:
    """The state's tensors in a fixed order: dict keys sorted (as
    ``jax.tree.flatten`` orders them), sequences in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in flatten_state(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for x in state for t in flatten_state(x)]
    raise TypeError(f"unsupported state node {type(state).__name__}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class _Stats:
    last_sleep_seconds: float = 0.0
    last_wake_seconds: float = 0.0
    #: host bytes the slept state occupies
    bytes_offloaded: int = 0
    #: full-precision bytes of the state that went to sleep
    bytes_offloaded_full: int = 0
    #: of last_sleep_seconds, the time spent allocating (pinning) the host
    #: buffers rather than copying into them
    last_pin_seconds: float = 0.0
    #: of last_wake_seconds, the time spent getting device memory back
    #: (mapping it, in the arenas) rather than copying into it
    last_alloc_seconds: float = 0.0
    #: of that, the time in the CUDA driver's cuMemCreate/cuMemMap/cuMemSetAccess
    wake_map_s: float = 0.0


class SleepManager:
    """Owns the awake/asleep state of one engine's device tensors.

    ``get_state()`` returns the live state (a nest of dicts/tuples of
    tensors, each an allocation of one of ``arenas``); ``set_state(None)``
    tells the owner its state is released, ``set_state(state)`` that it is
    back (the owner then rewrites its ``discard`` allocations)."""

    def __init__(
        self,
        get_state: Callable[[], Any],
        set_state: Callable[[Any], None],
        device: torch.device,
        arenas: Sequence[Arena],
        bucket_bytes: Optional[int] = None,
        replicas: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
    ) -> None:
        self._get_state = get_state
        self._set_state = set_state
        self.arenas = list(arenas)
        #: the engine's (rank 0's) device; each tensor moves to and from
        #: the device it lives on
        self.device = torch.device(device)
        self.bucket_bytes = bucket_bytes
        #: tensors of the state that repeat another of it on a further
        #: rank: moved like any, left out of ``bytes_offloaded``
        self._replicas = replicas
        self._level = SleepLevel.AWAKE
        self._state: Any = None
        self._leaves: Optional[List[torch.Tensor]] = None
        self._host: Optional[List[torch.Tensor]] = None
        self._cuda = self.device.type == "cuda"
        #: the dedicated copy stream of both transfer directions, per device
        self._streams: Dict[torch.device, Any] = {}
        self.stats = _Stats()

    @property
    def is_sleeping(self) -> bool:
        return self._level != SleepLevel.AWAKE

    @property
    def level(self) -> SleepLevel:
        return self._level

    @property
    def devices_released(self) -> bool:
        return False  # device release is not ported yet

    def _unmap(self, leaves: Sequence[torch.Tensor]) -> None:
        for t in leaves:
            arena_of(self.arenas, t).unmap([t])

    def _map(self, leaves: Sequence[torch.Tensor] = (), tag: Optional[str] = None) -> None:
        """Map the leaves' memory back, and every arena's blocks with
        ``tag``; times it."""
        t0 = time.monotonic()
        native0 = sum(a.map_seconds for a in self.arenas)
        for t in leaves:
            arena_of(self.arenas, t).map([t])
        if tag is not None:
            for arena in self.arenas:
                arena.map(tag=tag)
        self.stats.last_alloc_seconds += time.monotonic() - t0
        self.stats.wake_map_s += sum(a.map_seconds for a in self.arenas) - native0

    def _copy(self, pairs: Sequence[tuple]) -> None:
        """``dst.copy_(src)`` for every pair. On the card, each device's
        copies run on its copy stream, after every write queued on that
        device before the call, and have landed when this returns."""
        if not self._cuda:
            for dst, src in pairs:
                dst.copy_(src)
            return
        by_device: Dict[torch.device, List[tuple]] = {}
        for dst, src in pairs:
            dev = dst.device if dst.is_cuda else src.device
            by_device.setdefault(dev, []).append((dst, src))
        for dev, items in by_device.items():
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for dst, src in items:
                    dst.copy_(src, non_blocking=True)
        for dev in by_device:
            self._streams[dev].synchronize()

    def _offload(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """Device -> pinned host, bucket by bucket; each bucket's device
        memory is released as soon as its copies have landed."""
        host: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self.stats.last_pin_seconds = 0.0
        for bucket in partition_buckets([_nbytes(t) for t in leaves], self.bucket_bytes):
            t_pin = time.monotonic()
            for i in bucket:
                host[i] = torch.empty(
                    leaves[i].shape, dtype=leaves[i].dtype, pin_memory=self._cuda
                )
            self.stats.last_pin_seconds += time.monotonic() - t_pin
            self._copy([(host[i], leaves[i]) for i in bucket])
            self._unmap([leaves[i] for i in bucket])
        return host

    def _restore(self, leaves: List[torch.Tensor], host: List[torch.Tensor]) -> None:
        """Pinned host -> device into the same tensors, bucket by bucket:
        each bucket's memory is mapped back first, and its host copy is
        dropped once it has landed."""
        for bucket in partition_buckets([_nbytes(t) for t in host], self.bucket_bytes):
            self._map([leaves[i] for i in bucket])
            self._copy([(leaves[i], host[i]) for i in bucket])
            for i in bucket:
                host[i] = None

    def sleep(self, level: int = 1) -> Dict[str, Any]:
        level = SleepLevel(level)
        if level == SleepLevel.AWAKE:
            raise ValueError("sleep level must be 1 or 2")
        if self._level != SleepLevel.AWAKE:
            if level == SleepLevel.L2_DISCARD and self._level == SleepLevel.L1_HOST_OFFLOAD:
                # escalate 1 -> 2: give the host memory back too
                self._host = None
                self._level = SleepLevel.L2_DISCARD
                self.stats.bytes_offloaded = 0
                self.stats.bytes_offloaded_full = 0
            return self.describe()
        t0 = time.monotonic()
        self._state = self._get_state()
        leaves = self._leaves = flatten_state(self._state)
        repeated = {id(t) for t in self._replicas()} if self._replicas else set()
        nbytes = sum(_nbytes(t) for t in leaves if id(t) not in repeated)
        if level == SleepLevel.L1_HOST_OFFLOAD:
            self._host = self._offload(leaves)
        else:
            self._host = None
            if self._cuda:
                torch.cuda.synchronize()  # nothing queued may still read them
            self._unmap(leaves)
        self._set_state(None)
        for arena in self.arenas:
            arena.unmap(tag="discard")
        if self._cuda:
            # the caching allocator's free blocks go back to the card too
            for dev in {t.device for t in leaves}:
                release_cached_memory(dev)
        self._level = level
        self.stats.last_sleep_seconds = time.monotonic() - t0
        self.stats.bytes_offloaded = nbytes if level == SleepLevel.L1_HOST_OFFLOAD else 0
        self.stats.bytes_offloaded_full = self.stats.bytes_offloaded
        return self.describe()

    def wake_up(self, reinit: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
        """Restore device state. After a level-2 sleep the state's memory
        is mapped back, and then ``reinit()`` must write a fresh state
        into the live tensors in place (e.g. weights drawn anew and a zero
        pool), so the wake never holds the state twice."""
        if self._level == SleepLevel.AWAKE:
            return self.describe()
        if self._level == SleepLevel.L2_DISCARD and reinit is None:
            raise ValueError("level-2 wake requires a reinit callback")
        t0 = time.monotonic()
        self.stats.last_alloc_seconds = self.stats.wake_map_s = 0.0
        leaves = self._leaves
        if self._level == SleepLevel.L1_HOST_OFFLOAD:
            self._restore(leaves, self._host)
        else:
            self._map(leaves)
            reinit()
        self._map(tag="discard")
        self._host = None
        self._leaves = None
        state, self._state = self._state, None
        self._set_state(state)
        self._level = SleepLevel.AWAKE
        self.stats.last_wake_seconds = time.monotonic() - t0
        return self.describe()

    def describe(self) -> Dict[str, Any]:
        """The reference's ``SleepManager.describe`` keys."""
        return {
            "is_sleeping": self.is_sleeping,
            "level": int(self._level),
            "devices_released": False,
            "bytes_offloaded": self.stats.bytes_offloaded,
            "bytes_offloaded_full": self.stats.bytes_offloaded_full,
            "quant": "off",
            "last_sleep_seconds": self.stats.last_sleep_seconds,
            "last_wake_seconds": self.stats.last_wake_seconds,
            "last_reacquire_seconds": 0.0,
        }


def attach_sleep(engine, bucket_bytes: Optional[int] = None) -> SleepManager:
    """Wire a SleepManager to an InferenceEngine: the offloadable state is
    ``{"params": the model's parameters, "kv": the page pool}``, and the
    engine's arenas hold it. Page tables and host bookkeeping stay put, so
    a level-1 wake resumes in-flight sequences; the device scheduler
    tensors are marked stale while asleep and copied in again by the first
    dispatch after the wake, and the model's RoPE tables are written again
    at wake."""

    def get_state():
        return {
            "params": dict(engine.model.named_parameters()),
            "kv": engine.pool.tensors(),
        }

    def set_state(state):
        if state is None:
            engine.drop_device_sched_state()
            engine.asleep = True
        else:
            engine.model.build_tables()
            engine.asleep = False

    replicas = getattr(engine.model, "replicas", None)  # a sharded model's repeated norms
    return SleepManager(
        get_state, set_state, engine.device, engine.arenas.values(), bucket_bytes=bucket_bytes, replicas=replicas
    )


def fresh_state(engine) -> None:
    """A level-2 wake's reinit for ``engine``: parameters written anew
    into the live tensors (the checkpoint reread when the engine's weights
    came from a loader, else drawn from the engine seed) and the pool
    zeroed, in place, once the wake has mapped their memory back."""
    engine.reload_params()
    for t in engine.pool.tensors():
        t.zero_()
