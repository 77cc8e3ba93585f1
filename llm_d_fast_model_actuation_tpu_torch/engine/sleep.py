"""Sleep/wake: move live model state between the card and host memory
without ending the process.

Port of ``llm_d_fast_model_actuation_tpu/engine/sleep.py`` (levels 1 and 2;
device release, transfer quantization, multi-host staging, hot-swap and
tracing are not ported yet). Sleep levels (vLLM vocabulary):

  level 1 — weights and KV pages are copied into pinned host tensors on a
            dedicated copy stream, the device tensors are freed and the
            caching allocator's blocks are returned to the card
            (``torch.cuda.empty_cache()``); wake copies them back.
  level 2 — weights and KV are discarded; wake re-initializes them.

The state's tensors keep their identity across a cycle: offload and
restore swap each tensor's storage (``t.data = ...``), so the model
module, its ``Parameter`` objects and the engine's pool references stay
valid, and nothing that holds them has to be rebuilt.

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
    #: of last_wake_seconds, the time spent allocating the device tensors
    #: rather than copying into them
    last_alloc_seconds: float = 0.0


class SleepManager:
    """Owns the awake/asleep state of one engine's device tensors.

    ``get_state()`` returns the live state (a nest of dicts/tuples of
    tensors); ``set_state(None)`` tells the owner its state is offloaded,
    ``set_state(state)`` that it is back."""

    def __init__(
        self,
        get_state: Callable[[], Any],
        set_state: Callable[[Any], None],
        device: torch.device,
        bucket_bytes: Optional[int] = None,
        replicas: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
    ) -> None:
        self._get_state = get_state
        self._set_state = set_state
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
        #: (shape, dtype) of each slept tensor, which a level-2 reinit must match
        self._specs: List[tuple] = []
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

    @staticmethod
    def _empty(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(0, dtype=t.dtype, device=t.device)

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
        storage is released as soon as its copies have landed."""
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
            for i in bucket:
                leaves[i].data = self._empty(leaves[i])
        return host

    def _restore(self, leaves: List[torch.Tensor], host: List[torch.Tensor]) -> None:
        """Pinned host -> device into the same tensor objects, bucket by
        bucket; each bucket's host copy is dropped once it has landed."""
        self.stats.last_alloc_seconds = 0.0
        for bucket in partition_buckets([_nbytes(t) for t in host], self.bucket_bytes):
            t_alloc = time.monotonic()
            # allocated on the current stream, which uses them next; each
            # on the device its (emptied) tensor object stayed on
            dev = {
                i: torch.empty(host[i].shape, dtype=host[i].dtype, device=leaves[i].device)
                for i in bucket
            }
            self.stats.last_alloc_seconds += time.monotonic() - t_alloc
            self._copy([(dev[i], host[i]) for i in bucket])
            for i in bucket:
                leaves[i].data = dev[i]
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
        self._specs = [(t.shape, t.dtype) for t in leaves]
        repeated = {id(t) for t in self._replicas()} if self._replicas else set()
        nbytes = sum(_nbytes(t) for t in leaves if id(t) not in repeated)
        if level == SleepLevel.L1_HOST_OFFLOAD:
            self._host = self._offload(leaves)
        else:
            self._host = None
            for t in leaves:
                t.data = self._empty(t)
        self._set_state(None)
        if self._cuda:
            # Return the freed blocks to the card, not just to the cache.
            # cuBLAS keeps a workspace per handle as a live allocation that
            # can sit inside a large cached segment and keep all of it
            # reserved; it is re-created by the first product after wake.
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        self._level = level
        self.stats.last_sleep_seconds = time.monotonic() - t0
        self.stats.bytes_offloaded = nbytes if level == SleepLevel.L1_HOST_OFFLOAD else 0
        self.stats.bytes_offloaded_full = self.stats.bytes_offloaded
        return self.describe()

    def wake_up(self, reinit: Optional[Callable[[], Any]] = None) -> Dict[str, Any]:
        """Restore device state. After a level-2 sleep, ``reinit()`` must
        return a fresh state of the same structure (e.g. re-initialized
        weights and a zero pool); its tensors are moved into the live
        ones."""
        if self._level == SleepLevel.AWAKE:
            return self.describe()
        t0 = time.monotonic()
        leaves = self._leaves
        if self._level == SleepLevel.L1_HOST_OFFLOAD:
            self._restore(leaves, self._host)
        else:
            if reinit is None:
                raise ValueError("level-2 wake requires a reinit callback")
            fresh = flatten_state(reinit())
            if [(f.shape, f.dtype) for f in fresh] != self._specs:
                raise ValueError("reinit state does not match the slept state")
            for t, f in zip(leaves, fresh):
                t.data = f.data
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
    ``{"params": the model's parameters, "kv": the page pool}``. Page
    tables and host bookkeeping stay put, so a level-1 wake resumes
    in-flight sequences; the device scheduler tensors are dropped while
    asleep and re-uploaded by the first chunk after the wake, and the
    model's RoPE tables are rebuilt at wake: a 2 MiB table left on the
    card can keep a whole cached allocator segment reserved."""

    def get_state():
        return {
            "params": dict(engine.model.named_parameters()),
            "kv": engine.pool.tensors(),
        }

    def set_state(state):
        if state is None:
            engine.drop_device_sched_state()
            engine.model.free_tables()
            engine.asleep = True
        else:
            engine.model.build_tables()
            engine.asleep = False

    replicas = getattr(engine.model, "replicas", None)  # a sharded model's repeated norms
    return SleepManager(get_state, set_state, engine.device, bucket_bytes=bucket_bytes, replicas=replicas)


def fresh_state(engine) -> Dict[str, Any]:
    """A level-2 wake's reinit for ``engine``: parameters drawn anew from
    the engine seed and a zero pool, in ``attach_sleep``'s structure."""
    model = engine.init_model()
    tp = engine.mesh.tp if engine.mesh is not None else 1
    shape = tuple(engine.pool.pool_shape(
        engine.cfg.model.num_layers, engine.cfg.num_pages, engine.cfg.page_size,
        engine.cfg.model.num_kv_heads // tp, engine.cfg.model.head_dim,
    ))
    # the slept pool's tensors are empty but keep their dtype and device
    kv = [torch.zeros(shape, dtype=t.dtype, device=t.device) for t in engine.pool.tensors()]
    return {"params": dict(model.named_parameters()), "kv": kv}
