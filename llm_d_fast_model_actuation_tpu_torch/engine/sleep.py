"""Sleep/wake: move live model state between the card and host memory
without ending the process.

Port of ``llm_d_fast_model_actuation_tpu/engine/sleep.py``: levels 1 and 2,
and the overlapped, delta-aware hot-swap between two engines on one card
(:func:`swap_states`, priced by :func:`plan_swap`), and compressed
actuation (``--sleep-quant``), with the reference's spans. Device
release, multi-host staging, and a swap or a quantized transfer on a
tensor-parallel mesh are not ported yet. Sleep levels (vLLM vocabulary):

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
``swap_states`` builds on the same buckets to overlap one model's offload
with another's restore.

**Compressed actuation** (``quant_mode`` int8 or fp8, ``models/quant.py``):
a level-1 offload quantizes each eligible weight stack on the card (layer
slice by layer slice, on the compute stream), and only its payload, and
for int8 its f32 scales, cross PCIe into pinned buffers sized by
``payload_nbytes``. The wake copies bucket k's payloads into device
buffers on the copy stream and dequantizes them into the leaves' own
tensors on the compute stream once an event says they landed, while
bucket k+1's copies run. Lossy once: the first quantized offload rounds
the weights, and every later one quantizes with the scales cached at the
first, to the same bits. ``bytes_offloaded`` counts the payload, and
``bytes_offloaded_full`` the full precision.

**Spans** (``utils/tracing.py``): one ``sleep.d2h`` or ``wake.h2d`` per
bucket, children of the caller's span (``engine.sleep``/``engine.wake``),
each closed once its bucket's copies have landed, never at enqueue; a
swap records ``swap.transfer`` with ``swap.d2h``/``swap.h2d`` per bucket,
``swap.delta``, ``swap.quant`` and ``swap.rollback`` under it. Each loop
reads ``tracing.enabled()`` once: with tracing off it creates no span
object.
"""

from __future__ import annotations

import contextlib
import enum
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models import quant as transfer_quant
from ..utils import faults, tracing
from .arena import Arena, arena_of, hand_over
from .chunk_store import aligned_digests, flatten_state, map_leaves
from .graphs import release_cached_memory


class SwapRolledBack(RuntimeError):
    """A mid-transfer hot-swap failure was rolled back: the outgoing model
    is fully back on the card (awake, serving) and the incoming model's
    host state is intact (re-poolable). The swap did not happen, but
    nothing was lost: retryable."""


class SwapRollbackFailed(RuntimeError):
    """A mid-transfer hot-swap failure could NOT be rolled back: the state
    is partially moved and unrecoverable in-process. The service must fail
    loudly (``/health``) so that the process is replaced."""


#: Default transfer bucket for chunked/overlapped swaps
DEFAULT_SWAP_BUCKET_BYTES = 256 << 20


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
    #: transfer mode of the last level-1 offload: "off" | "int8" | "fp8"
    last_quant: str = "off"
    #: wire bytes the last wake moved host -> device
    last_wake_bytes: int = 0
    #: the copy window of the last level-1 offload (its pinning excluded):
    #: what the cost oracle's ``sleep.d2h`` bandwidth divides by
    last_sleep_transfer_s: float = 0.0
    #: the last level-1 wake's window (mapping, copies, dequantization)
    last_wake_transfer_s: float = 0.0


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
        quant_mode: str = "off",
        quant_hot_head: bool = True,
        on_transfer: Optional[Callable[[str, int, float], None]] = None,
        peek_state: Optional[Callable[[], Any]] = None,
    ) -> None:
        quant_mode = "" if quant_mode in ("", "off") else quant_mode
        if quant_mode:
            reason = transfer_quant.transfer_quant_supported(quant_mode)
            if reason:
                raise ValueError(f"--sleep-quant {quant_mode}: {reason}")
            if replicas is not None:
                raise ValueError(
                    "--sleep-quant on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)"
                )
        self._get_state = get_state
        #: the state a pricing read sees: ``get_state``'s, unless the owner
        #: knows what the edge will leave out (a zero-drain park's pool)
        self._peek_state = peek_state or get_state
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
        #: the dedicated copy streams, per (device, index): :meth:`_stream`
        self._streams: Dict[Tuple[torch.device, int], Any] = {}
        #: the cost oracle's feed: ``on_transfer(kind, bytes, seconds)``
        #: after each transfer window (``sleep.d2h``, ``wake.h2d``,
        #: ``swap.d2h``, ``swap.h2d``, ``swap.total``, ``quant.dequant``)
        #: with the wire bytes it moved; a raising callback fails nothing
        self.on_transfer = on_transfer
        #: compressed actuation: "" (off), "int8" or "fp8"
        self.quant_mode = quant_mode
        #: keep embed and lm_head at full precision under quant_mode
        self.quant_hot_head = quant_hot_head
        #: per leaf, TransferQuant or None, aligned with ``_host`` while
        #: slept quantized (None for a full-precision sleep)
        self._quant_meta: Optional[List[Any]] = None
        #: the int8 scales of each leaf's first quantization (host f32),
        #: aligned with the state's leaves: re-quantizing with them gives
        #: the same payload bits every cycle
        self._quant_scales: Optional[List[Any]] = None
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

    @property
    def sharded(self) -> bool:
        """Whether the state is a tensor-parallel mesh's (some of its
        tensors repeat another rank's)."""
        return self._replicas is not None

    @property
    def _host_state(self) -> Any:
        """The slept state's host copies, as a tree of the state's shape;
        None while awake or after a level-2 sleep."""
        return None if self._host is None else map_leaves(self._state, self._host)

    @_host_state.setter
    def _host_state(self, tree: Any) -> None:
        self._host = flatten_state(tree)

    def _stream(self, dev: torch.device, i: int = 0):
        """The ``i``-th dedicated copy stream of ``dev``: 0 serves both
        directions of a sleep and a wake and a swap's device-to-host
        copies, 1 a swap's host-to-device copies."""
        key = (dev, i)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(dev)
        return stream

    def _notify_transfer(self, kind: str, nbytes: int, seconds: float) -> None:
        """Feed one finished transfer window to the cost oracle; empty
        windows and a failing callback are dropped."""
        if self.on_transfer is None or nbytes <= 0 or seconds <= 0:
            return
        try:
            self.on_transfer(kind, nbytes, seconds)
        except Exception:  # noqa: BLE001 — telemetry never fails an edge
            pass

    def _quant_plan(self, state: Any) -> Optional[List[bool]]:
        """Per-leaf quantize-for-transfer flags of ``state``, or None when
        the mode is off or nothing is eligible."""
        if not self.quant_mode:
            return None
        plan = transfer_quant.transfer_quant_plan(state, hot_head=self.quant_hot_head)
        return plan if any(plan) else None

    def _cached_scale(self, i: int, leaf: torch.Tensor) -> Optional[torch.Tensor]:
        """The int8 scale leaf ``i`` was quantized with at its first
        offload; None before that, or when the state's shape changed."""
        if self._quant_scales is None or i >= len(self._quant_scales):
            return None
        s = self._quant_scales[i]
        want = tuple(leaf.shape[:-2]) + (1, leaf.shape[-1])
        return s if s is not None and tuple(s.shape) == want else None

    def _note_wake_quant(self, metas: Optional[List[Any]]) -> None:
        """After a quantized wake (or a swap's commit): keep the scales, so
        the next offload quantizes to the same bits, and drop the
        consumed payload metadata."""
        if metas is not None and any(m is not None for m in metas):
            self._quant_scales = [None if m is None else m.scale for m in metas]
        self._quant_meta = None

    def offload_wire_bytes(self) -> int:
        """The bytes a level-1 sleep of the live state would move to the
        host (what ``bytes_offloaded`` will say): payload and scale bytes
        for the leaves a quantized offload compresses, full precision for
        the rest, from the shapes alone."""
        state = self._peek_state()
        plan = self._quant_plan(state)
        repeated = {id(t) for t in self._replicas()} if self._replicas else set()
        return sum(
            transfer_quant.payload_nbytes(t.shape, self.quant_mode) if plan and plan[i] else _nbytes(t)
            for i, t in enumerate(flatten_state(state))
            if id(t) not in repeated
        )

    def quant_state(self) -> str:
        """Transfer mode of the slept payload ("off" when the host state
        is full precision, or nothing is slept at level 1)."""
        for m in self._quant_meta or ():
            if m is not None:
                return m.mode
        return "off"

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
            stream = self._stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for dst, src in items:
                    dst.copy_(src, non_blocking=True)
        for dev in by_device:
            self._stream(dev).synchronize()

    def _offload(
        self, leaves: List[torch.Tensor], plan: Optional[List[bool]] = None
    ) -> Tuple[List[torch.Tensor], Optional[List[Any]]]:
        """Device -> pinned host, bucket by bucket; each bucket's device
        memory is released as soon as its copies have landed. With
        ``plan`` (:meth:`_quant_plan`), the flagged leaves are quantized
        on the card first and only their payloads and scales cross.
        Returns the host tensors and the aligned TransferQuant-or-None
        list (None without a plan)."""
        host: List[Optional[torch.Tensor]] = [None] * len(leaves)
        metas: Optional[List[Any]] = [None] * len(leaves) if plan else None
        mode = self.quant_mode

        def wire_nb(i: int) -> int:
            if plan and plan[i]:
                return transfer_quant.payload_nbytes(leaves[i].shape, mode)
            return _nbytes(leaves[i])

        self.stats.last_pin_seconds = 0.0
        traced = tracing.enabled()
        parent = tracing.current_context() if traced else None
        for bucket in partition_buckets([wire_nb(i) for i in range(len(leaves))], self.bucket_bytes):
            sp = tracing.begin("sleep.d2h", parent=parent, activate=False, bytes=sum(wire_nb(i) for i in bucket),
                               leaves=len(bucket)) if traced else None
            t_pin = time.monotonic()
            scales: Dict[int, torch.Tensor] = {}
            for i in bucket:
                quantized = plan is not None and plan[i]
                dtype = transfer_quant.payload_dtype(mode) if quantized else leaves[i].dtype
                host[i] = torch.empty(leaves[i].shape, dtype=dtype, pin_memory=self._cuda)
                if quantized and mode == "int8":
                    shape = tuple(leaves[i].shape[:-2]) + (1, leaves[i].shape[-1])
                    scales[i] = torch.empty(shape, dtype=torch.float32, pin_memory=self._cuda)
            self.stats.last_pin_seconds += time.monotonic() - t_pin
            pairs, payloads = [], []
            for i in bucket:
                if plan is not None and plan[i]:
                    # on the compute stream; the copies below wait for it
                    p, meta = transfer_quant.quantize_leaf(leaves[i], mode, scale=self._cached_scale(i, leaves[i]))
                    payloads.append(p)
                    pairs.append((host[i], p))
                    if i in scales:
                        pairs.append((scales[i], meta.scale))
                        meta.scale = scales[i]
                    metas[i] = meta
                else:
                    pairs.append((host[i], leaves[i]))
            self._copy(pairs)
            if sp is not None:
                sp.end()  # the bucket's copies have landed
            self._unmap([leaves[i] for i in bucket])
            del payloads  # their copies have landed
        return host, metas

    def _restore(
        self, leaves: List[torch.Tensor], host: List[torch.Tensor], metas: Optional[List[Any]] = None
    ) -> None:
        """Pinned host -> device into the same tensors, bucket by bucket:
        each bucket's memory is mapped back first, and its host copy is
        dropped once it has landed. ``metas`` marks quantized payloads:
        see :meth:`_restore_quantized`."""
        if metas is not None and any(m is not None for m in metas):
            return self._restore_quantized(leaves, host, metas)
        traced = tracing.enabled()
        parent = tracing.current_context() if traced else None
        for bucket in partition_buckets([_nbytes(t) for t in host], self.bucket_bytes):
            sp = tracing.begin("wake.h2d", parent=parent, activate=False, bytes=sum(_nbytes(host[i]) for i in bucket),
                               leaves=len(bucket)) if traced else None
            self._map([leaves[i] for i in bucket])
            self._copy([(leaves[i], host[i]) for i in bucket])
            if sp is not None:
                sp.end()  # landed: _copy waited for the copy stream
            for i in bucket:
                host[i] = None

    def _restore_quantized(self, leaves: List[torch.Tensor], host: List[torch.Tensor], metas: List[Any]) -> None:
        """The compressed wake, bucket by bucket: the bucket's memory is
        mapped back, its full-precision leaves are copied in and its
        payloads dequantized into the leaves' own tensors
        (``models/quant.py:dequantize_into``). On the card the copies run
        on the copy stream, and the compute stream dequantizes each payload
        once it landed while the copy stream carries the next ones; at most
        two buckets' device payloads exist at once (a bucket waits for the
        dequantization of the one two before it). The dequantization that
        no copy hid is reported as ``quant.dequant``."""
        wire = [_nbytes(host[i]) + (metas[i].scale_nbytes if metas[i] is not None else 0) for i in range(len(host))]
        cuda = self._cuda
        copy = self._stream(self.device) if cuda else None
        compute = torch.cuda.current_stream(self.device) if cuda else None
        if cuda:
            copy.wait_stream(compute)
        pending: List[torch.cuda.Event] = []
        #: each bucket's span, closed once its dequantization has run
        spans: List[Any] = []
        traced = tracing.enabled()
        parent = tracing.current_context() if traced else None
        inline_s = 0.0
        for bucket in partition_buckets(wire, self.bucket_bytes):
            if len(pending) >= 2:
                pending.pop(0).synchronize()
                if traced:
                    spans.pop(0).end()
            if traced:
                spans.append(tracing.begin("wake.h2d", parent=parent, activate=False,
                                           bytes=sum(wire[i] for i in bucket), leaves=len(bucket), quant=True))
            self._map([leaves[i] for i in bucket])
            with torch.cuda.stream(copy) if cuda else contextlib.nullcontext():
                for i in bucket:
                    if metas[i] is None:
                        leaves[i].copy_(host[i], non_blocking=cuda)
            for i in bucket:
                if metas[i] is not None:
                    t0 = time.monotonic()
                    transfer_quant.dequantize_into(leaves[i], host[i], metas[i], copy_stream=copy)
                    inline_s += time.monotonic() - t0
                host[i] = None  # the pinned allocator keeps it until its copy ran
            if cuda:
                done = torch.cuda.Event()
                done.record(compute)
                pending.append(done)
            elif traced:
                spans.pop(0).end()  # the CPU's copies and expansions ran inline
        dq_s = inline_s
        if cuda:
            copy.synchronize()
            t_tail = time.monotonic()
            for ev in pending:
                ev.synchronize()
                if traced:
                    spans.pop(0).end()
            dq_s = time.monotonic() - t_tail
        self._notify_transfer("quant.dequant", sum(w for w, m in zip(wire, metas) if m is not None), dq_s)
        if cuda:
            release_cached_memory(self.device)  # the payload buffers go back to the card

    def sleep(self, level: int = 1) -> Dict[str, Any]:
        level = SleepLevel(level)
        if level == SleepLevel.AWAKE:
            raise ValueError("sleep level must be 1 or 2")
        if self._level != SleepLevel.AWAKE:
            if level == SleepLevel.L2_DISCARD and self._level == SleepLevel.L1_HOST_OFFLOAD:
                # escalate 1 -> 2: give the host memory back too, and the
                # payload metadata and scales with it (a level-2 wake
                # writes fresh weights, which stale scales must never
                # quantize)
                self._host = None
                self._quant_meta = self._quant_scales = None
                self._level = SleepLevel.L2_DISCARD
                self.stats.bytes_offloaded = 0
                self.stats.bytes_offloaded_full = 0
                self.stats.last_quant = "off"
            return self.describe()
        t0 = time.monotonic()
        self._state = self._get_state()
        leaves = self._leaves = flatten_state(self._state)
        repeated = {id(t) for t in self._replicas()} if self._replicas else set()
        nbytes = sum(_nbytes(t) for t in leaves if id(t) not in repeated)
        off_window = 0.0
        if level == SleepLevel.L1_HOST_OFFLOAD:
            off_t0 = time.monotonic()
            self._host, self._quant_meta = self._offload(leaves, self._quant_plan(self._state))
            off_window = time.monotonic() - off_t0 - self.stats.last_pin_seconds
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
        self.stats.last_sleep_transfer_s = off_window
        if level == SleepLevel.L1_HOST_OFFLOAD:
            self.stats.bytes_offloaded_full = nbytes
            metas = self._quant_meta
            if metas is not None:
                # what the host holds: payload and scale bytes for the
                # quantized leaves, full precision for the rest
                self.stats.bytes_offloaded = sum(
                    _nbytes(h) for h, t in zip(self._host, leaves) if id(t) not in repeated
                ) + sum(m.scale_nbytes for m in metas if m is not None)
                self.stats.last_quant = self.quant_mode
            else:
                self.stats.bytes_offloaded = nbytes
                self.stats.last_quant = "off"
            self._notify_transfer("sleep.d2h", self.stats.bytes_offloaded, off_window)
        else:
            self.stats.bytes_offloaded = self.stats.bytes_offloaded_full = 0
            self.stats.last_quant = "off"
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
        was_l1 = self._level == SleepLevel.L1_HOST_OFFLOAD
        if was_l1:
            metas = self._quant_meta
            repeated = {id(t) for t in self._replicas()} if self._replicas else set()
            self.stats.last_wake_bytes = sum(
                _nbytes(h) for h, t in zip(self._host, leaves) if id(t) not in repeated
            ) + sum(m.scale_nbytes for m in metas or () if m is not None)
            self._restore(leaves, self._host, metas)
            self._note_wake_quant(metas)
        else:
            # fresh weights: the cached scales describe weights that are gone
            self._quant_scales = self._quant_meta = None
            self._map(leaves)
            reinit()
        self._map(tag="discard")
        self._host = None
        self._leaves = None
        state, self._state = self._state, None
        self._set_state(state)
        self._level = SleepLevel.AWAKE
        self.stats.last_wake_seconds = time.monotonic() - t0
        if was_l1:
            self.stats.last_wake_transfer_s = self.stats.last_wake_seconds
            self._notify_transfer("wake.h2d", self.stats.last_wake_bytes, self.stats.last_wake_transfer_s)
        else:
            self.stats.last_wake_transfer_s = 0.0
            self.stats.last_wake_bytes = 0
        return self.describe()

    def describe(self) -> Dict[str, Any]:
        """The reference's ``SleepManager.describe`` keys."""
        return {
            "is_sleeping": self.is_sleeping,
            "level": int(self._level),
            "devices_released": False,
            "bytes_offloaded": self.stats.bytes_offloaded,
            "bytes_offloaded_full": self.stats.bytes_offloaded_full,
            "quant": self.stats.last_quant,
            "last_sleep_seconds": self.stats.last_sleep_seconds,
            "last_wake_seconds": self.stats.last_wake_seconds,
            "last_reacquire_seconds": 0.0,
        }


@dataclass
class _TransferPlan:
    """Byte-exact schedule of one hot-swap, computed from shapes, dtypes,
    devices and digests alone: no data read, no byte moved. Shared by the
    executing :func:`swap_states` and the dry-run :func:`plan_swap`, so a
    priced swap and the swap it prices can never disagree on bytes."""

    qmode: str  #: "" or the transfer quantization in effect
    out_plan: Optional[List[bool]]  #: per outgoing leaf: quantized on the card
    #: per incoming leaf: a full-precision entry's leaves staged as a
    #: quantized copy on the host (None when not applicable); only the
    #: moving leaves are staged
    in_stage_plan: Optional[List[bool]]
    in_metas: List[Any]  #: the incoming entry's TransferQuant-or-None (slept quantized)
    reuse_pairs: List[Tuple[int, int]]  #: (incoming idx, outgoing idx) digest matches
    move_out: List[int]
    move_in: List[int]
    nb_out: List[int]
    nb_in: List[int]  #: full-precision bytes per incoming leaf
    wnb_out: List[int]  #: wire bytes per outgoing leaf
    wnb_in: List[int]  #: wire bytes per incoming leaf
    buckets_out: List[List[int]]
    buckets_in: List[List[int]]
    bytes_out: int
    bytes_in: int
    bytes_full: int
    deduped_bytes: int
    moved_bytes: int
    quant_leaves: int
    quant_mode_used: str


def _plan_transfer(
    out_mgr: SleepManager,
    in_mgr: SleepManager,
    state_out: Any,
    leaves_out: List[torch.Tensor],
    bucket_bytes: int,
    out_digests: Optional[Dict[str, str]],
    in_digests: Optional[Dict[str, str]],
    quant: Optional[str],
) -> _TransferPlan:
    """The planning phase of a hot-swap (see :func:`swap_states`): which
    leaves move, which are digest-matched away, which cross quantized,
    and how many wire bytes each direction carries. Pure: reads shapes,
    dtypes, devices and digests."""
    state_in, leaves_in, host_in = in_mgr._state, in_mgr._leaves, in_mgr._host
    qmode = quant if quant is not None else (out_mgr.quant_mode or "off")
    qmode = "" if qmode in ("", "off") else qmode
    out_plan = out_mgr._quant_plan(state_out) if qmode else None
    in_metas: List[Any] = list(in_mgr._quant_meta) if in_mgr._quant_meta is not None else [None] * len(leaves_in)
    nb_out = [_nbytes(t) for t in leaves_out]
    # the incoming leaves' device tensors keep their full-precision shape
    # and dtype while a quantized payload sleeps in their place
    nb_in = [_nbytes(t) for t in leaves_in]
    # Delta matching: pair incoming leaves with content-identical live
    # outgoing leaves by digest; matched pairs leave BOTH directions. A
    # match also needs an equal shape, dtype and device (the reference's
    # sharding), so the two blocks are the same size on the same card.
    reuse_pairs: List[Tuple[int, int]] = []
    if out_digests and in_digests:
        by_digest: Dict[str, List[int]] = {}
        for j, d in enumerate(aligned_digests(state_out, out_digests)):
            if d is not None:
                by_digest.setdefault(d, []).append(j)
        for i, d in enumerate(aligned_digests(state_in, in_digests)):
            cands = by_digest.get(d) if d is not None else None
            if not cands:
                continue
            j = cands[0]
            lo, li = leaves_out[j], leaves_in[i]
            if lo.shape == li.shape and lo.dtype == li.dtype and lo.device == li.device:
                reuse_pairs.append((i, j))
                cands.pop(0)
    reused_in = {i for i, _ in reuse_pairs}
    reused_out = {j for _, j in reuse_pairs}
    move_out = [i for i in range(len(leaves_out)) if i not in reused_out]
    move_in = [i for i in range(len(leaves_in)) if i not in reused_in]
    move_in_set = set(move_in)
    # a full-precision incoming entry under quant crosses as a quantized
    # staging copy of its moving leaves, sized from the shapes alone
    in_stage_plan = None
    if qmode and in_mgr._quant_meta is None:
        in_stage_plan = transfer_quant.transfer_quant_plan(state_in, hot_head=in_mgr.quant_hot_head)
    wnb_out = [
        transfer_quant.payload_nbytes(leaves_out[i].shape, qmode) if out_plan and out_plan[i] else nb_out[i]
        for i in range(len(leaves_out))
    ]

    def _wire_in(i: int) -> int:
        if in_metas[i] is not None:  # a payload already
            return _nbytes(host_in[i]) + in_metas[i].scale_nbytes
        if in_stage_plan and in_stage_plan[i] and i in move_in_set:
            return transfer_quant.payload_nbytes(leaves_in[i].shape, qmode)
        return nb_in[i]

    wnb_in = [_wire_in(i) for i in range(len(leaves_in))]
    buckets_out = [[move_out[k] for k in b] for b in partition_buckets([wnb_out[i] for i in move_out], bucket_bytes)]
    buckets_in = [[move_in[k] for k in b] for b in partition_buckets([wnb_in[i] for i in move_in], bucket_bytes)]
    bytes_out, bytes_in = sum(wnb_out), sum(wnb_in)
    deduped = sum(wnb_out[j] for j in reused_out) + sum(wnb_in[i] for i in reused_in)
    quant_leaves = sum(1 for i in move_out if out_plan and out_plan[i]) + sum(
        1 for i in move_in if in_metas[i] is not None or (in_stage_plan and in_stage_plan[i])
    )
    quant_active = (
        bool(out_plan)
        or any(m is not None for m in in_metas)
        or bool(in_stage_plan and any(in_stage_plan[i] for i in move_in))
    )
    used = (qmode or next((m.mode for m in in_metas if m is not None), "off")) if quant_active else "off"
    return _TransferPlan(
        qmode=qmode, out_plan=out_plan, in_stage_plan=in_stage_plan, in_metas=in_metas,
        reuse_pairs=reuse_pairs, move_out=move_out, move_in=move_in, nb_out=nb_out, nb_in=nb_in,
        wnb_out=wnb_out, wnb_in=wnb_in, buckets_out=buckets_out, buckets_in=buckets_in,
        bytes_out=bytes_out, bytes_in=bytes_in, bytes_full=sum(nb_out) + sum(nb_in),
        deduped_bytes=deduped, moved_bytes=bytes_out + bytes_in - deduped,
        quant_leaves=quant_leaves, quant_mode_used=used,
    )


def _check_swap_preconditions(out_mgr: SleepManager, in_mgr: SleepManager) -> None:
    if out_mgr.is_sleeping:
        raise ValueError("swap-out model must be awake")
    if in_mgr.level != SleepLevel.L1_HOST_OFFLOAD or in_mgr._host is None:
        raise ValueError(
            "swap-in model must be asleep at level 1 with host-resident state (level-2 states cannot hot-swap)"
        )
    if out_mgr.sharded or in_mgr.sharded:
        raise ValueError("hot-swap on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)")
    if out_mgr.device != in_mgr.device:
        raise ValueError(f"hot-swap between {out_mgr.device} and {in_mgr.device}: both models must be on one device")


def _swap_bytes(plan: _TransferPlan, bucket_bytes: int) -> Dict[str, Any]:
    """The byte keys of a swap's metrics, as the reference names them:
    wire bytes, the full-precision total and what quantization saved."""
    return {
        "bytes_out": plan.bytes_out,
        "bytes_in": plan.bytes_in,
        "bytes_moved": plan.moved_bytes,
        "bytes_deduped": plan.deduped_bytes,
        "deduped_leaves": len(plan.reuse_pairs),
        "quant": plan.quant_mode_used,
        "quant_leaves": plan.quant_leaves,
        "bytes_full": plan.bytes_full,
        "bytes_saved_quant": max(0, plan.bytes_full - (plan.bytes_out + plan.bytes_in)),
        "buckets_out": len(plan.buckets_out),
        "buckets_in": len(plan.buckets_in),
        "bucket_bytes": bucket_bytes,
    }


def plan_swap(
    out_mgr: SleepManager,
    in_mgr: SleepManager,
    bucket_bytes: Optional[int] = None,
    out_digests: Optional[Dict[str, str]] = None,
    in_digests: Optional[Dict[str, str]] = None,
    quant: Optional[str] = None,
) -> Dict[str, Any]:
    """Price a hot-swap WITHOUT moving a byte: the planning code
    :func:`swap_states` executes (same preconditions, same delta
    matching, same quantized-payload sizing), run on a side-effect-free
    read of the outgoing state, so the predicted bytes equal the executed
    swap's by construction. Returns the byte keys of the swap's metrics,
    the bytes that cross PCIe each way (``wire_out``, ``wire_in``) and the
    leaf counts."""
    _check_swap_preconditions(out_mgr, in_mgr)
    bucket_bytes = bucket_bytes or DEFAULT_SWAP_BUCKET_BYTES
    # the reference prices from a peek that skips its get_state's quiesce;
    # the port's peek reads the tensors and quiesces nothing (under a
    # pending zero-drain park it leaves the pool out, as the swap will)
    state_out = out_mgr._peek_state()
    leaves_out = flatten_state(state_out)
    plan = _plan_transfer(out_mgr, in_mgr, state_out, leaves_out, bucket_bytes, out_digests, in_digests, quant)
    return {
        **_swap_bytes(plan, bucket_bytes),
        "wire_out": sum(plan.wnb_out[i] for i in plan.move_out),
        "wire_in": sum(plan.wnb_in[i] for i in plan.move_in),
        "leaves_out": len(leaves_out),
        "leaves_in": len(in_mgr._leaves),
    }


def swap_states(
    out_mgr: SleepManager,
    in_mgr: SleepManager,
    bucket_bytes: Optional[int] = None,
    overlapped: bool = True,
    out_digests: Optional[Dict[str, str]] = None,
    in_digests: Optional[Dict[str, str]] = None,
    quant: Optional[str] = None,
) -> Dict[str, Any]:
    """Overlapped model hot-swap: stream the awake model behind ``out_mgr``
    to pinned host memory while ``in_mgr``'s slept (level-1) state streams
    back to the card, double-buffered over size-bounded buckets.

    Schedule (the reference's): while outgoing bucket k drains on one copy
    stream, incoming bucket k-1 rides the other copy stream into memory
    mapped after bucket k-1's copy landed and its blocks were released, so
    the swap approaches max(sleep, wake) instead of their sum and the
    extra card memory is about one bucket. Events order the two
    directions: an outgoing block is unmapped only after its copy's event,
    and no queued kernel reads it then (the copies wait for the compute
    stream first). Buckets hold whole tensors, so a bucket is at least one
    leaf (``peak_bytes_in_flight`` reports the window as it was). The host
    buffers of the outgoing copies are allocated (pinned) before the
    transfer starts, and timed apart (``pin_s``). On the CPU the copies
    run in turn.

    Ends with ``out_mgr`` asleep at level 1 (host-resident, poolable) and
    ``in_mgr`` awake, every tensor of both at its old address. Bit-exact:
    whole tensors move, nothing is recomputed.

    **Delta-aware** (``out_digests``/``in_digests``, flat weight key ->
    content digest, ``engine/chunk_store.py``): leaves the two models share
    by content never cross PCIe. At commit a matched incoming leaf's block
    takes over the outgoing leaf's physical memory (``arena.hand_over``:
    on the card the allocation is unmapped at one address and mapped at
    the other, no byte copied), and the incoming host copy becomes the
    outgoing model's slept copy. ``bytes_moved`` counts the bytes that
    cross PCIe; ``None`` digests give the full transfer.

    **Transactional**: the incoming model's host copies are not touched
    before the commit, and the outgoing model's copies land before their
    memory is released. A failure mid-transfer (an out-of-memory map, an
    injected ``swap.d2h``/``swap.h2d`` fault, a failed handover) is rolled
    back: handed-over blocks go back, the incoming blocks mapped so far are
    released, the outgoing blocks already released are mapped again and
    refilled from their host copies, and :class:`SwapRolledBack` is raised:
    both models end as they began. Only a failure *during that rollback*
    raises :class:`SwapRollbackFailed`.

    ``overlapped=False`` runs the same code on a sequential schedule
    (every outgoing bucket lands before the first incoming one is issued).

    **Quantized transfers** (``quant`` int8 or fp8; by default the
    outgoing manager's mode): the outgoing model's eligible leaves are
    quantized on the card and only their payloads cross; an incoming model
    slept quantized moves its payloads, which are dequantized on the card
    into its leaves once each lands (the compute stream waits for its
    copy, while the next copies run: ``models/quant.py:
    dequantize_into``); an incoming
    model slept at full precision crosses as a quantized staging copy made
    on the host, its pooled host state untouched before the commit. A
    rollback refills the outgoing leaves from their payloads with the same
    scales, so both models come back bit-exact, and a rolled-back first
    quantized offload keeps the scales it rounded with. Digest-matched
    leaves still skip both directions. The byte keys count wire bytes;
    ``bytes_full`` is the full-precision total and ``bytes_saved_quant``
    the difference."""
    _check_swap_preconditions(out_mgr, in_mgr)
    bucket_bytes = bucket_bytes or DEFAULT_SWAP_BUCKET_BYTES
    # the transfer's root span, not made current (it ends on the error
    # paths too); bucket spans only when tracing is on
    root = tracing.begin("swap.transfer", activate=False, overlapped=overlapped)
    traced = root is not tracing.NOOP_SPAN
    root_ctx = root.context() if traced else None
    t_begin = time.monotonic()
    dev = out_mgr.device
    cuda = out_mgr._cuda
    state_out = out_mgr._get_state()
    leaves_out = flatten_state(state_out)
    state_in, leaves_in, host_in = in_mgr._state, in_mgr._leaves, in_mgr._host
    plan = _plan_transfer(out_mgr, in_mgr, state_out, leaves_out, bucket_bytes, out_digests, in_digests, quant)
    qmode, out_plan, in_metas = plan.qmode, plan.out_plan, plan.in_metas
    buckets_out, buckets_in = plan.buckets_out, plan.buckets_in
    bsize_out = [sum(plan.wnb_out[i] for i in b) for b in buckets_out]
    bsize_in = [sum(plan.wnb_in[i] for i in b) for b in buckets_in]
    arena_out = [arena_of(out_mgr.arenas, t) for t in leaves_out]
    arena_in = [arena_of(in_mgr.arenas, t) for t in leaves_in]
    meta_out: List[Any] = [None] * len(leaves_out)
    if traced and plan.reuse_pairs:
        tracing.begin("swap.delta", parent=root_ctx, activate=False, leaves_shared=len(plan.reuse_pairs),
                      bytes_deduped=plan.deduped_bytes, bytes_moved=plan.moved_bytes).end()
    if traced and plan.quant_mode_used != "off":
        wire = plan.bytes_out + plan.bytes_in
        tracing.begin("swap.quant", parent=root_ctx, activate=False, mode=plan.quant_mode_used,
                      leaves=plan.quant_leaves, bytes_wire=wire, bytes_full=plan.bytes_full,
                      bytes_saved=max(0, plan.bytes_full - wire)).end()

    # the host staging of a full-precision incoming entry's moving leaves
    # (its pooled copies stay as they are until the commit)
    stage_in: List[Optional[torch.Tensor]] = [None] * len(leaves_in)
    if plan.in_stage_plan is not None:
        for i in plan.move_in:
            if plan.in_stage_plan[i]:
                stage_in[i], in_metas[i] = transfer_quant.quantize_leaf_host(host_in[i], qmode, pin=cuda)

    # the outgoing host copies (payload-sized where quantized), allocated
    # before the transfer window
    t_pin = time.monotonic()
    host_out: List[Optional[torch.Tensor]] = [None] * len(leaves_out)
    scale_out: Dict[int, torch.Tensor] = {}
    for i in plan.move_out:
        t = leaves_out[i]
        if out_plan and out_plan[i]:
            host_out[i] = torch.empty(t.shape, dtype=transfer_quant.payload_dtype(qmode), pin_memory=cuda)
            if qmode == "int8":
                scale_out[i] = torch.empty(tuple(t.shape[:-2]) + (1, t.shape[-1]), dtype=torch.float32, pin_memory=cuda)
        else:
            host_out[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
    pin_s = time.monotonic() - t_pin
    s_out = out_mgr._stream(dev, 0) if cuda else None
    s_in = out_mgr._stream(dev, 1) if cuda else None
    compute = torch.cuda.current_stream(dev) if cuda else None

    in_flight = peak_in_flight = 0
    d2h_t0 = d2h_t1 = h2d_t0 = h2d_t1 = None
    #: outgoing leaves whose memory was released (a rollback maps and refills them)
    released_out: List[int] = []
    #: incoming leaves mapped so far (a rollback releases them)
    mapped_in: List[int] = []
    #: (incoming, outgoing) pairs whose block changed hands (a rollback hands them back)
    handed: List[Tuple[int, int]] = []
    handover_s = 0.0
    #: the incoming payloads' bytes, and on the CPU their dequantization's
    #: seconds (it runs inline; on the card its unhidden tail is timed)
    dequant = [0, 0.0]

    def _event(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def _quantize_out(i: int) -> torch.Tensor:
        """Leaf ``i``'s payload, quantized where it lies (the compute
        stream), its meta's scale bound for the host buffer."""
        p, meta = transfer_quant.quantize_leaf(leaves_out[i], qmode, scale=out_mgr._cached_scale(i, leaves_out[i]))
        meta_out[i] = meta
        return p

    def _bucket_span(name: str, k: int, nbytes: int):
        return tracing.begin(name, parent=root_ctx, activate=False, bucket=k, bytes=nbytes) if traced else None

    def _issue_d2h(k):
        nonlocal in_flight, peak_in_flight
        sp = _bucket_span("swap.d2h", k, bsize_out[k])
        try:
            faults.fire("swap.d2h")
        except Exception as e:
            if sp is not None:
                sp.set(error=f"{type(e).__name__}: {e}").end()
            raise
        bucket = buckets_out[k]
        srcs = [(i, _quantize_out(i) if out_plan and out_plan[i] else leaves_out[i]) for i in bucket]
        ev = None
        if cuda:
            s_out.wait_stream(compute)  # every queued write (and quantization) first
            with torch.cuda.stream(s_out):
                for i, src in srcs:
                    host_out[i].copy_(src, non_blocking=True)
                    if i in scale_out:
                        scale_out[i].copy_(meta_out[i].scale, non_blocking=True)
            ev = _event(s_out)
        else:
            for i, src in srcs:
                host_out[i].copy_(src)
                if i in scale_out:
                    scale_out[i].copy_(meta_out[i].scale)
        in_flight += bsize_out[k]
        peak_in_flight = max(peak_in_flight, in_flight)
        return k, ev, srcs, sp

    def _finish_d2h(pending):
        nonlocal in_flight
        k, ev, _srcs, sp = pending
        if ev is not None:
            ev.synchronize()
        if sp is not None:
            sp.end()  # the bucket's copies have landed
        bucket = buckets_out[k]
        for i in bucket:
            if i in scale_out:
                meta_out[i].scale = scale_out[i]
        released_out.extend(bucket)  # before the unmap: a failed one is mapped again
        for i in bucket:
            arena_out[i].unmap([leaves_out[i]])  # the memory the next incoming bucket fills
        in_flight -= bsize_out[k]

    def _issue_h2d(j):
        nonlocal in_flight, peak_in_flight, h2d_t0
        sp = _bucket_span("swap.h2d", j, bsize_in[j])
        try:
            faults.fire("swap.h2d")
        except Exception as e:
            if sp is not None:
                sp.set(error=f"{type(e).__name__}: {e}").end()
            raise
        if h2d_t0 is None:
            h2d_t0 = time.monotonic()
        bucket = buckets_in[j]
        mapped_in.extend(bucket)
        for i in bucket:
            arena_in[i].map([leaves_in[i]])
        ev = None
        with torch.cuda.stream(s_in) if cuda else contextlib.nullcontext():
            for i in bucket:
                src = stage_in[i] if stage_in[i] is not None else host_in[i]
                if in_metas[i] is None:
                    leaves_in[i].copy_(src, non_blocking=cuda)
        for i in bucket:
            if in_metas[i] is not None:
                # on the card the expansion runs on the compute stream once
                # the payload landed, under the next copies
                src = stage_in[i] if stage_in[i] is not None else host_in[i]
                t0 = time.monotonic()
                transfer_quant.dequantize_into(leaves_in[i], src, in_metas[i], copy_stream=s_in)
                dequant[0] += _nbytes(src) + in_metas[i].scale_nbytes
                if not cuda:
                    dequant[1] += time.monotonic() - t0
        if cuda:
            ev = _event(s_in)
        in_flight += bsize_in[j]
        peak_in_flight = max(peak_in_flight, in_flight)
        return j, ev, sp

    def _finish_h2d(pending):
        nonlocal in_flight
        j, ev, sp = pending
        if ev is not None:
            ev.synchronize()
        if sp is not None:
            sp.end()  # landed (a quantized bucket's expansion may still run)
        in_flight -= bsize_in[j]

    pend_d2h = pend_h2d = None
    next_in = 0

    def _rollback() -> None:
        """Undo every side effect of a partial swap: land what is in
        flight, hand matched blocks back, release what the incoming model
        mapped, and map and refill the outgoing leaves already released
        from their host copies (which landed before the release, by
        construction; quantized ones dequantized with the scales they were
        quantized with). The incoming host copies were never touched."""
        for pending in (pend_h2d, pend_d2h):
            if pending is not None and pending[1] is not None:
                try:
                    pending[1].synchronize()
                except Exception:  # noqa: BLE001 — the failed transfer itself
                    pass
            if pending is not None and pending[-1] is not None and not pending[-1].ended:
                pending[-1].set(error="rolled_back").end()
        if cuda:
            torch.cuda.synchronize(dev)
        for i, buf in scale_out.items():
            if meta_out[i] is not None:
                meta_out[i].scale = buf  # landed with its payload
        for i, j in reversed(handed):
            hand_over(arena_in[i], leaves_in[i], arena_out[j], leaves_out[j])
        for i in mapped_in:
            arena_in[i].unmap([leaves_in[i]])
        for arena in in_mgr.arenas:
            arena.unmap(tag="discard")
        for b in partition_buckets([plan.wnb_out[i] for i in released_out], bucket_bytes):
            idx = [released_out[k] for k in b]
            for i in idx:
                arena_out[i].map([leaves_out[i]])
            out_mgr._copy([(leaves_out[i], host_out[i]) for i in idx if meta_out[i] is None])
            for i in idx:
                if meta_out[i] is not None:
                    transfer_quant.dequantize_into(leaves_out[i], host_out[i], meta_out[i])
            if cuda:
                torch.cuda.synchronize(dev)
        if any(m is not None for m in meta_out):
            # a rolled-back first quantized offload already rounded the
            # refilled leaves: keep the scales it used, so the next
            # offload quantizes to the same bits instead of recomputing a
            # perturbed scale from the rounded weights
            out_mgr._quant_scales = [None if m is None else m.scale for m in meta_out]

    d2h_t0 = time.monotonic()
    try:
        for k in range(len(buckets_out)):
            cur = _issue_d2h(k)
            if pend_d2h is not None:
                _finish_d2h(pend_d2h)
                pend_d2h = None
                if overlapped and next_in < len(buckets_in):
                    if pend_h2d is not None:
                        _finish_h2d(pend_h2d)
                        pend_h2d = None
                    pend_h2d = _issue_h2d(next_in)
                    next_in += 1
            pend_d2h = cur
        if pend_d2h is not None:
            _finish_d2h(pend_d2h)
            pend_d2h = None
        d2h_t1 = time.monotonic()
        while next_in < len(buckets_in):
            if pend_h2d is not None:
                _finish_h2d(pend_h2d)
                pend_h2d = None
            pend_h2d = _issue_h2d(next_in)
            next_in += 1
        if pend_h2d is not None:
            _finish_h2d(pend_h2d)
            pend_h2d = None
        if cuda and dequant[0]:
            # the last buckets' dequantization belongs to the wake's window
            t_dq = time.monotonic()
            compute.synchronize()
            dequant[1] = time.monotonic() - t_dq
        out_mgr._notify_transfer("quant.dequant", *dequant)
        h2d_t1 = time.monotonic()
        # the commit's device edits: the incoming model's discard blocks,
        # then the delta handover, once nothing queued uses either model
        for arena in in_mgr.arenas:
            arena.map(tag="discard")
        t_hand = time.monotonic()
        if plan.reuse_pairs and cuda:
            torch.cuda.synchronize(dev)
        for i, j in plan.reuse_pairs:
            hand_over(arena_out[j], leaves_out[j], arena_in[i], leaves_in[i])
            handed.append((i, j))
        handover_s = time.monotonic() - t_hand
    except Exception as exc:
        rb_sp = tracing.begin("swap.rollback", parent=root_ctx, activate=False, error=f"{type(exc).__name__}: {exc}")
        try:
            _rollback()
        except Exception as rb_exc:
            rb_sp.set(rollback_failed=True).end()
            root.set(error="rollback_failed").end()
            raise SwapRollbackFailed(
                f"hot-swap transfer failed ({type(exc).__name__}: {exc}) and the rollback failed "
                f"({type(rb_exc).__name__}: {rb_exc}); device state is partially moved"
            ) from rb_exc
        rb_sp.end()
        root.set(error="rolled_back").end()
        raise SwapRolledBack(f"hot-swap transfer failed mid-flight; rolled back ({type(exc).__name__}: {exc})") from exc
    if h2d_t0 is None:  # nothing moved in
        h2d_t0 = h2d_t1

    # Commit: the matched incoming host copies (and their payload
    # metadata) become the outgoing model's slept copies; outgoing asleep
    # (poolable), incoming awake.
    for i, j in plan.reuse_pairs:
        host_out[j] = host_in[i]
        meta_out[j] = in_metas[i]
    out_mgr._state, out_mgr._leaves, out_mgr._host = state_out, leaves_out, host_out
    out_mgr._quant_meta = meta_out if any(m is not None for m in meta_out) else None
    out_mgr._set_state(None)
    for arena in out_mgr.arenas:
        arena.unmap(tag="discard")
    out_mgr._level = SleepLevel.L1_HOST_OFFLOAD
    out_mgr.stats.last_sleep_seconds = out_mgr.stats.last_sleep_transfer_s = d2h_t1 - d2h_t0
    out_mgr.stats.last_pin_seconds = pin_s
    out_mgr.stats.bytes_offloaded = sum(_nbytes(h) for h in host_out) + sum(
        m.scale_nbytes for m in meta_out if m is not None
    )
    out_mgr.stats.bytes_offloaded_full = sum(plan.nb_out)
    out_mgr.stats.last_quant = plan.quant_mode_used if out_mgr._quant_meta is not None else "off"
    in_mgr._host = in_mgr._leaves = in_mgr._state = None
    in_mgr._set_state(state_in)
    in_mgr._level = SleepLevel.AWAKE
    # the incoming model's scales, for its next offload; the payload
    # metadata is consumed
    in_mgr._note_wake_quant(in_metas)
    in_mgr.stats.last_wake_seconds = in_mgr.stats.last_wake_transfer_s = h2d_t1 - h2d_t0
    in_mgr.stats.last_wake_bytes = plan.bytes_in
    in_mgr.stats.bytes_offloaded = in_mgr.stats.bytes_offloaded_full = 0

    if cuda and plan.quant_mode_used != "off":
        release_cached_memory(dev)  # the payload buffers go back to the card
    total = time.monotonic() - t_begin
    # overlap = the intersection of the two directions' windows
    overlap = max(0.0, min(d2h_t1, h2d_t1) - max(d2h_t0, h2d_t0))
    root.set(
        bytes_out=plan.bytes_out, bytes_in=plan.bytes_in, bytes_moved=plan.moved_bytes,
        bytes_deduped=plan.deduped_bytes, buckets_out=len(buckets_out), buckets_in=len(buckets_in),
        overlap_frac=round(overlap / total, 6) if total > 0 else 0.0, peak_bytes_in_flight=peak_in_flight,
    ).end()
    # the cost oracle's bandwidths: each direction's window over the bytes
    # that crossed it, and the whole verb's effective rate
    out_mgr._notify_transfer("swap.d2h", sum(plan.wnb_out[i] for i in plan.move_out), d2h_t1 - d2h_t0)
    out_mgr._notify_transfer("swap.h2d", sum(plan.wnb_in[i] for i in plan.move_in), h2d_t1 - h2d_t0)
    out_mgr._notify_transfer("swap.total", plan.moved_bytes, total)
    return {
        "swap_total_s": total,
        "d2h_s": d2h_t1 - d2h_t0,
        "h2d_s": h2d_t1 - h2d_t0,
        "overlap_s": overlap,
        "overlap_frac": overlap / total if total > 0 else 0.0,
        **_swap_bytes(plan, bucket_bytes),
        "peak_bytes_in_flight": peak_in_flight,
        "pin_s": pin_s,
        "handover_s": handover_s,
    }


def attach_sleep(
    engine,
    bucket_bytes: Optional[int] = None,
    quant_mode: str = "off",
    quant_hot_head: bool = True,
    on_transfer: Optional[Callable[[str, int, float], None]] = None,
) -> SleepManager:
    """Wire a SleepManager to an InferenceEngine: the offloadable state is
    ``{"params": the model's parameters, "kv": the page pool}``, and the
    engine's arenas hold it. Page tables and host bookkeeping stay put, so
    a level-1 wake resumes in-flight sequences; the device scheduler
    tensors are marked stale while asleep and copied in again by the first
    dispatch after the wake, and the model's RoPE tables are written again
    at wake. ``quant_mode`` and ``quant_hot_head`` are compressed
    actuation's (``--sleep-quant``, ``--sleep-quant-hot-head``);
    ``on_transfer`` feeds the cost oracle.

    Zero-drain (``engine/parked.py``): while a park has released the pool
    (``engine.kv_detached``) the state is the weights alone, and when such
    a state comes back the pool is rebuilt (mapped once, at its addresses,
    and zeroed) for the parked requests to be paged into. A pricing peek
    leaves the pool out as well while a park is pending
    (``engine.zero_drain_park``)."""

    def weights():
        return {"params": dict(engine.model.named_parameters())}

    def get_state():
        state = weights()
        if not engine.kv_detached:
            state["kv"] = engine.pool.tensors()
        return state

    def peek_state():
        return weights() if engine.zero_drain_park else get_state()

    def set_state(state):
        if state is None:
            engine.drop_device_sched_state()
            engine.asleep = True
        else:
            if "kv" not in state:
                engine.rebuild_kv_pool()
            engine.model.build_tables()
            engine.asleep = False

    replicas = getattr(engine.model, "replicas", None)  # a sharded model's repeated norms
    return SleepManager(
        get_state, set_state, engine.device, engine.arenas.values(), bucket_bytes=bucket_bytes, replicas=replicas,
        quant_mode=quant_mode, quant_hot_head=quant_hot_head, on_transfer=on_transfer, peek_state=peek_state,
    )


def fresh_state(engine) -> None:
    """A level-2 wake's reinit for ``engine``: parameters written anew
    into the live tensors (the checkpoint reread when the engine's weights
    came from a loader, else drawn from the engine seed) and the pool
    zeroed, in place, once the wake has mapped their memory back (a pool
    a park released is rebuilt, zero, when the state comes back)."""
    engine.reload_params()
    if not engine.kv_detached:
        for t in engine.pool.tensors():
            t.zero_()
