"""Content-addressed weight chunks: the substrate of the tiered model pool.

Port of ``llm_d_fast_model_actuation_tpu/engine/chunk_store.py`` (mesh
qualification, ``qualify_digest``, waits with swap on meshes). Weight
identity is content-addressed instead of model-addressed:

  * every parameter of a model loaded from a checkpoint gets a sha256
    **digest**, computed once after its load, off the build's path
    (:class:`DigestJob`, joined where the digests are read), or from the
    host leaves of a prefetch, with the reference's string for equal bits
    (:func:`leaf_digest`);
  * :class:`ChunkStore` holds host-resident weight chunks keyed by digest,
    **refcounted**, so two pooled fine-tunes of one base hold their common
    tensors in host memory once (``dedup_saved_bytes``);
  * chunks whose last reference drops **spill to a local-disk tier**
    (bounded LRU, atomic-rename writes, content-verified reload: a stale,
    corrupt or colliding blob is a miss, never wrong weights), so an
    evicted variant can be rebuilt from local disk instead of re-reading
    its checkpoint. A blob's format is the reference's (a JSON header line
    with the numpy dtype name, then the raw bytes), so either package
    reads the other's.

The same digests drive the delta-aware hot-swap
(``engine/sleep.py:swap_states``): leaves the incoming and outgoing models
share by content never cross PCIe; their physical device memory is handed
over and only the delta moves.

A chunk here is a torch tensor on the host (a sleeping model's pinned copy
or a tensor read back from disk); the reference's is a numpy array.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

#: disk chunk files: "<sha256-of-digest>.chunk" under the spill dir
_CHUNK_SUFFIX = ".chunk"

#: torch dtype -> the numpy dtype name the reference hashes (bf16 as
#: ``ml_dtypes``' ``bfloat16``)
NP_NAMES: Dict[torch.dtype, str] = {
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float32: "float32",
    torch.float64: "float64",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.bool: "bool",
    torch.float8_e4m3fn: "float8_e4m3fn",
}
#: the numpy dtype name -> torch dtype
TORCH_DTYPES = {v: k for k, v in NP_NAMES.items()}

#: digest prefix of a chunk whose digest is not the plain content hash of
#: its bytes: a transfer-quantized payload (``models/quant.py:
#: transfer_digest``). Its spill blob's header carries the payload's own
#: :func:`leaf_digest` (``content``), which a reload checks instead of
#: recomputing the transfer digest; equal ``q:`` digests imply equal
#: payload bytes, since the transfer digest's preimage includes it. No
#: content digest starts with it (a content digest is hex).
QUANT_DIGEST_PREFIX = "q:"

#: threads that hash a model's leaves at once (hashlib releases the GIL)
DIGEST_WORKERS = 8
#: bytes of a tensor on the card that a digest copies to the host at a
#: time, into a pinned buffer of its own: a copy to pageable memory runs
#: at a few GB/s and the copies of all the threads queue behind each other
DIGEST_CHUNK_BYTES = 64 << 20


def default_disk_dir() -> str:
    """Where the weight-chunk disk tier lives when ``--pool-disk-dir`` is
    not given: ``FMA_POOL_SPILL_DIR``, else disabled."""
    return os.environ.get("FMA_POOL_SPILL_DIR", "")


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The raw bytes of ``t``, a host tensor, without a copy when it is
    contiguous already."""
    return memoryview(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())


def leaf_digest(t: torch.Tensor, times: Optional[List[float]] = None) -> str:
    """The reference's ``leaf_digest`` of a tensor: sha256 over the numpy
    dtype's name, the shape and the raw bytes, so the strings are equal
    for equal bits. A host tensor's memory is hashed where it lies; a
    tensor on the card streams through a pinned buffer,
    ``DIGEST_CHUNK_BYTES`` at a time, copied on a stream of its own and
    waited for by that stream alone (so it may run while another thread
    captures a CUDA graph). ``times``, when given, gets the seconds of the
    copies and of the hash appended."""
    h = hashlib.sha256()
    h.update(NP_NAMES[t.dtype].encode())
    h.update(b"|")
    h.update(",".join(str(d) for d in t.shape).encode())
    h.update(b"|")
    copy_s = hash_s = 0.0
    if t.numel() and t.device.type == "cpu":
        t0 = time.perf_counter()
        h.update(_host_bytes(t))
        hash_s = time.perf_counter() - t0
    elif t.numel():
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        buf = torch.empty(min(DIGEST_CHUNK_BYTES, flat.numel()), dtype=torch.uint8, pin_memory=True)
        view = memoryview(buf.numpy())
        with torch.cuda.stream(torch.cuda.Stream(t.device)):
            for off in range(0, flat.numel(), buf.numel()):
                n = min(buf.numel(), flat.numel() - off)
                t0 = time.perf_counter()
                buf[:n].copy_(flat[off : off + n])  # waits for the copy
                t1 = time.perf_counter()
                h.update(view[:n])
                copy_s += t1 - t0
                hash_s += time.perf_counter() - t1
    if times is not None:
        times += [copy_s, hash_s]
    return h.hexdigest()


class DigestJob:
    """:func:`leaf_digest` of each tensor of ``named``, on a thread pool
    of ``workers`` threads that starts at once: each worker streams its
    tensor to the host and hashes it, so the leaves are hashed side by
    side (sha256 of one leaf is serial; hashlib and the copies release the
    GIL). :meth:`result` waits for them: a build starts the job and goes
    on, and the digests are joined only where they are read. ``times``
    gets each key's [copy seconds, hash seconds]; ``seconds`` the job's
    wall time, once it is done."""

    def __init__(self, named: Dict[str, torch.Tensor], workers: int = DIGEST_WORKERS) -> None:
        items = list(named.items())
        self.times: Dict[str, List[float]] = {k: [] for k, _ in items}
        self.seconds = 0.0
        self._t0 = time.perf_counter()
        self._keys = [k for k, _ in items]
        self._pool = ThreadPoolExecutor(max(1, min(workers, len(items))), thread_name_prefix="leaf-digest")
        self._futures = [self._pool.submit(leaf_digest, t, self.times[k]) for k, t in items]
        self._digests: Optional[Dict[str, str]] = None
        self._mu = threading.Lock()

    def done(self) -> bool:
        """Whether every leaf is hashed (:meth:`result` would not wait)."""
        return all(f.done() for f in self._futures)

    def close(self) -> None:
        """Drop the leaves not yet started and wait for those being
        hashed: a stopped service's workers must not outlive it, holding
        its engine's tensors."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def result(self) -> Dict[str, str]:
        """Every key's digest (waits for the job; raises what a worker
        raised). Any number of threads may wait on it."""
        with self._mu:
            if self._digests is None:
                try:
                    self._digests = dict(zip(self._keys, (f.result() for f in self._futures)))
                finally:
                    self._pool.shutdown(wait=True)
                self.seconds = time.perf_counter() - self._t0
            return self._digests


def digest_leaves(
    named: Dict[str, torch.Tensor], workers: int = DIGEST_WORKERS, times: Optional[Dict[str, List[float]]] = None
) -> Dict[str, str]:
    """:func:`leaf_digest` of each tensor of ``named``, side by side on a
    :class:`DigestJob`, waited for. ``times``, when given, gets each key's
    [copy seconds, hash seconds]."""
    job = DigestJob(named, workers)
    out = job.result()
    if times is not None:
        times.update(job.times)
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict from '/'-joined flat keys — the inverse of the flat-key
    convention every digest map and manifest in this module uses."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def digest_tree(params: Dict[str, Any]) -> Dict[str, str]:
    """Flat-key -> digest over a nested host tree of tensors (the loader
    computes this from the model instead)."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = node

    walk(params, ())
    return {k: leaf_digest(v) for k, v in flat.items()}


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


def map_leaves(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree`` with its leaves, in :func:`flatten_state` order, replaced
    by ``new_leaves``."""
    it = iter(new_leaves)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            out = dict.fromkeys(node)
            for k in sorted(node):
                out[k] = walk(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return next(it)

    return walk(tree)


def leaf_paths(state: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """The key path of every leaf of ``state`` in :func:`flatten_state`'s
    order (dict keys sorted, sequences in order; a
    dotted parameter name ``layers.wq`` is the path ``layers``, ``wq``)."""
    if isinstance(state, torch.Tensor):
        return [prefix]
    if isinstance(state, dict):
        return [p for k in sorted(state) for p in leaf_paths(state[k], prefix + tuple(str(k).split(".")))]
    if isinstance(state, (list, tuple)):
        return [p for i, x in enumerate(state) for p in leaf_paths(x, prefix + (str(i),))]
    raise TypeError(f"unsupported state node {type(state).__name__}")


def aligned_digests(state: Any, digests: Optional[Dict[str, str]], prefix: str = "params") -> List[Optional[str]]:
    """Per-leaf digest list aligned with ``flatten_state(state)``.

    ``digests`` maps flat param keys ("embed", "layers/wq", ...) to
    digests; leaves outside the ``prefix`` subtree (the KV pool) get None
    — they are never content-matched."""
    out: List[Optional[str]] = []
    for keys in leaf_paths(state):
        if not digests:
            out.append(None)
        elif prefix:
            out.append(digests.get("/".join(keys[1:])) if keys and keys[0] == prefix else None)
        else:
            out.append(digests.get("/".join(keys)))
    return out


@dataclass
class _Chunk:
    digest: str
    data: torch.Tensor
    nbytes: int
    refs: int = 0
    stored_at: float = field(default_factory=time.monotonic)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ChunkStore:
    """Refcounted host tier + bounded disk tier of content-addressed chunks.

    Host tier: chunks live here exactly while referenced (refs > 0) by
    pool entries; :meth:`intern` dedupes (a second variant's identical
    tensor returns the FIRST one's and adds a reference), :meth:`release`
    drops a reference and — when the last one goes — spills the chunk to
    the disk tier before freeing it.

    Disk tier: bounded LRU of spilled chunks (``disk_budget_bytes``; <= 0
    or an empty ``disk_dir`` disables it). Writes are atomic-rename;
    :meth:`fetch` re-verifies the content hash on reload, so a stale, torn,
    corrupt or colliding blob is a miss (the caller cold-loads).

    Byte totals are running counters. Thread-safe."""

    def __init__(
        self,
        disk_dir: str = "",
        disk_budget_bytes: int = 0,
    ) -> None:
        self.disk_dir = disk_dir or ""
        self.disk_budget_bytes = int(disk_budget_bytes)
        self._mu = threading.Lock()
        self._chunks: Dict[str, _Chunk] = {}
        #: digest -> file size; insertion order is the disk LRU order
        self._disk: "OrderedDict[str, int]" = OrderedDict()
        self.host_bytes = 0
        self.disk_bytes = 0
        self.dedup_saved_bytes = 0
        self.dedup_hits = 0
        self.disk_spills = 0
        self.disk_hits = 0
        self.disk_evictions = 0
        self.verify_failures = 0
        if self._disk_enabled():
            self._scan_disk()

    def __len__(self) -> int:
        return len(self._chunks)

    def __contains__(self, digest: str) -> bool:
        return digest in self._chunks

    # -- host tier ------------------------------------------------------------

    def intern(self, digest: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Register one reference to ``digest``, with ``t`` as its content
        when the chunk is new. Returns ``(canonical, added_bytes)``: on a
        dedup hit the canonical tensor is the EXISTING chunk's (the caller
        drops its duplicate: that is the host-memory saving) and
        added_bytes is 0."""
        with self._mu:
            c = self._chunks.get(digest)
            if c is not None:
                c.refs += 1
                self.dedup_hits += 1
                self.dedup_saved_bytes += c.nbytes
                return c.data, 0
            nb = _nbytes(t)
            self._chunks[digest] = _Chunk(digest=digest, data=t, nbytes=nb, refs=1)
            self.host_bytes += nb
            return t, nb

    def release(self, digest: str, spill: bool = True) -> int:
        """Drop one reference; when the last goes, spill the chunk to the
        disk tier (``spill=True``, the eviction path) and free it. Returns
        the host bytes freed (0 while other references hold it)."""
        freed = self._drop_ref(digest)
        if freed is None:
            return 0
        data, nb = freed
        if spill:
            self._spill(digest, data)
        return nb

    def release_deferred(self, digest: str) -> Optional[Tuple[str, torch.Tensor]]:
        """Drop one reference WITHOUT spilling inline: when the last goes,
        returns ``(digest, data)`` for the caller to :meth:`spill` after
        dropping its own locks. None while still referenced."""
        freed = self._drop_ref(digest)
        return None if freed is None else (digest, freed[0])

    def _drop_ref(self, digest: str) -> Optional[Tuple[torch.Tensor, int]]:
        with self._mu:
            c = self._chunks.get(digest)
            if c is None:
                return None
            if c.refs > 1:
                c.refs -= 1
                self.dedup_saved_bytes -= c.nbytes
                return None
            del self._chunks[digest]
            self.host_bytes -= c.nbytes
        return c.data, c.nbytes

    def spill(self, digest: str, data: torch.Tensor) -> bool:
        """Write one freed chunk to the disk tier (the deferred half of
        :meth:`release_deferred`)."""
        return self._spill(digest, data)

    def fetch(self, digest: str) -> Optional[torch.Tensor]:
        """Resolve a digest: the host tier first (the tensor a sibling
        still references, no copy), then a verified disk-tier reload; None
        is a miss (the caller cold-loads). Takes no reference."""
        with self._mu:
            c = self._chunks.get(digest)
            if c is not None:
                return c.data
        return self._load_spilled(digest)

    def peek_tier(self, digest: str) -> Optional[str]:
        """Which tier could serve ``digest`` now: ``"host"`` (a referenced
        chunk), ``"disk"`` (a spilled blob is registered; its content is
        verified only when fetched) or None, without reading, verifying
        or touching the LRU order (the cost oracle's probe)."""
        with self._mu:
            if digest in self._chunks:
                return "host"
            if self._disk_enabled() and digest in self._disk:
                return "disk"
        return None

    # -- disk tier ------------------------------------------------------------

    def _disk_enabled(self) -> bool:
        return bool(self.disk_dir) and self.disk_budget_bytes > 0

    def _path(self, digest: str) -> str:
        name = hashlib.sha256(digest.encode()).hexdigest() + _CHUNK_SUFFIX
        return os.path.join(self.disk_dir, name)

    def _scan_disk(self) -> None:
        """Adopt chunk files from earlier runs (oldest first = LRU order),
        so the disk tier survives a restart; trims to the budget."""
        try:
            entries = []
            for f in os.listdir(self.disk_dir):
                if not f.endswith(_CHUNK_SUFFIX):
                    continue
                p = os.path.join(self.disk_dir, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, p, st.st_size))
            entries.sort()
            with self._mu:
                for _, p, size in entries:
                    digest = self._read_header_digest(p)
                    if digest is None:
                        continue
                    self._disk[digest] = size
                    self.disk_bytes += size
                self._trim_disk_locked()
        except OSError:
            pass

    @staticmethod
    def _read_header_digest(path: str) -> Optional[str]:
        try:
            with open(path, "rb") as f:
                header = f.readline(4096)
            return json.loads(header).get("digest")
        except Exception:  # noqa: BLE001 — a torn header is just not adopted
            return None

    def _spill(self, digest: str, data: torch.Tensor) -> bool:
        if not self._disk_enabled():
            return False
        with self._mu:
            if digest in self._disk:
                # on disk from an earlier cycle: still a fresh use
                self._disk.move_to_end(digest)
                return True
        nb = _nbytes(data)
        header = json.dumps({
            "digest": digest,
            "dtype": NP_NAMES[data.dtype],
            "shape": list(data.shape),
            "nbytes": nb,
            "content": leaf_digest(data),
        }).encode()
        path = self._path(digest)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(header)
                f.write(b"\n")
                if nb:
                    f.write(_host_bytes(data))
            os.replace(tmp, path)  # atomic: readers never see a torn file
        except OSError:
            logger.warning("chunk spill failed for %s", digest[:16], exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        size = len(header) + 1 + nb
        with self._mu:
            self._disk[digest] = size
            self._disk.move_to_end(digest)
            self.disk_bytes += size
            self.disk_spills += 1
            self._trim_disk_locked()
        return True

    def _trim_disk_locked(self) -> None:
        while self.disk_bytes > self.disk_budget_bytes and self._disk:
            victim, size = self._disk.popitem(last=False)
            self.disk_bytes -= size
            self.disk_evictions += 1
            try:
                os.unlink(self._path(victim))
            except OSError:
                pass

    def _load_spilled(self, digest: str) -> Optional[torch.Tensor]:
        if not self._disk_enabled():
            return None
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                header = json.loads(f.readline())
                raw = bytearray(f.read())
        except (OSError, ValueError):
            self._forget_disk(digest)
            return None
        try:
            # content verify on every reload: a stale blob, bitrot or a
            # collision is a miss, never silently wrong weights
            dtype = TORCH_DTYPES[header["dtype"]]
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
            t = t.view(dtype).reshape(header["shape"])
            if digest.startswith(QUANT_DIGEST_PREFIX):
                want = header.get("content")
                if header.get("digest") != digest or not want or leaf_digest(t) != want:
                    raise ValueError("content digest mismatch")
            elif header.get("digest") != digest or leaf_digest(t) != digest:
                raise ValueError("content digest mismatch")
        except Exception:  # noqa: BLE001 — any malformed blob is a miss
            with self._mu:
                self.verify_failures += 1
            self._forget_disk(digest)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        with self._mu:
            if digest in self._disk:
                self._disk.move_to_end(digest)  # LRU touch
            self.disk_hits += 1
        return t

    def _forget_disk(self, digest: str) -> None:
        with self._mu:
            size = self._disk.pop(digest, None)
            if size is not None:
                self.disk_bytes -= size

    # -- observability --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "host_chunks": len(self._chunks),
                "host_bytes": self.host_bytes,
                "dedup_saved_bytes": self.dedup_saved_bytes,
                "dedup_hits": self.dedup_hits,
                "disk_dir": self.disk_dir if self._disk_enabled() else "",
                "disk_budget_bytes": self.disk_budget_bytes,
                "disk_chunks": len(self._disk),
                "disk_bytes": self.disk_bytes,
                "disk_spills": self.disk_spills,
                "disk_hits": self.disk_hits,
                "disk_evictions": self.disk_evictions,
                "verify_failures": self.verify_failures,
            }
