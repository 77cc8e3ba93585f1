"""Orbax checkpoint save/load for engine weights: the reference's
cold-start path, read and written by the port itself.

Port of ``llm_d_fast_model_actuation_tpu/models/checkpoint.py``. A
checkpoint directory is what the JAX package's ``save_params`` writes:

  * ``<dir>/params``: an Orbax StandardCheckpoint with OCDBT and zarr v2
    (``models/ocdbt.py`` reads and writes it; orbax and tensorstore are
    not needed), plus Orbax's own metadata files (``_METADATA``,
    ``_CHECKPOINT_METADATA``, ``_sharding``, ``array_metadatas/``);
  * ``<dir>/config.json``: the config fields it was written with, so a
    checkpoint of another shape fails loudly at load time;
  * ``<dir>/manifest.json``: each leaf's content digest
    (``engine/chunk_store.py:leaf_digest``), so a load gets every
    weight's identity without hashing what it restored (the tiered
    pool's dedup and the delta swap).

:func:`load_params` restores into a model's own tensors in place (the
engine's, in its arenas: neither an address nor a captured graph
changes), one zarr chunk at a time: decoded on the zstd pool into a
pinned host buffer and copied to the card on a copy stream of its own,
waited for by its own events (so it may run beside a capture). The
whole tree is never assembled on the host. On a ``pp``/``tp``/``ep``
mesh each rank's slice of a chunk goes to the rank, cut as
``llama.param_specs`` cuts it (a stage's ranks receive its layers only). A ``--quantization int8`` config restores bf16 and quantizes on
the way in, one leaf at a time (``hf.place_quantized_leaf``).

:func:`save_params` writes a checkpoint the JAX package's
``load_params`` restores bit for bit: each leaf copied to the host a
chunk at a time (a chunk along the first axis, at most ``CHUNK_BYTES``),
its chunks zstd-encoded on the pool and its digest hashed beside them.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..engine.chunk_store import NP_NAMES
from ..native import zstd
from ..parallel.mesh import Mesh
from ..utils import faults, tracing
from . import ocdbt
from .llama import Llama, LlamaConfig, ShardedLlama, held_ranks, param_shapes, param_specs, quantized_names

CONFIG_FILE = "config.json"
PARAMS_DIR = "params"
#: per-leaf content digests, written at save time (the reference's)
MANIFEST_FILE = "manifest.json"

#: LlamaConfig fields that must match between checkpoint and engine config
#: (dtype/attention_impl are runtime choices, not weight-layout facts)
_SHAPE_FIELDS = (
    "vocab_size",
    "hidden_size",
    "num_layers",
    "num_heads",
    "num_kv_heads",
    "head_dim",
    "intermediate_size",
    "tie_embeddings",
    "num_experts",
    "norm_offset",
    "hidden_activation",
    "embed_scale",
    "post_norms",
    "qk_norm",
)

#: the largest chunk :func:`save_params` writes (a chunk is one zstd frame,
#: decoded whole into one pinned buffer at load)
CHUNK_BYTES = 64 << 20
#: host bytes of decoded chunks a load keeps in flight (at least one chunk)
LOAD_INFLIGHT_BYTES = 1 << 30


def _config_dict(cfg: LlamaConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["dtype"] = NP_NAMES[cfg.dtype]
    return d


def validate_config(directory: str, cfg: LlamaConfig) -> None:
    """Raise unless ``directory``'s ``config.json`` was written for
    ``cfg``'s weight layout (the reference's check and message; a field
    an older checkpoint lacks is compared at the dataclass default)."""
    path = os.path.join(directory, CONFIG_FILE)
    try:
        with open(path) as f:
            saved = json.load(f)
    except OSError as e:
        raise FileNotFoundError(f"no checkpoint config at {path}") from e
    field_defaults = {f.name: f.default for f in dataclasses.fields(type(cfg))}
    mismatches = {
        k: (saved.get(k, field_defaults.get(k)), getattr(cfg, k, None))
        for k in _SHAPE_FIELDS
        if saved.get(k, field_defaults.get(k)) != getattr(cfg, k, None)
    }
    if mismatches:
        raise ValueError(
            f"checkpoint {directory} was written for a different model shape: "
            + ", ".join(f"{k}: ckpt={a} engine={b}" for k, (a, b) in mismatches.items())
        )


def read_manifest(directory: str) -> Dict[str, str]:
    """The manifest's flat key -> digest; empty for a checkpoint without
    one (or one that does not parse)."""
    path = os.path.join(directory, MANIFEST_FILE)
    if not os.path.isfile(path):
        return {}
    try:
        with open(path) as f:
            return dict(json.load(f).get("digests") or {})
    except (OSError, ValueError):
        return {}


def _flat_leaves(params: Any) -> Dict[str, torch.Tensor]:
    """Flat key (``layers/wq``) -> tensor of a model (its ranks joined),
    a nested tree or a flat dict keyed ``layers.wq`` or ``layers/wq``."""
    if isinstance(params, (Llama, ShardedLlama)):
        from .hf import model_leaves

        return model_leaves(params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + tuple(str(k).replace(".", "/").split("/")))
        else:
            out["/".join(prefix)] = node

    walk(params, ())
    return out


# -- save ---------------------------------------------------------------------


def _orbax_metadata(directory: str, leaves: Dict[str, torch.Tensor], chunks: Dict[str, Tuple[int, ...]]) -> None:
    """Orbax's own files beside the database: the tree metadata (keyed by
    the tuple of a leaf's path), the checkpoint metadata, the shardings
    (base64 of the dotted name) and the array metadatas."""
    tree, sharding, arrays = {}, {}, []
    for flat in sorted(leaves):
        parts = flat.split("/")
        shape = list(leaves[flat].shape)
        tree[repr(tuple(parts))] = {
            "key_metadata": [{"key": p, "key_type": 2} for p in parts],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape},
        }
        name = ".".join(parts)
        sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
            {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
        arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                          "chunk_shape": list(chunks[flat]), "ext_metadata": None}})
    now = time.time_ns()
    files = {
        "_METADATA": {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
        "_CHECKPOINT_METADATA": {
            "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
            "custom_metadata": {}},
        "_sharding": sharding,
        os.path.join("array_metadatas", "process_0"): {"array_metadatas": arrays},
    }
    for rel, body in files.items():
        path = os.path.join(directory, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(body, f)


def save_params(directory: str, cfg: LlamaConfig, params: Any) -> Dict[str, Any]:
    """Write ``params`` (a model, or a tree as the reference nests it) and
    ``cfg`` to ``directory`` (created; it must not hold a checkpoint).

    Each chunk is copied into a host buffer of a small ring (pinned when
    a leaf lies on a card), encoded from there on the zstd pool while its
    leaf's digest thread hashes it, and written by one writer thread in
    order; a buffer is reused once both have read it. Returns the write's
    figures: ``seconds``, ``bytes`` (the leaves'), ``stored_bytes`` (the
    encoded chunks'), ``digests``, and the calling thread's ``copy_s``
    (into the ring), ``buffer_wait_s`` (for a buffer to come free) and
    ``drain_wait_s`` (for the last writes and digests)."""
    t0 = time.perf_counter()
    directory = os.path.abspath(directory)
    leaves = _flat_leaves(params)
    params_dir = os.path.join(directory, PARAMS_DIR)
    writer = ocdbt.Writer(params_dir)
    pool = zstd.pool()
    files = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
    digests: Dict[str, Future] = {}
    chunks: Dict[str, Tuple[int, ...]] = {}
    stored = [0]
    pin = any(t.device.type == "cuda" for t in leaves.values())
    ring = max(2, 2 * zstd.WORKERS)
    free: List[torch.Tensor] = []
    #: (buffer, frame, digest update) of each chunk in flight, oldest first
    busy: List[Tuple[torch.Tensor, Future, Future]] = []
    writes: List[Future] = []
    times = {"copy_s": 0.0, "buffer_wait_s": 0.0}

    def buffer(nbytes: int) -> torch.Tensor:
        t_wait = time.perf_counter()
        while not free and len(busy) >= ring:
            buf, frame, update = busy.pop(0)
            frame.result()
            update.result()
            free.append(buf)
        times["buffer_wait_s"] += time.perf_counter() - t_wait
        while free:
            buf = free.pop()
            if buf.numel() >= nbytes:
                return buf
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)

    def write(df: ocdbt.DataFile, key: str, frame: Future) -> None:
        blob = frame.result()
        df.append(key, blob)
        stored[0] += len(blob)

    with tracing.span("checkpoint.save", directory=directory, leaves=len(leaves)):
        for flat in sorted(leaves):
            t = leaves[flat].detach()
            name = flat.replace("/", ".")
            shape = tuple(t.shape)
            cs = ocdbt.chunk_shape(shape, t.element_size(), CHUNK_BYTES)
            chunks[flat] = cs
            writer.put(f"{name}/.zarray", ocdbt.zarray(shape, cs, t.dtype))
            # the digest over the raw bytes in C order: the chunks along the
            # first axis, in order, on a thread of the leaf's own
            h = hashlib.sha256()
            h.update(NP_NAMES[t.dtype].encode() + b"|" + ",".join(str(d) for d in shape).encode() + b"|")
            hasher = ThreadPoolExecutor(1, thread_name_prefix="digest")
            df = writer.data_file()
            rows = shape[0] if shape else 1
            step = cs[0] if shape else 1
            row_bytes = math.prod(shape[1:]) * t.element_size() if shape else t.element_size()
            flat_bytes = t.contiguous().reshape(-1).view(torch.uint8)
            for i, r0 in enumerate(range(0, rows, step)):
                n = (min(rows, r0 + step) - r0) * row_bytes
                full = step * row_bytes
                buf = buffer(full)
                t_copy = time.perf_counter()
                chunk = buf[:full]
                chunk[:n].copy_(flat_bytes[r0 * row_bytes : r0 * row_bytes + n])
                if n < full:
                    chunk[n:].zero_()  # a zarr chunk is stored whole
                times["copy_s"] += time.perf_counter() - t_copy
                key = f"{name}/" + (".".join([str(i)] + ["0"] * (len(shape) - 1)) if shape else "0")
                frame = pool.submit(zstd.compress, chunk.numpy(), ocdbt.CHUNK_LEVEL)
                busy.append((buf, frame, hasher.submit(h.update, chunk[:n].numpy())))
                writes.append(files.submit(write, df, key, frame))
            writes.append(files.submit(df.close))
            digests[flat] = hasher.submit(h.hexdigest)
            hasher.shutdown(wait=False)
            del flat_bytes
        t_drain = time.perf_counter()
        for f in writes:
            f.result()
        files.shutdown()
        writer.close()
        _orbax_metadata(params_dir, leaves, chunks)
        with open(os.path.join(directory, CONFIG_FILE), "w") as f:
            json.dump(_config_dict(cfg), f, indent=2, sort_keys=True)
        manifest = {k: digests[k].result() for k in sorted(digests)}
        times["drain_wait_s"] = time.perf_counter() - t_drain
        with open(os.path.join(directory, MANIFEST_FILE), "w") as f:
            json.dump({"format": 1, "digests": manifest}, f, indent=2)
    return {"seconds": time.perf_counter() - t0, "stored_bytes": stored[0], **times,
            "bytes": sum(t.numel() * t.element_size() for t in leaves.values()), "digests": manifest}


# -- load ---------------------------------------------------------------------


class _Buffers:
    """Host buffers for decoded chunks, pinned when the destination is a
    card, reused by size; at most ``limit`` bytes of them out at once,
    and always one. Only the loading thread takes and gives."""

    def __init__(self, pin: bool, limit: int) -> None:
        self.pin, self.limit = pin, limit
        self.free: Dict[int, List[torch.Tensor]] = {}
        self.out = 0

    def room(self, nbytes: int) -> bool:
        return not self.out or self.out + nbytes <= self.limit

    def take(self, nbytes: int) -> torch.Tensor:
        self.out += nbytes
        spare = self.free.get(nbytes)
        return spare.pop() if spare else torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)

    def give(self, buf: torch.Tensor) -> None:
        self.out -= buf.numel()
        self.free.setdefault(buf.numel(), []).append(buf)


def _rank_box(shape: Tuple[int, ...], spec, mesh: Optional[Mesh], rank: int, local: Tuple[int, ...]) -> List[int]:
    """The first global coordinate of rank ``rank``'s slice, dimension by
    dimension (0 where the dimension is whole)."""
    return [mesh.index(rank, axis) * n if mesh is not None and axis is not None and mesh.shape[axis] > 1 else 0
            for axis, n in zip(spec, local)]


def _intersect(region: Tuple[slice, ...], start: List[int], local: Tuple[int, ...]):
    """(slices into the chunk, slices into the rank's tensor) where chunk
    ``region`` meets the rank's box, or None."""
    into_chunk, into_rank = [], []
    for r, s, n in zip(region, start, local):
        lo, hi = max(r.start, s), min(r.stop, s + n)
        if lo >= hi:
            return None
        into_chunk.append(slice(lo - r.start, hi - r.start))
        into_rank.append(slice(lo - s, hi - s))
    return tuple(into_chunk), tuple(into_rank)


def _load_into(arrays: Dict[str, ocdbt.ZarrArray], model: "Llama | ShardedLlama", names: List[str], stats) -> None:
    """The chunks of ``names`` decoded on the zstd pool and copied into
    ``model``'s parameters of those names, on each card by a copy stream
    of the load's own, a buffer reused once its copies on every card
    landed."""
    ranks = held_ranks(model)
    mesh = model.mesh if isinstance(model, ShardedLlama) else None
    specs = param_specs(model.cfg)
    devices = list(dict.fromkeys(m.device for _, m in ranks))
    cuda = any(d.type == "cuda" for d in devices)
    streams, begun = {}, {}
    for d in devices:
        if d.type == "cuda":
            streams[d] = torch.cuda.Stream(d)
            # after whatever the card's stream wrote there before (an arena's zero fill)
            streams[d].wait_stream(torch.cuda.current_stream(d))
            begun[d] = torch.cuda.Event(enable_timing=True)
            begun[d].record(streams[d])
    bufs = _Buffers(cuda, LOAD_INFLIGHT_BYTES)
    jobs = [(flat, idx) for flat in names for idx in arrays[flat].grid()]
    pool = zstd.pool()
    held: List[Tuple[List[Any], torch.Tensor]] = []  # (an event per card, buffer) until its copies landed
    futures: List[Future] = []
    end_events: List[Tuple[torch.device, Any]] = []
    ahead = max(2, 2 * zstd.WORKERS)

    def decode(flat: str, idx, buf: torch.Tensor) -> Tuple[torch.Tensor, float]:
        a = arrays[flat]
        t0 = time.perf_counter()
        chunk = a.read_chunk(idx, buf.view(a.dtype))
        return chunk, time.perf_counter() - t0

    def reclaim(block: bool) -> None:
        while held and (block or all(ev.query() for ev in held[0][0])):
            evs, buf = held.pop(0)
            for ev in evs:
                ev.synchronize()
            bufs.give(buf)

    def submit_ahead(k: int) -> None:
        # decodes run ahead of the copies, in order, while buffers last;
        # with none running ahead the landed copies free one
        while len(futures) < min(len(jobs), k + ahead):
            flat, idx = jobs[len(futures)]
            n = arrays[flat].chunk_nbytes
            if not bufs.room(n):
                reclaim(False)
            if not bufs.room(n):
                if len(futures) > k:
                    return
                reclaim(True)
            buf = bufs.take(n)
            futures.append(pool.submit(decode, flat, idx, buf))
            futures[-1].buf = buf

    t_read = time.perf_counter()
    consumed = 0
    try:
        for k in range(len(jobs)):
            submit_ahead(k)
            flat, idx = jobs[k]
            chunk, dec_s = futures[k].result()
            consumed = k + 1
            stats.convert_s += dec_s
            region = arrays[flat].region(idx)
            faults.fire("coldload.h2d")
            copied = {}  # card -> the event after this chunk's last copy on its stream
            for r, m in ranks:
                dest = m.get_parameter(flat)
                start = _rank_box(arrays[flat].shape, specs[flat], mesh, r, tuple(dest.shape))
                cut = _intersect(region, start, tuple(dest.shape))
                if cut is None:
                    continue
                src, dst = chunk[cut[0]], dest[cut[1]]
                if m.device.type == "cuda":
                    with torch.cuda.stream(streams[m.device]):
                        dst.copy_(src, non_blocking=True)
                        ev = copied[m.device] = torch.cuda.Event(enable_timing=True)
                        ev.record(streams[m.device])
                    end_events.append((m.device, ev))
                else:
                    dst.copy_(src)
                stats.bytes_h2d += src.numel() * src.element_size()
            stats.bytes_read += arrays[flat].chunk_nbytes
            held.append((list(copied.values()), futures[k].buf))
            reclaim(False)
        stats.read_s = time.perf_counter() - t_read
    finally:
        # whatever was issued lands, and every decode ends, before the
        # buffers go (also on an error)
        reclaim(True)
        for f in futures[consumed:]:
            try:
                f.result()
            except BaseException:  # noqa: BLE001 — the error that stopped the load is raised
                pass
        # what runs next on each card's stream reads the weights after them
        for d, s in streams.items():
            torch.cuda.current_stream(d).wait_stream(s)
    for d, ev in begun.items():
        ends = [e for dev, e in end_events if dev == d]
        if ends:
            stats.h2d_s = max(stats.h2d_s, ev.elapsed_time(ends[-1]) / 1e3)


@torch.no_grad()
def load_params(
    directory: str,
    target: "Llama | ShardedLlama | LlamaConfig",
    mesh: Optional[Mesh] = None,
    stats_out: Optional[Dict[str, Any]] = None,
    *,
    stats=None,
):
    """Restore ``directory``'s weights.

    ``target`` a model (the engine's; a :class:`ShardedLlama` on a
    ``tp``/``ep`` mesh): written into its parameters in place, each chunk
    straight into its slot (each rank's slice of it); returns the
    :class:`~.hf.LoadStats` (``stats`` when given): ``read_s`` the wall
    of the restore, ``convert_s`` the decode seconds summed over the
    pool, ``h2d_s`` the copies' window on the card, ``bytes_h2d``.

    ``target`` a config: a host tree in the reference's nesting
    (``{"embed": t, "layers": {"wq": t}}``), in the checkpoint's dtype.
    ``mesh`` is the reference's argument; here a sharded target is a
    :class:`ShardedLlama`, whose mesh it must be when given.

    ``stats_out`` (a dict, filled in place, the reference's) gets
    ``restore_s``, ``bytes`` (the restored leaves' bytes) and
    ``digests`` (from the manifest). A checkpoint of another shape, a
    leaf of another shape or dtype, or a missing leaf raises before a
    byte is placed; a file that fails its checks raises."""
    from .hf import LoadStats, place_quantized_leaf

    t0 = time.perf_counter()
    st = stats if stats is not None else LoadStats()
    if isinstance(target, LlamaConfig):
        cfg, model = target, None
    else:
        model, cfg = target, target.cfg
        if mesh is not None and (not isinstance(model, ShardedLlama) or model.mesh is not mesh):
            raise ValueError("mesh must be the target model's own (a ShardedLlama's)")
    quant = set(quantized_names(cfg))
    plain = dataclasses.replace(cfg, quantization="") if quant else cfg
    validate_config(directory, plain)
    directory = os.path.abspath(directory)
    with tracing.span("checkpoint.load", directory=directory) as sp:
        db = ocdbt.Database(os.path.join(directory, PARAMS_DIR))
        shapes = param_shapes(plain)
        arrays: Dict[str, ocdbt.ZarrArray] = {}
        for flat, shape in shapes.items():
            if f"{flat}/.zarray" not in db.entries:
                raise ValueError(f"checkpoint {directory} lacks {flat.replace('.', '/')}")
            a = arrays[flat] = ocdbt.ZarrArray(db, flat)
            if a.shape != tuple(shape) or a.dtype != plain.dtype:
                raise ValueError(f"checkpoint {directory}: {flat.replace('.', '/')} is {a.dtype}{a.shape}, "
                                 f"the model takes {plain.dtype}{tuple(shape)}")
        if model is None:
            tree: Dict[str, Any] = {}
            for flat, a in arrays.items():
                node = tree
                parts = flat.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = a.read()
            out: Any = tree
        else:
            _load_into(arrays, model, [f for f in shapes if f not in quant], st)
            t_q = time.perf_counter()
            for flat in shapes:
                if flat in quant:
                    # bf16 on the host for one leaf, quantized on the card a
                    # layer slice at a time
                    place_quantized_leaf(model, flat, arrays[flat].read())
                    st.bytes_read += math.prod(shapes[flat]) * plain.dtype.itemsize
            if quant:
                st.h2d_s += time.perf_counter() - t_q
            st.workers = zstd.WORKERS
            st.tensors = len(shapes)
            st.streaming = True
            out = st
        st.total_s = time.perf_counter() - t0
        nbytes = sum(math.prod(s) * plain.dtype.itemsize for s in shapes.values())
        sp.set(bytes=nbytes)
    if stats_out is not None:
        stats_out["restore_s"] = st.total_s
        stats_out["bytes"] = nbytes
        stats_out["digests"] = read_manifest(directory)
    st.digests = read_manifest(directory)
    return out


def main(argv=None) -> int:
    """Seed a checkpoint directory (``python -m ...models.checkpoint
    --model llama3-8b --out /ckpts/llama3-8b``): random weights drawn
    with ``--seed`` in the serving layout, on the card unless ``--device
    cpu``; deployments replace this with converted real weights."""
    import argparse

    p = argparse.ArgumentParser(prog="fma-seed-checkpoint")
    p.add_argument("--model", required=True, help="MODEL_CONFIGS key")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..engine.device import resolve_device
    from ..engine.server import MODEL_CONFIGS
    from .llama import init_params

    cfg = MODEL_CONFIGS[args.model]()
    cfg = dataclasses.replace(cfg, quantization="") if quantized_names(cfg) else cfg
    dev = resolve_device(args.device)
    t0 = time.monotonic()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    got = save_params(args.out, cfg, model)
    print(f"wrote {args.model} ({got['bytes'] / 2**30:.2f} GiB) to {args.out} in {time.monotonic() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
