"""Zero-drain actuation: live request state, paged out like weights.

Port of ``llm_d_fast_model_actuation_tpu/engine/parked.py``. Without it an
actuation and the requests it preempts exclude each other: a swap aborts
every queued and running request of the outgoing model. The paged KV
cache makes request state chunkable the way weights are (a request's KV
lives in whole pages, its scheduler state in small per-slot host rows),
so the transactional sleep and swap extend to requests: **park** them
(page the live KV pages to the host, keep the per-slot scheduler rows and
the slot generator's state), keep the bundle beside the slept weights in
the model pool, and **resume** them after the wake or the swap back (page
the KV back in, seat page tables and slots again).

This module holds the data shapes, the two transfers and the wire format;
the park and resume live on :class:`~.engine.InferenceEngine` (it owns
the scheduler state), and the service wires them into its swap and sleep
verbs behind ``--zero-drain`` and into live migration (``engine/server.py``).

The transfers work chunk by chunk (whole pages, never a split page, each
chunk landed before the next is issued), and each chunk fires its fault
point (``kvsave.d2h`` on the page-out, ``kvrestore.h2d`` on the page-in,
``utils/faults.py``) inside its span (``swap.kv_pageout``,
``wake.kv_pagein``). The page-out only reads the pool, so a failed
page-out leaves the engine serving and the caller takes the abort path;
the page-in writes into the pool in place (``index_copy_``), and a failed
one is rolled back by the engine to a clean abort of the parked requests
with the ``state_loss`` cause.

The host copies are page-major, ``[pages, layers, page_size, kv_heads,
head_dim]``: a chunk of pages is one contiguous block of pinned memory,
which its device-to-host copy fills directly. The wire carries the
reference's layout, ``[layers, pages, ...]`` per chunk.

**The wire** (``GET /v1/parked/{model}`` exports, ``POST /v1/parked``
imports) is the reference's JSON document byte for byte: the same keys,
the KV chunks base64 with a sha256 over the same bytes, the dtype as the
numpy name (``"bfloat16"`` for bf16 pages, read and written here with
torch alone). A bundle written by either package decodes in the other.
Each live request carries its slot's generator key: the port's is the
slot generator's state (``torch.Generator.get_state()``, uint8), the
reference's a ``[2]`` uint32 threefry key, and neither stream can be
continued by the other package (:func:`key_kind`). A greedy stream draws
nothing: its key travels as two zero words, the reference's shape, so
either package seats it.
"""

from __future__ import annotations

import base64
import hashlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import faults, tracing
from .chunk_store import NP_NAMES, TORCH_DTYPES

#: chunk bound when the caller passes none: the swap bucket's default
DEFAULT_KV_CHUNK_BYTES = 256 << 20

#: the wire format's version: a mixed-version fleet refuses the handoff
#: instead of seating state it misreads
WIRE_VERSION = 1


class ParkedResumeFailed(RuntimeError):
    """A resume failed mid page-in and was rolled back: no slot was
    seated, every page it allocated was returned, and the engine serves
    with an empty pool. The parked requests' KV is lost: the caller aborts
    them with cause ``state_loss``."""


@dataclass
class ParkedRequest:
    """One request preempted mid-decode: its host Request and the device
    state a bit-exact resume needs."""

    req: Any  #: engine.Request: prompt, emitted tokens, sampling knobs
    #: pool page ids (of the old pool) holding its live KV, page-table
    #: order: the first ``ceil(pos / page_size)`` of its allocation
    old_pages: List[int] = field(default_factory=list)
    #: [vocab] int32 token-count row (the penalties' input); not
    #: recomputable from the Request once a stop sequence was stripped
    counts_row: Optional[np.ndarray] = None
    #: the slot's generator key (:func:`greedy_key` for a greedy stream)
    key_data: Optional[np.ndarray] = None


@dataclass
class ParkedRequests:
    """Everything a preemption displaced, on the host: what the model pool
    counts beside the slept weights and what ``resume_parked`` seats."""

    #: mid-decode requests with live KV
    live: List[ParkedRequest] = field(default_factory=list)
    #: queued requests with no device state (engine Requests), among them
    #: requests demoted mid-prefill: a prefill is a function of the prompt
    #: and draws nothing before its last segment, so running it again
    #: gives the same tokens
    waiting: List[Any] = field(default_factory=list)
    #: unique old-pool page ids in gather order (axis 0 of k/v_host)
    page_ids: List[int] = field(default_factory=list)
    #: the live pages, page-major [len(page_ids), layers, page_size, kvh, hd]
    k_host: Optional[torch.Tensor] = None
    v_host: Optional[torch.Tensor] = None
    kv_nbytes: int = 0
    #: the pool budget's count: KV payload plus the scheduler rows
    nbytes: int = 0
    #: service-owned: seq_id -> the Future of each live and waiting request
    futures: Dict[int, Any] = field(default_factory=dict)
    #: service-owned: the submissions still queued at the service
    pending: List[Any] = field(default_factory=list)
    #: the page-out's copy window (the gather alone, its pinning excluded):
    #: what the ``kvsave.d2h`` bandwidth observes
    pageout_s: float = 0.0
    #: seconds the page-out spent allocating its pinned host copies
    pin_s: float = 0.0

    @property
    def preempted(self) -> int:
        return len(self.live) + len(self.waiting) + len(self.pending)


def page_nbytes(k_pages: torch.Tensor, v_pages: torch.Tensor) -> int:
    """Bytes one page takes across k, v and every layer, from the pool's
    tensors (``[layers, num_pages, page_size, kvh, hd]``)."""
    n = max(1, int(k_pages.shape[1]))
    return (k_pages.numel() * k_pages.element_size() + v_pages.numel() * v_pages.element_size()) // n


def _chunks(n: int, per_chunk: int) -> List[Tuple[int, int]]:
    return [(i, min(n, i + per_chunk)) for i in range(0, n, per_chunk)]


def _span(name: str, parent, pages: int, nbytes: int):
    if parent is None:
        return None
    return tracing.begin(name, parent=parent, activate=False, pages=pages, bytes=nbytes)


def _end(sp, exc: Optional[BaseException] = None) -> None:
    if sp is None:
        return
    if exc is not None:
        sp.set(error=f"{type(exc).__name__}: {exc}")
    sp.end()


def gather_pages_d2h(
    pool: Any,
    page_ids: Sequence[int],
    bucket_bytes: Optional[int] = None,
    span_name: str = "swap.kv_pageout",
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Page the listed pool pages to the host, chunk by chunk: the
    chunk's pages are gathered on the device (``index_select`` over the
    page axis, into a buffer of one chunk), copied to pinned host memory
    on a copy stream, and landed before the next chunk is gathered, so the
    card holds at most one chunk more. Fires ``kvsave.d2h`` per chunk. The
    pool is only read, so a failure leaves the engine serving. Returns the
    page-major host copies and the seconds spent pinning them."""
    k_pages, v_pages = pool.k_pages, pool.v_pages
    ids = list(page_ids)
    per_page = page_nbytes(k_pages, v_pages)
    per_chunk = max(1, int(bucket_bytes or DEFAULT_KV_CHUNK_BYTES) // max(1, per_page))
    layers, _, ps, kvh, hd = k_pages.shape
    dev = k_pages.device
    cuda = dev.type == "cuda"
    t_pin = time.monotonic()
    k_host = torch.empty((len(ids), layers, ps, kvh, hd), dtype=k_pages.dtype, pin_memory=cuda)
    v_host = torch.empty_like(k_host, pin_memory=cuda)
    pin_s = time.monotonic() - t_pin
    parent = tracing.current_context() if tracing.enabled() else None
    copy = torch.cuda.Stream(dev) if cuda else None
    for lo, hi in _chunks(len(ids), per_chunk):
        sp = _span(span_name, parent, hi - lo, (hi - lo) * per_page)
        try:
            faults.fire("kvsave.d2h")
            idx = torch.tensor(ids[lo:hi], dtype=torch.int64).to(dev)
            k_sel = k_pages.index_select(1, idx).transpose(0, 1).contiguous()
            v_sel = v_pages.index_select(1, idx).transpose(0, 1).contiguous()
            if cuda:
                copy.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(copy):
                    k_host[lo:hi].copy_(k_sel, non_blocking=True)
                    v_host[lo:hi].copy_(v_sel, non_blocking=True)
                k_sel.record_stream(copy)
                v_sel.record_stream(copy)
                copy.synchronize()
            else:
                k_host[lo:hi].copy_(k_sel)
                v_host[lo:hi].copy_(v_sel)
            del k_sel, v_sel
        except BaseException as e:
            _end(sp, e)
            raise
        _end(sp)
    return k_host, v_host, pin_s


def scatter_pages_h2d(
    pool: Any,
    pairs: Sequence[Tuple[int, int]],
    k_host: torch.Tensor,
    v_host: torch.Tensor,
    bucket_bytes: Optional[int] = None,
    span_name: str = "wake.kv_pagein",
) -> int:
    """Page parked KV back into the pool: ``pairs`` maps a host page
    (axis 0 of the page-major copies) to a pool page id. Chunk by chunk,
    each chunk copied to the card and written into the pool's own tensors
    in place (``index_copy_`` over the page axis: no new pool, and the
    captured graphs keep reading it) and landed before the next; fires
    ``kvrestore.h2d`` per chunk. Returns the bytes moved. A failure leaves
    the pool valid: partly restored pages are reachable only through page
    tables the caller then never seats."""
    if not pairs:
        return 0
    k_pages, v_pages = pool.k_pages, pool.v_pages
    per_page = page_nbytes(k_pages, v_pages)
    per_chunk = max(1, int(bucket_bytes or DEFAULT_KV_CHUNK_BYTES) // max(1, per_page))
    dev = k_pages.device
    cuda = dev.type == "cuda"
    parent = tracing.current_context() if tracing.enabled() else None
    moved = 0
    for lo, hi in _chunks(len(pairs), per_chunk):
        chunk = list(pairs[lo:hi])
        sp = _span(span_name, parent, len(chunk), len(chunk) * per_page)
        try:
            faults.fire("kvrestore.h2d")
            src = [s for s, _ in chunk]
            dst = torch.tensor([d for _, d in chunk], dtype=torch.int64).to(dev)
            if src == list(range(src[0], src[0] + len(src))):
                kh, vh = k_host[src[0] : src[0] + len(src)], v_host[src[0] : src[0] + len(src)]
            else:
                sel = torch.tensor(src, dtype=torch.int64)
                kh, vh = k_host.index_select(0, sel), v_host.index_select(0, sel)
            kd = kh.to(dev, non_blocking=cuda)
            vd = vh.to(dev, non_blocking=cuda)
            k_pages.index_copy_(1, dst, kd.transpose(0, 1))
            v_pages.index_copy_(1, dst, vd.transpose(0, 1))
            if cuda:
                torch.cuda.current_stream(dev).synchronize()
            moved += kh.numel() * kh.element_size() + vh.numel() * vh.element_size()
            del kd, vd
        except BaseException as e:
            _end(sp, e)
            raise
        _end(sp)
    return moved


# -- generator keys ------------------------------------------------------------


def greedy_key() -> np.ndarray:
    """The key a greedy stream carries: two zero words, the reference's
    ``[2]`` uint32 shape (it is never read)."""
    return np.zeros((2,), dtype=np.uint32)


def key_kind(key: Optional[np.ndarray]) -> str:
    """Whose generator a key continues: ``"torch"`` for the port's (a
    generator state, uint8; or a waiting request's stream seed, one
    uint64), ``"jax"`` for the reference's (a ``[2]`` uint32 threefry
    key), "" for none."""
    if key is None:
        return ""
    a = np.asarray(key)
    if a.dtype == np.uint8 or (a.dtype == np.uint64 and a.shape == (1,)):
        return "torch"
    return "jax"


# -- the wire: the transactional handoff of a parked bundle between
# instances ---------------------------------------------------------------------
#
# One JSON document. The KV is chunked (whole pages, the transfers' bucket
# rule) with a sha256 per chunk: the importer checks every digest before it
# touches the device, so a corrupt or truncated handoff is refused with the
# destination untouched. The scheduler rows and the generator key travel
# per request. The ``identity`` block (the model, its checkpoint and a
# fingerprint over its weight digests) says which weights the bundle may be
# seated onto; the ``fence`` block (added by the exporting service) makes
# the handoff single-use.

#: Request fields that travel verbatim. ``stop_seqs``, ``logit_bias`` and
#: ``out_top_logprobs`` are written out explicitly; pages and slot never
#: travel (the importer's resume maps old pages to new ones). ``variant``
#: is the co-resident variant the request routes to (0: the base); both
#: ends refuse a migration while a variant is attached, so it is 0 in
#: every bundle a service exports, and an importer refuses any other.
_REQ_WIRE_FIELDS = (
    "prompt", "max_new_tokens", "temperature", "top_p",
    "presence_penalty", "frequency_penalty", "want_top_logprobs",
    "want_prompt_logprobs", "seed", "ignore_eos", "out_tokens",
    "out_logprobs", "prompt_logprobs", "pos", "cached_tokens",
    "streamed", "stop_requested", "variant",
)


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"no numpy dtype {name!r} for a small wire array")


def pack_array(a: np.ndarray) -> Dict[str, Any]:
    """One small host array (a counts row, a key) as a JSON-able
    ``{b64, dtype, shape}``."""
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"), "dtype": str(a.dtype), "shape": list(a.shape)}


def unpack_array(d: Dict[str, Any]) -> np.ndarray:
    return (
        np.frombuffer(base64.b64decode(d["b64"]), dtype=_np_dtype(d["dtype"]))
        .reshape(tuple(int(x) for x in d["shape"]))
        .copy()
    )


def weight_fingerprint(digests: Dict[str, str]) -> str:
    """Order-independent sha256 over a model's flat key -> content digest
    map: two engines hold the same weights iff their fingerprints match,
    which is what lets a migrated bundle be seated (KV on other weights
    decodes garbage from valid-looking pages)."""
    h = hashlib.sha256()
    for k in sorted(digests):
        h.update(f"{k}:{digests[k]}\n".encode())
    return h.hexdigest()


def encode_request(req: Any) -> Dict[str, Any]:
    """One engine Request as a JSON-able spec (host state only)."""
    spec = {k: getattr(req, k) if k != "variant" else getattr(req, k, 0) for k in _REQ_WIRE_FIELDS}
    spec["seq_id"] = int(req.seq_id)
    spec["stop_seqs"] = [list(s) for s in req.stop_seqs]
    spec["logit_bias"] = {str(t): float(v) for t, v in req.logit_bias.items()}
    spec["out_top_logprobs"] = [[[int(t), float(v)] for t, v in alts] for alts in req.out_top_logprobs]
    if getattr(req, "trace", None) is not None:
        # the origin's trace: the destination's request spans parent on
        # the source's lifecycle root, one trace id over both cards
        ctx = req.trace.context()
        spec["trace"] = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    return spec


def decode_request(spec: Dict[str, Any], request_cls: Any) -> Any:
    """Rebuild an engine Request from its spec. Its seq_id is the
    exporter's: the importing service gives it one of its own before
    seating it (two engines' ids are unrelated)."""
    req = request_cls(
        seq_id=int(spec["seq_id"]),
        prompt=[int(t) for t in spec["prompt"]],
        max_new_tokens=int(spec["max_new_tokens"]),
        temperature=float(spec["temperature"]),
    )
    req.top_p = float(spec["top_p"])
    req.presence_penalty = float(spec["presence_penalty"])
    req.frequency_penalty = float(spec["frequency_penalty"])
    req.want_top_logprobs = bool(spec["want_top_logprobs"])
    req.want_prompt_logprobs = bool(spec["want_prompt_logprobs"])
    req.seed = None if spec["seed"] is None else int(spec["seed"])
    req.ignore_eos = bool(spec["ignore_eos"])
    req.out_tokens = [int(t) for t in spec["out_tokens"]]
    req.out_logprobs = [float(v) for v in spec["out_logprobs"]]
    req.prompt_logprobs = [None if v is None else float(v) for v in spec["prompt_logprobs"]]
    req.pos = int(spec["pos"])
    req.cached_tokens = int(spec["cached_tokens"])
    req.streamed = int(spec["streamed"])
    req.stop_requested = bool(spec["stop_requested"])
    req.variant = int(spec.get("variant", 0) or 0)
    req.stop_seqs = tuple(tuple(int(t) for t in s) for s in spec["stop_seqs"])
    req.logit_bias = {int(t): float(v) for t, v in spec["logit_bias"].items()}
    req.out_top_logprobs = [[(int(t), float(v)) for t, v in alts] for alts in spec["out_top_logprobs"]]
    tr = spec.get("trace")
    if isinstance(tr, dict) and tr.get("trace_id"):
        req.trace_parent = {"trace_id": str(tr["trace_id"]), "span_id": str(tr.get("span_id", ""))}
    return req


def _wire_bytes(pages: torch.Tensor) -> np.ndarray:
    """A page-major block as the wire's ``[layers, pages, ...]`` bytes."""
    t = pages.transpose(0, 1).contiguous()
    return t.view(-1).view(torch.uint8).numpy()


def encode_wire(
    bundle: ParkedRequests,
    identity: Dict[str, Any],
    chunk_bytes: Optional[int] = None,
) -> Dict[str, Any]:
    """Serialize a parked bundle for the wire. ``identity`` is the
    exporting service's identity block; the caller adds the fence and the
    service's own lists (the queued submissions, the stream seeds of
    unseeded waiting requests)."""
    chunks: List[Dict[str, Any]] = []
    kv: Dict[str, Any] = {"page_ids": [int(p) for p in bundle.page_ids], "nbytes": int(bundle.kv_nbytes),
                          "chunks": chunks}
    if bundle.page_ids:
        k_host, v_host = bundle.k_host, bundle.v_host
        n = len(bundle.page_ids)
        kv["dtype"] = NP_NAMES[k_host.dtype]
        kv["shape"] = [int(k_host.shape[1]), n, *(int(s) for s in k_host.shape[2:])]
        per_page = (k_host.numel() * k_host.element_size() + v_host.numel() * v_host.element_size()) // n
        per_chunk = max(1, int(chunk_bytes or DEFAULT_KV_CHUNK_BYTES) // max(1, per_page))
        for lo, hi in _chunks(n, per_chunk):
            kb, vb = _wire_bytes(k_host[lo:hi]), _wire_bytes(v_host[lo:hi])
            h = hashlib.sha256(kb)
            h.update(vb)
            chunks.append({
                "lo": lo,
                "hi": hi,
                "k": base64.b64encode(kb).decode("ascii"),
                "v": base64.b64encode(vb).decode("ascii"),
                "sha256": h.hexdigest(),
            })
    live = []
    for pr in bundle.live:
        spec = encode_request(pr.req)
        spec["old_pages"] = [int(p) for p in pr.old_pages]
        spec["counts_row"] = pack_array(pr.counts_row)
        spec["key_data"] = pack_array(pr.key_data)
        live.append(spec)
    return {
        "version": WIRE_VERSION,
        "identity": dict(identity),
        "kv": kv,
        "requests": {"live": live, "waiting": [encode_request(r) for r in bundle.waiting], "pending": []},
        "pageout_s": float(bundle.pageout_s),
        "nbytes": int(bundle.nbytes),
    }


def decode_wire(
    doc: Dict[str, Any], request_cls: Any, pin: bool = False
) -> Tuple[ParkedRequests, List[Dict[str, Any]]]:
    """Rebuild a parked bundle from a wire document, checking every KV
    chunk's digest before it returns: the caller touches no device state
    until this succeeds, so a bad handoff leaves the importer clean.
    Raises ValueError on any mismatch. ``pin``: the host copies in pinned
    memory (the page-in then copies asynchronously). Returns ``(bundle,
    pending_specs)``: the queued submissions are the service's to
    rebuild."""
    if int(doc.get("version", -1)) != WIRE_VERSION:
        raise ValueError(f"parked wire version {doc.get('version')!r} != {WIRE_VERSION}")
    kv = doc["kv"]
    page_ids = [int(p) for p in kv["page_ids"]]
    k_host = v_host = None
    if page_ids:
        dtype = TORCH_DTYPES.get(kv["dtype"])
        if dtype is None:
            raise ValueError(f"unknown KV dtype {kv['dtype']!r}")
        shape = tuple(int(x) for x in kv["shape"])
        if len(shape) != 5 or shape[1] != len(page_ids):
            raise ValueError("KV shape does not match the page list")
        layers, _, ps, kvh, hd = shape
        k_host = torch.empty((len(page_ids), layers, ps, kvh, hd), dtype=dtype, pin_memory=pin)
        v_host = torch.empty_like(k_host, pin_memory=pin)
        covered = 0
        for ch in kv["chunks"]:
            lo, hi = int(ch["lo"]), int(ch["hi"])
            kb, vb = base64.b64decode(ch["k"]), base64.b64decode(ch["v"])
            h = hashlib.sha256(kb)
            h.update(vb)
            if h.hexdigest() != ch["sha256"]:
                raise ValueError(f"KV chunk [{lo}:{hi}] content digest mismatch")
            if not 0 <= lo < hi <= len(page_ids):
                raise ValueError(f"KV chunk [{lo}:{hi}] outside the page list")
            sub = (layers, hi - lo, ps, kvh, hd)
            want = (hi - lo) * layers * ps * kvh * hd * dtype.itemsize
            if len(kb) != want or len(vb) != want:
                raise ValueError(f"KV chunk [{lo}:{hi}] holds {len(kb)} bytes, want {want}")
            with warnings.catch_warnings():
                # the decoded bytes are read-only and only read here
                warnings.simplefilter("ignore", UserWarning)
                k_host[lo:hi].copy_(torch.frombuffer(kb, dtype=dtype).view(sub).transpose(0, 1))
                v_host[lo:hi].copy_(torch.frombuffer(vb, dtype=dtype).view(sub).transpose(0, 1))
            covered += hi - lo
        if covered != len(page_ids):
            raise ValueError("KV chunks do not cover the page list")
    bundle = ParkedRequests(
        page_ids=page_ids, k_host=k_host, v_host=v_host, kv_nbytes=int(kv.get("nbytes", 0)),
        nbytes=int(doc.get("nbytes", 0)), pageout_s=float(doc.get("pageout_s", 0.0)),
    )
    reqs = doc["requests"]
    for spec in reqs["live"]:
        bundle.live.append(ParkedRequest(
            req=decode_request(spec, request_cls),
            old_pages=[int(p) for p in spec["old_pages"]],
            counts_row=unpack_array(spec["counts_row"]),
            key_data=unpack_array(spec["key_data"]),
        ))
    for spec in reqs["waiting"]:
        req = decode_request(spec, request_cls)
        if spec.get("rng_key_data") is not None:
            # an unseeded request: the exporter pinned the stream its own
            # engine would have drawn from (engine seed, seq_id); the
            # importer's ids differ
            req.rng_key_data = unpack_array(spec["rng_key_data"])
        bundle.waiting.append(req)
    return bundle, list(reqs.get("pending", ()))
