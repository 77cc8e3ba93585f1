"""The serving engine: continuous batching over a paged KV cache.

Port of ``llm_d_fast_model_actuation_tpu/engine/engine.py``: the bucketed
and the token-packed serving paths. One engine owns the model, the page
pool and three kinds of work:

  * prefill (bucketed path) — batch-1 prompt ingestion, padded to
    power-of-two buckets, sampling the first token on the device
    (prefix-cache hits and chunked prefill run the suffix through
    ``prefill_continue``);
  * the packed step (``packed_serving``) — whenever prompt work is
    pending, ONE forward over a flat ``[token_budget]`` buffer carries
    prefill segments of many requests and one decode row per running
    sequence (``llama.mixed_step``, ragged paged attention), then the
    step falls through to the decode chunk; the buffer is always packed
    at ``RAGGED_BLOCK`` alignment, the ragged kernel's layout, on the CPU
    too;
  * the decode chunk — up to ``decode_chunk`` decode+sample steps for the
    whole slot batch (:meth:`InferenceEngine.chunk_body`), whose state
    (last tokens, positions, budgets, token counts) stays on the device;
    the host reads back one ``[T, b]`` token block per chunk. On one CUDA
    device every chunk replays a CUDA graph captured when the engine
    starts (``engine/graphs.py``, the port of the reference's
    ``ProgramSet.chunk``); on the CPU and on a mesh the same function runs
    eagerly (:meth:`InferenceEngine.chunk_eager`).

Decode runs every slot every step (static shapes; empty slots write
nothing and their outputs are ignored). Host mirrors of the scheduler
state are the source of truth between chunks and are uploaded in full
after an admission, retire or packed-step edge (the reference's cheaper
per-slot upload tier is not ported). A packed admission needs only the
page table uploaded: the ``[b, vocab]`` count and bias rows of a free
slot are already zero on the device, because its retire was uploaded in
full. (The reference zeroes them in the mixed program, ``fresh_on``,
because its retires leave them stale.)

Every device tensor a chunk reads or writes is allocated once, in the
engine's arenas (``engine/arena.py``), and only ever written in place:
the weights, the page pool, the RoPE tables, the scheduler buffers (an
upload copies the host mirrors into them) and the ``[T, b, w]`` Gumbel
noise buffer, which the host fills from the per-slot generators before
a sampled chunk runs (:meth:`InferenceEngine._draw_chunk_noise`). A
sleep releases their memory and a wake maps it back at the same
addresses, so the captured graphs replay unchanged after a wake.

Tensor parallelism: ``InferenceEngine(cfg, mesh=...)`` (a
``parallel/mesh.py:TpMesh``) builds the model and the page pool sharded
over the mesh's ranks and drives all of them from this one process, one
scheduler and one engine object, as the reference's single-process mesh
does. The scheduler state is REPLICATED: what the forwards read (page
table, tokens, positions) is uploaded once per distinct device of the
mesh, everything else (counts, bias, sampling knobs) lives on rank 0's
device, where the gathered logits are sampled.

Zero-drain parking (:meth:`InferenceEngine.park_requests`,
:meth:`InferenceEngine.resume_parked`, ``engine/parked.py``): the running
and queued requests go to a host bundle, the KV pool's memory goes back to
the card at addresses the arena keeps, and the bundle is seated again
bit-exact after a wake, a swap back, or in another engine of the same
weights (live migration, ``engine/server.py``).

Co-resident sibling variants (:meth:`InferenceEngine.attach_variant`):
a sibling fine-tune's changed leaves live in the arena beside the base's
weights (tag ``variant``), and a request routed to it (``variant=``)
shares the packed step and the decode chunk with the base's. A step or
chunk with a routed row runs one pass per resident that has a row in it
(``llama.VariantView``: the delta leaves over the base's own tensors),
each with the other residents' rows masked (a packed row's slot -1, a
chunk slot inactive), merges the logits row by row and samples once.
Those steps run eagerly; base-only traffic keeps the plain step and the
captured chunk graphs.

Not ported yet, and refused rather than ignored (they are not fields of
the port's ``EngineConfig``): speculative decoding, pipelined decode and
multi-host lockstep.
CUDA graphs for the prefill buckets and the packed step, and for the
chunk on a mesh (a graph belongs to one device), are later work.

The build (:meth:`InferenceEngine._build`): every arena is mapped, the
weights are written, then the chunk's graphs are captured and any
``warmup_buckets`` prefill is run once (``engine/exec_pool.py:warm_up``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..models import llama
from ..models.registry import fill_params_for
from ..ops.attention import RAGGED_BLOCK, resolve_ragged_impl
from ..utils import tracing
from .arena import Arena
from .device import resolve_device
from .kv_cache import OutOfPages, PageAllocator, PagePool
from .sampling import gumbel, noise_width, sample


@dataclass(frozen=True)
class EngineConfig:
    model: llama.LlamaConfig
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 2048
    max_seq_len: int = 0  # 0 -> model.max_seq_len
    eos_token_id: int = -1  # -1 = never stop on EOS
    #: additional stopping ids (Llama-3-Instruct declares [eos, eom, eot])
    extra_eos_ids: tuple = ()
    #: top-k alternative logprobs computed per emitted token on the device
    #: (OpenAI `logprobs`/`top_logprobs`); 0 disables them
    logprobs_topk: int = 5
    #: max decode steps run per chunk before the host reads tokens back
    decode_chunk: int = 8
    #: automatic prefix caching (engine/prefix_cache.py): page-aligned KV
    #: reuse across requests sharing a prompt prefix; outputs are the same
    #: with it on or off
    prefix_caching: bool = True
    #: chunked prefill: prompts longer than this prefill in segments of at
    #: most this many tokens. 0 = off.
    max_prefill_tokens: int = 0
    #: "auto", "reference", "grouped" or "pallas"; overrides the model's
    #: ``attention_impl``. "reference" takes the scatter-first decode
    #: branch, every other value the inline one ("auto" resolves to
    #: "grouped"). The kernels are picked by device either way.
    attention_impl: str = "auto"
    #: token-packed mixed-batch serving: whenever prompt work is pending,
    #: one forward over a flat [token_budget] buffer packs prefill
    #: segments AND one decode row per running sequence, then the step
    #: falls through to the decode chunk; the bucketed prefill is off
    #: this path. Off (default) keeps the bucketed path as it was.
    packed_serving: bool = False
    #: row capacity of the packed buffer; 0 = auto (256, floored so every
    #: slot can decode and one prefill block always fits)
    token_budget: int = 0

    @property
    def seq_len(self) -> int:
        return self.max_seq_len or self.model.max_seq_len

    @property
    def pages_per_seq(self) -> int:
        return -(-self.seq_len // self.page_size)

    @property
    def packed_token_budget(self) -> int:
        """The resolved [token_budget] buffer size: requested (or 256),
        floored so every slot can decode AND one prefill block always
        fits, rounded up to RAGGED_BLOCK alignment."""
        qb = RAGGED_BLOCK
        want = max(self.token_budget or 256, qb * (self.max_batch + 1))
        return -(-want // qb) * qb


ATTENTION_IMPLS = ("auto", "reference", "grouped", "pallas")


def resolve_attention_impl(impl: str) -> str:
    """The model's ``attention_impl`` for an engine flag: "auto" is the
    inline branch ("grouped", the reference's choice off the TPU)."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {ATTENTION_IMPLS}")
    return "grouped" if impl == "auto" else impl


def packed_budget_shapes(cfg: EngineConfig) -> List[int]:
    """The one or two [token_budget] buffer shapes of a packed engine,
    smallest first: the full budget, preceded by a quarter-size buffer
    (when it differs) so a lightly loaded step neither computes nor
    pad-counts the full budget."""
    qb = RAGGED_BLOCK
    full = cfg.packed_token_budget
    small = -(-max(full // 4, qb * (cfg.max_batch + 1)) // qb) * qb
    return [small, full] if small < full else [full]


def kv_pages_bucket(max_kv: int, page_size: int, pages_per_seq: int) -> int:
    """Page-table width covering ``max_kv`` cache entries, rounded up the
    {1, 2, 3, 4, 6, 8, 12, ...} ladder (powers of two and their 1.5x
    midpoints), clamped to the full table. The packed step hands the
    model the table's first this-many columns; the rest are masked for
    every row."""
    need = max(1, -(-max_kv // page_size))
    k = 1
    while k < need:
        if k * 3 // 2 >= need and k * 3 % 2 == 0:
            k = k * 3 // 2
            break
        k *= 2
    return min(k, pages_per_seq)


def prefill_bucket(n: int, seq_len: int) -> int:
    """Power-of-two prefill shape bucket (floor 16) clamped to seq_len."""
    b = 16
    while b < n:
        b *= 2
    return min(b, seq_len)


@dataclass
class Request:
    seq_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    out_logprobs: List[float] = field(default_factory=list)
    #: per emitted token: [(token_id, logprob), ...] top-k alternatives of
    #: the raw distribution (filled only when `want_top_logprobs`)
    out_top_logprobs: List[list] = field(default_factory=list)
    want_top_logprobs: bool = False
    #: OpenAI ``echo`` + ``logprobs``: the logprob of every PROMPT token
    #: under the model (the first entry None: nothing precedes it).
    #: Requesting it bypasses the prefix cache, whose pages skip exactly
    #: the forward that gives these numbers
    want_prompt_logprobs: bool = False
    prompt_logprobs: List[Optional[float]] = field(default_factory=list)
    #: per-request RNG seed: with it, a sampled request's output depends
    #: only on (seed, params, prompt, sampling knobs), not on its batch
    #: neighbours. None = a stream derived from the engine seed and seq_id.
    seed: Optional[int] = None
    #: OpenAI `logit_bias`: token_id -> additive bias in [-100, 100]
    logit_bias: Dict[int, float] = field(default_factory=dict)
    #: vLLM `ignore_eos`: decode the full budget even past eos
    ignore_eos: bool = False
    #: nucleus sampling threshold; >= 1.0 = full distribution
    top_p: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    #: stop sequences (token tuples); on match the request finishes and
    #: the matched sequence is stripped from the output (OpenAI semantics)
    stop_seqs: tuple = ()
    pages: List[int] = field(default_factory=list)
    pos: int = 0  # tokens in cache
    slot: int = -1
    #: prompt tokens served from the prefix cache (0 = full prefill)
    cached_tokens: int = 0
    #: how many of `pages` are shared prefix pages (for registration)
    shared_pages: int = 0
    #: packed serving: admitted, prompt not fully in the cache yet (``pos``
    #: counts the prompt tokens that are)
    prefilling: bool = False
    done: bool = False
    #: why the request finished: "length" | "stop" (eos or stop sequence)
    finish_reason: str = ""
    error: Optional[str] = None
    submit_time: float = field(default_factory=time.monotonic)
    first_sched_time: Optional[float] = None
    first_token_time: Optional[float] = None
    #: stamped by the serving loop when the finished request leaves
    done_time: Optional[float] = None
    #: streaming hook: on_token(req, token) for every emitted token, on
    #: the engine thread; tokens that may start a stop sequence are held
    #: back until disambiguated
    on_token: Optional[Callable[["Request", int], None]] = None
    #: tokens already delivered to on_token (stop-prefix holdback cursor)
    streamed: int = 0
    #: external early-stop request: finish at the next emitted token
    stop_requested: bool = False
    #: the request's lifecycle trace collector (``tracing.RequestTrace``)
    #: or None, the ``--trace-requests 0`` default: every hook is then one
    #: ``is None`` check
    trace: Optional[Any] = None
    #: stamped when the trace is finished (the usage block reports it)
    trace_id: str = ""
    #: a migrated-in request's origin trace context ({trace_id, span_id}):
    #: its spans here join the source's trace
    trace_parent: Optional[Dict[str, str]] = None
    #: an unseeded request migrated in while waiting: the stream seed the
    #: exporting engine would have drawn from (``parked.key_kind``)
    rng_key_data: Optional[Any] = None
    #: seconds spent parked by zero-drain actuations, and the part of them
    #: before the first token (the exemplars' ``preempt`` leg)
    preempt_s: float = 0.0
    preempt_pre_token_s: float = 0.0
    #: the co-resident variant whose weights serve this request
    #: (:meth:`InferenceEngine.attach_variant`'s handle); 0 is the base.
    #: Routed requests need packed serving and skip the prefix cache
    variant: int = 0


def validate_logit_bias(lb, vocab_size: int) -> "Dict[int, float] | None":
    """OpenAI logit_bias validation: token ids in-vocab, values in
    [-100, 100]. Returns a normalized {int: float} dict."""
    if lb is None:
        return None
    if not isinstance(lb, dict):
        raise ValueError("logit_bias must be an object")
    out: Dict[int, float] = {}
    for k, v in lb.items():
        try:
            t = int(k)
            fv = float(v)
        except (TypeError, ValueError):
            raise ValueError(f"invalid logit_bias entry {k!r}: {v!r}")
        if not (0 <= t < vocab_size):
            raise ValueError(f"logit_bias token {t} outside vocab")
        if not (-100.0 <= fv <= 100.0):
            raise ValueError(f"logit_bias value {fv} outside [-100, 100]")
        out[t] = fv
    return out


def _stop_holdback(out: List[int], stop_seqs) -> int:
    """Length of the longest suffix of `out` that is a PROPER prefix of
    any stop sequence — tokens that must not be streamed yet."""
    best = 0
    for seq in stop_seqs:
        m = min(len(seq) - 1, len(out))
        for k in range(m, best, -1):
            if tuple(out[-k:]) == tuple(seq[:k]):
                best = k
                break
    return best


def _stream_seed(engine_seed: int, seq_id: int) -> int:
    """The generator seed of an unseeded request: a function of the
    engine seed and the request id only."""
    h = hashlib.sha256(f"{engine_seed + 1}:{seq_id}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


class EngineAsleep(RuntimeError):
    """The engine's device state is offloaded; wake_up() before serving."""


class InferenceEngine:
    """Continuous-batching engine on one device, or on a tensor-parallel
    mesh of them.

    ``params``: None (random init from ``seed``, drawn on the device), a
    :class:`~..models.llama.Llama` already on the device, or a state dict
    (``models/convert.py:params_from_jax``); with a ``mesh`` a
    :class:`~..models.llama.ShardedLlama` on it or its state dict
    (``params_from_jax(..., mesh=)``). Either is copied into the engine's
    arenas: a model passed in stays the caller's, and its weights are held
    twice until the caller drops it. Or a loader: a callable that writes
    the weights into the engine's own model in place (``load(model)``,
    e.g. ``models/hf.py:load_params`` of a checkpoint directory), called
    once before the chunk's graphs are captured — nothing is drawn first
    — and again by a level-2 wake (:meth:`reload_params`).
    ``warmup_buckets``: prefill buckets the build runs once after the
    load (``--warmup-buckets``). ``device``: None means the card
    and raises without one; the CPU must be asked for. ``mesh``
    (``parallel/mesh.py:serving_mesh``) names the ranks' devices itself:
    rank 0's is the engine's ``device``."""

    def __init__(
        self,
        cfg: EngineConfig,
        params: "llama.Llama | llama.ShardedLlama | Dict[str, torch.Tensor] | Callable | None" = None,
        seed: int = 0,
        device: "torch.device | str | None" = None,
        mesh=None,
        warmup_buckets: Seq[int] = (),
    ) -> None:
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                dev, rank0 = torch.device(device), mesh.devices[0]
                if dev.type != rank0.type or dev.index not in (None, rank0.index):
                    raise ValueError(f"device {device} is not rank 0 of {mesh}; leave it out with a mesh")
            for d in mesh.distinct_devices():
                resolve_device(d)
            device = mesh.devices[0]
        self.device = resolve_device(device)
        #: devices beyond the first that every replicated upload also goes to
        self._extra_devices = len(mesh.distinct_devices()) - 1 if mesh is not None else 0
        if cfg.token_budget < 0:
            raise ValueError("token_budget must be >= 0, or 0 for auto")
        self.cfg = cfg
        # the engine's attention_impl overrides the model's (per engine,
        # as in the reference)
        m = cfg.model
        impl = resolve_attention_impl(cfg.attention_impl)
        if m.attention_impl != impl:
            m = dataclasses.replace(m, attention_impl=impl)
        #: the model config this engine runs (``cfg.model`` with the
        #: resolved ``attention_impl``)
        self.model_cfg = m
        self._seed = seed
        #: what the packed step's attention runs as: "ragged", or on a
        #: mesh "ragged_sharded" (the kernel once per rank)
        self.mixed_impl = resolve_ragged_impl(impl, mesh)
        for d in [self.device] if mesh is None else mesh.distinct_devices():
            if d.type == "cuda":
                # build this checkout's kernels (if needed) and launch the
                # probe once per device; raises if the card cannot run them
                from ..ops.cuda.build import check_launch

                check_launch(d)
        #: the engine's state on each of its devices, at stable addresses
        self.arenas: Dict[torch.device, Arena] = {
            d: Arena(d) for d in ([self.device] if mesh is None else mesh.distinct_devices())
        }
        self.model = (
            llama.Llama(m, self.device, arena=self.arenas[self.device]) if mesh is None
            else llama.ShardedLlama(m, mesh, arenas=self.arenas)
        )
        self.pool = PagePool.create(
            m.num_layers, cfg.num_pages, cfg.page_size, m.num_kv_heads,
            m.head_dim, dtype=m.dtype, device=self.device, mesh=mesh, arenas=self.arenas,
        )
        self.allocator = PageAllocator(cfg.num_pages)
        if cfg.prefix_caching:
            from .prefix_cache import PrefixCache

            self.prefix_cache: Optional[Any] = PrefixCache(cfg.page_size)
        else:
            self.prefix_cache = None
        b, p = cfg.max_batch, cfg.pages_per_seq
        vocab = m.vocab_size
        # Host mirrors of the device scheduler state (source of truth between
        # chunks; re-uploaded only after an admission/retire/prefill edge).
        self._page_table = np.zeros((b, p), dtype=np.int32)
        self._positions = np.zeros((b,), dtype=np.int32)
        self._last_tokens = np.zeros((b,), dtype=np.int32)
        self._temps = np.zeros((b,), dtype=np.float32)
        self._topps = np.ones((b,), dtype=np.float32)
        self._pres = np.zeros((b,), dtype=np.float32)
        self._freqs = np.zeros((b,), dtype=np.float32)
        #: per-slot token counts over prompt + generated (penalties input)
        self._token_counts = np.zeros((b, vocab), dtype=np.int32)
        self._budgets = np.zeros((b,), dtype=np.int32)
        #: per-slot eos sensitivity (0 = ignore_eos request)
        self._eos_on = np.ones((b,), dtype=np.int32)
        #: per-slot additive logit bias [b, vocab]
        self._bias = np.zeros((b, vocab), dtype=np.float32)
        self._slots: List[Optional[Request]] = [None] * b
        #: per-slot sampling generators on the device, seeded at admission:
        #: one draw per emitted token of a sampled request, so its stream
        #: depends on its own progress only
        self._gens: List[Optional[torch.Generator]] = [None] * b
        self._waiting: List[Request] = []
        self._next_seq_id = 1
        #: model forwards run (observability: each decode step launches the
        #: decode kernel once per layer, each cold prefill the prefill kernel)
        self.decode_steps = 0
        self.cold_prefills = 0
        #: packed steps dispatched, and the valid tokens they carried
        self.packed_steps = 0
        self.packed_tokens_total = 0
        #: host-to-device bytes of dispatch inputs and scheduler uploads,
        #: by serving path ("packed" / "bucketed")
        self.step_h2d_bytes: Dict[str, int] = {"packed": 0, "bucketed": 0}
        #: bytes of computed-but-invalid activation rows (one embedding row
        #: each): prefill bucket padding ("bucketed"), padded rows of the
        #: packed buffer ("packed")
        self.pad_waste_bytes: Dict[str, int] = {"packed": 0, "bucketed": 0}
        #: valid prompt/decode tokens dispatched by those two paths
        self.dispatch_tokens: Dict[str, int] = {"packed": 0, "bucketed": 0}
        self._pad_token_bytes = m.hidden_size * m.dtype.itemsize
        #: stats of the most recent step's packed dispatch (None when the
        #: step dispatched none)
        self.last_step_stats: Optional[Dict[str, Any]] = None
        #: the device scheduler tensors (static: written in place only)
        self._dev: Dict[str, Any] = self._alloc_sched()
        #: the device copies of the host mirrors are stale
        self._dirty = True
        #: True while a SleepManager holds the state offloaded (engine/sleep.py)
        self.asleep = False
        #: zero-drain actuation (engine/parked.py): True while a park has
        #: released the KV pool's memory (its addresses kept); the sleeper's
        #: state then leaves the pool out, and the state's return rebuilds it
        #: (:meth:`rebuild_kv_pool`)
        self.kv_detached = False
        #: set by the service when --zero-drain applies to this engine: a
        #: pricing peek at the sleeper's state then leaves the pool out, as
        #: the park that precedes the offload will
        self.zero_drain_park = False
        #: decode chunks the serving path ran, and the CUDA graphs captured
        #: and replayed for them (engine/graphs.py)
        self.decode_chunks = 0
        #: decode steps the serving path's chunks ran, replayed or eager
        self.chunk_steps = 0
        self.graph_captures = 0
        self.graph_replays = 0
        #: seconds the engine's start spent capturing its chunk graphs
        self.capture_s = 0.0
        #: the captured chunks (``engine/graphs.py:ChunkGraphs``) on one
        #: CUDA device; None on the CPU and on a mesh, where chunks run eagerly
        self.graphs = None
        if mesh is None and self.device.type == "cuda":
            from .graphs import ChunkGraphs

            self.graphs = ChunkGraphs(self)
        #: co-resident sibling variants: handle -> {"delta": {flat key:
        #: arena tensor}, "view": llama.VariantView, "nbytes", "label"}.
        #: Handle 0 is the base and never appears here; a handle is stable
        #: while its variant is attached (requests and the service hold it)
        self._variants: Dict[int, Dict[str, Any]] = {}
        #: the multi-variant passes' order: ``_variant_order[v - 1]`` is the
        #: handle of pass v (the base is pass 0)
        self._variant_order: List[int] = []
        self._next_variant_handle = 1
        self.variant_attaches = 0
        self.variant_detaches = 0
        #: packed forwards run (one per plain packed step, one per pass of a
        #: multi-variant step) and decode chunks run as multi-variant twins
        self.packed_passes = 0
        self.variant_steps = 0
        self.variant_chunks = 0
        #: decode steps those twins ran, and their forwards (T per pass)
        self.variant_chunk_steps = 0
        self.variant_decode_forwards = 0
        #: the loader the weights came from, when they came from one
        self._load: Optional[Callable[[Any], Any]] = (
            params if callable(params) and not isinstance(params, torch.nn.Module) else None
        )
        if isinstance(params, (llama.Llama, llama.ShardedLlama)):
            if isinstance(params, llama.ShardedLlama) != (mesh is not None) or (
                mesh is not None and params.mesh.devices != mesh.devices
            ):
                raise ValueError("the model's mesh differs from the engine's")
            if params.device != self.device:
                raise ValueError(f"model is on {params.device}, engine on {self.device}")
            if dataclasses.replace(params.cfg, attention_impl=impl) != m:
                raise ValueError("the model's config differs from the engine's")
            params = params.state_dict()
        self._build(params, warmup_buckets)

    def _build(self, params, warmup_buckets: Seq[int]) -> None:
        """Write the weights, then warm up on this thread
        (``engine/exec_pool.py:warm_up``: the chunk's graphs on one card,
        then the prefill buckets)."""
        from .exec_pool import warm_up

        t0 = time.monotonic()
        self._write_params(params)
        load_s = time.monotonic() - t0
        #: the warm-up's figures, and the seconds the weights took before it
        self.warmup_stats = dict(warm_up(self, warmup_buckets), load_s=load_s)
        self.capture_s = self.warmup_stats["capture_s"]

    def _write_params(self, params) -> None:
        if params is None or self._load is not None:
            self.reload_params()
        else:
            self.model.load_state_dict(params, strict=True)

    @torch.no_grad()
    def warm_prefill(self, bucket: int) -> None:
        """One bucketed prefill of ``bucket`` tokens whose page table is
        all the null page: it loads what a prefill at that bucket runs,
        writes only the null page, and its logits are thrown away (the
        warm-up's, ``--warmup-buckets``)."""
        llama.prefill(
            self.model,
            self._to_ranks(np.zeros((1, bucket), dtype=np.int32)),
            self._to_ranks(np.array([bucket], dtype=np.int32)),
            self.pool.as_tuple(),
            self._to_ranks(np.zeros((1, self.cfg.pages_per_seq), dtype=np.int32)),
        )

    def recapture(self) -> float:
        """Capture the chunk's graphs again after they were released (a
        pooled engine over the exec pool's budget, serving again): the
        scheduler state uploaded first, every slot inactive, so the
        warm-ups write only the null page. Returns the seconds."""
        if self.graphs is None or self.graphs.captured:
            return 0.0
        self._upload_sched()
        self.capture_s = self.graphs.capture()
        return self.capture_s

    def reload_params(self) -> None:
        """Write the model's parameters into its live tensors, in place (at
        start, and at a level-2 wake): through the engine's loader when it
        was given one, else drawn from the engine seed (on a mesh the same
        numbers, sliced per rank)."""
        if self._load is not None:
            self._load(self.model)
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed)
        fill_params_for(self.model, gen)

    # -- device scheduler state ---------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU a plain .to() would alias the host
        # mirror, and the chunk updates its device state in place
        return torch.from_numpy(a).to(self.device, copy=True)

    def _to_ranks(self, a: np.ndarray):
        """A host array as a REPLICATED input of the model's forwards: on
        a mesh one upload per distinct device, handed out per rank (ranks
        on one device share the tensor); without one, the tensor."""
        if self.mesh is None:
            return self._to_dev(a)
        copies = {d: torch.from_numpy(a).to(d, copy=True) for d in self.mesh.distinct_devices()}
        return [copies[d] for d in self.mesh.devices]

    def _table(self, cols: Optional[int] = None):
        """The device page table as the forwards take it, optionally cut
        to its first ``cols`` columns."""
        pt = self._dev["pt"]
        if cols is None:
            return pt
        return pt[:, :cols] if self.mesh is None else [p[:, :cols] for p in pt]

    def _mirrors(self) -> Dict[str, np.ndarray]:
        """The host mirror of each device scheduler tensor but the page
        table."""
        return {
            "lt": self._last_tokens,
            "pos": self._positions,
            "budget": self._budgets,
            "temps": self._temps,
            "topp": self._topps,
            "counts": self._token_counts,
            "pres": self._pres,
            "freq": self._freqs,
            "eos_on": self._eos_on,
            "bias": self._bias,
        }

    def _alloc_sched(self) -> Dict[str, Any]:
        """The device scheduler tensors, allocated once in the arena (tag
        ``discard``: a wake rewrites them from the mirrors) and zero: the
        mirrors' shapes and types, the page table once per distinct device
        of a mesh (handed out per rank), and the ``[decode_chunk, b,
        noise_width]`` Gumbel noise buffer of a chunk."""
        arena = self.arenas[self.device]
        dev: Dict[str, Any] = {
            k: arena.zeros(a.shape, torch.from_numpy(a).dtype, "discard", k) for k, a in self._mirrors().items()
        }
        pt = self._page_table
        if self.mesh is None:
            self._pt_bufs = [arena.zeros(pt.shape, torch.int32, "discard", "pt")]
            dev["pt"] = self._pt_bufs[0]
        else:
            bufs = {d: self.arenas[d].zeros(pt.shape, torch.int32, "discard", "pt") for d in self.mesh.distinct_devices()}
            self._pt_bufs = list(bufs.values())
            dev["pt"] = [bufs[d] for d in self.mesh.devices]
        w = noise_width(self.cfg.model.vocab_size)
        dev["noise"] = arena.zeros((self.cfg.decode_chunk, self.cfg.max_batch, w), torch.float32, "discard", "noise")
        return dev

    def sched_tensors(self) -> List[torch.Tensor]:
        """Every device scheduler tensor, the noise buffer included."""
        return [v for k, v in self._dev.items() if k != "pt"] + self._pt_bufs

    def _copy_table(self) -> None:
        host = torch.from_numpy(self._page_table)
        for buf in self._pt_bufs:
            buf.copy_(host)

    def _upload_sched(self) -> None:
        """Copy the host scheduler mirrors into the device tensors."""
        mirrors = self._mirrors()
        for k, a in mirrors.items():
            self._dev[k].copy_(torch.from_numpy(a))
        self._copy_table()
        self.step_h2d_bytes[self._h2d_path] += (
            sum(a.nbytes for a in mirrors.values()) + (1 + self._extra_devices) * self._page_table.nbytes
        )
        self._dirty = False

    @property
    def _h2d_path(self) -> str:
        return "packed" if self.cfg.packed_serving else "bucketed"

    def drop_device_sched_state(self) -> None:
        """Mark the device scheduler tensors stale (a sleep releases their
        memory): the host mirrors stay authoritative and the next dispatch
        copies them in again."""
        self._dirty = True

    # -- co-resident sibling variants ----------------------------------------

    def variant_hbm_bytes(self) -> int:
        """Device bytes of the attached variants' delta leaves (what
        ``--variant-hbm-mib`` budgets; each leaf's arena block is that
        rounded up to the granularity)."""
        return sum(v["nbytes"] for v in self._variants.values())

    def variant_handles(self) -> Dict[int, str]:
        """handle -> label of every attached variant."""
        return {h: v["label"] for h, v in self._variants.items()}

    def _variant_live(self, handle: int) -> bool:
        if any(r.variant == handle for r in self._waiting):
            return True
        return any(r is not None and not r.done and r.variant == handle for r in self._slots)

    def _base_leaf(self, key: str) -> torch.Tensor:
        """The base's tensor under a flat key (``lm_head``, ``layers/wq``)."""
        try:
            return self.model.get_parameter(key.replace("/", "."))
        except AttributeError:
            raise KeyError(key) from None

    @torch.no_grad()
    def attach_variant(self, delta: Dict[str, Any], label: str = "") -> int:
        """Make a sibling variant co-resident: copy its changed leaves
        (flat keys, host tensors or arrays of the base leaves' shapes and
        types) into the arena under the tag ``variant``, beside the base's
        weights, and return the handle requests route by. Each leaf is
        checked against the base leaf it replaces first. Waits until the
        copies landed, so the caller's clock times the transfer."""
        if not self.cfg.packed_serving:
            raise ValueError("co-resident variants require packed serving: the bucketed path runs the base")
        if self.mesh is not None:
            raise ValueError("co-resident variants on a tensor-parallel mesh are not ported yet (ROADMAP queue 1 item 14)")
        if self.asleep:
            raise EngineAsleep("engine state is offloaded (sleeping)")
        if not delta:
            raise ValueError("variant delta is empty: an identical sibling needs no co-residency, "
                             "route its requests to the base")
        host: Dict[str, torch.Tensor] = {}
        for key, leaf in delta.items():
            try:
                base = self._base_leaf(key)
            except KeyError:
                raise ValueError(f"variant delta key {key!r} not in params")
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(leaf))
            if tuple(t.shape) != tuple(base.shape) or t.dtype != base.dtype:
                raise ValueError(f"variant delta leaf {key!r} is {t.dtype}{tuple(t.shape)}, "
                                 f"base is {base.dtype}{tuple(base.shape)}")
            host[key] = t
        handle = self._next_variant_handle
        arena = self.arenas[self.device]
        dev: Dict[str, torch.Tensor] = {}
        try:
            for key, t in host.items():
                d = arena.empty(t.shape, t.dtype, "variant", f"variant{handle}:{key}")
                dev[key] = d
                d.copy_(t, non_blocking=t.is_pinned())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except BaseException:
            for d in dev.values():
                arena.release(d)
            raise
        self._next_variant_handle += 1
        self._variants[handle] = {
            "delta": dev, "view": llama.VariantView(self.model, dev),
            "nbytes": sum(t.numel() * t.element_size() for t in dev.values()),
            "label": label or f"variant-{handle}",
        }
        self._variant_order.append(handle)
        self.variant_attaches += 1
        return handle

    def detach_variant(self, handle: int) -> int:
        """Drop a variant's delta leaves and give their memory back to the
        card. Refused while a live or waiting request routes to it.
        Returns the leaves' bytes."""
        v = self._variants.get(handle)
        if v is None:
            raise KeyError(f"no resident variant with handle {handle}")
        if self._variant_live(handle):
            raise ValueError(f"resident variant {handle} has live requests; drain before detach")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no queued pass reads the leaves
        del self._variants[handle]
        self._variant_order.remove(handle)
        arena = self.arenas[self.device]
        for t in v["delta"].values():
            arena.release(t)
        v["delta"].clear()
        self.variant_detaches += 1
        return int(v["nbytes"])

    def _variant_pass_index(self) -> Dict[int, int]:
        """handle -> its pass in the multi-variant step and chunk (the base
        is pass 0)."""
        return {h: i + 1 for i, h in enumerate(self._variant_order)}

    def _passes(self, index: np.ndarray, live: np.ndarray) -> List[Tuple[Any, int]]:
        """The passes a multi-variant dispatch runs: (model, pass index)
        for each resident with a live row (``index`` per row, ``live`` the
        rows that count), base first. A resident without a row is skipped:
        its pass's outputs would be overwritten by the merge or dropped."""
        present = set(int(v) for v in np.unique(index[live]))
        models = [self.model] + [self._variants[h]["view"] for h in self._variant_order]
        return [(models[v], v) for v in range(len(models)) if v in present]

    # -- request lifecycle --------------------------------------------------

    def add_request(
        self,
        prompt: Seq[int],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        top_p: float = 1.0,
        stop_seqs: Seq[Seq[int]] = (),
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        on_token: Optional[Callable[[Request, int], None]] = None,
        want_top_logprobs: bool = False,
        want_prompt_logprobs: bool = False,
        seed: Optional[int] = None,
        ignore_eos: bool = False,
        logit_bias: "Dict[int, float] | None" = None,
        submit_time: Optional[float] = None,
        trace: Optional[Any] = None,
        variant: int = 0,
    ) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if variant:
            if variant not in self._variants:
                raise ValueError(f"unknown resident variant {variant}")
            if not self.cfg.packed_serving:
                raise ValueError("per-request variant routing requires packed serving")
            if want_prompt_logprobs:
                # echo takes the bucketed prefill, which runs the base
                raise ValueError("echo (prompt logprobs) is not supported for variant-routed requests")
        if min(prompt) < 0 or max(prompt) >= self.cfg.model.vocab_size:
            raise ValueError("prompt token id outside vocab")
        if seed is not None and not (-(2**63) <= int(seed) < 2**63):
            raise ValueError("seed must fit in a signed 64-bit integer")
        logit_bias = validate_logit_bias(logit_bias, self.cfg.model.vocab_size)
        total = len(prompt) + max_new_tokens
        if total > self.cfg.seq_len:
            raise ValueError(
                f"prompt+generation {len(prompt)}+{max_new_tokens} exceeds "
                f"max_seq_len {self.cfg.seq_len}"
            )
        need = PageAllocator.pages_needed(total, self.cfg.page_size)
        if need > self.cfg.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.cfg.num_pages - 1}"
            )
        req = Request(
            seq_id=self._next_seq_id,
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=float(top_p),
            stop_seqs=tuple(tuple(int(t) for t in s) for s in stop_seqs),
            presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
            on_token=on_token,
            want_top_logprobs=want_top_logprobs,
            want_prompt_logprobs=want_prompt_logprobs,
            seed=seed,
            ignore_eos=ignore_eos,
            logit_bias=logit_bias or {},
            trace=trace,
            variant=int(variant),
        )
        if submit_time is not None:
            req.submit_time = submit_time
        self._next_seq_id += 1
        self._waiting.append(req)
        return req.seq_id

    def stream_seed(self, req: Request) -> int:
        """The seed of ``req``'s generator: its own, else the one it was
        migrated in with, else derived from the engine seed and its id."""
        if req.seed is not None:
            return int(req.seed)
        key = req.rng_key_data
        if key is not None and np.asarray(key).dtype == np.uint64:
            return int(np.asarray(key).reshape(-1)[0])
        return _stream_seed(self._seed, req.seq_id)

    def new_seq_id(self) -> int:
        """A fresh request id: a migrated-in request is given one before it
        is seated (two engines' ids are unrelated)."""
        sid = self._next_seq_id
        self._next_seq_id += 1
        return sid

    def _init_slot_gen(self, req: Request) -> None:
        seed = self.stream_seed(req)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
        self._gens[req.slot] = gen

    def _draw_chunk_noise(self, slots: Seq[int], T: int) -> None:
        """Fill the noise buffer's first ``T`` steps before a chunk runs:
        step ``t`` holds what :meth:`_draw_noise` draws for the chunk's
        step ``t`` — one draw from each listed slot's generator, step by
        step in the same order, so every seeded stream keeps its values —
        and zeros in the other rows."""
        w = noise_width(self.cfg.model.vocab_size)
        noise = self._dev["noise"]
        noise[:T].zero_()
        for t in range(T):
            for s in slots:
                noise[t, s] = gumbel(torch.rand(w, generator=self._gens[s], device=self.device))

    def _draw_noise(self, slots: Seq[int], rows: int) -> torch.Tensor:
        """[rows, noise_width] Gumbel noise: one draw from each listed
        slot's generator (row = slot, or row 0 for a batch-1 prefill when
        ``rows == 1``); other rows are zero and belong to greedy rows."""
        w = noise_width(self.cfg.model.vocab_size)
        noise = torch.zeros((rows, w), dtype=torch.float32, device=self.device)
        for s in slots:
            u = torch.rand(w, generator=self._gens[s], device=self.device)
            noise[s if rows > 1 else 0] = gumbel(u)
        return noise

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        # a blocked request re-attempts every engine step: skip the
        # match+alloc until allocator or cache state actually moved
        state = (
            self.allocator.version,
            self.prefix_cache.version if self.prefix_cache else 0,
        )
        if getattr(req, "_blocked_state", None) == state:
            return False
        total = len(req.prompt) + req.max_new_tokens
        need = PageAllocator.pages_needed(total, self.cfg.page_size)
        shared: List[int] = []
        hashes: List[str] = []
        if self.prefix_cache is not None and not req.want_prompt_logprobs and req.variant == 0:
            # a routed request neither matches nor registers: the cached
            # pages hold the base's KV
            shared, req.cached_tokens, hashes = self.prefix_cache.match(req.prompt)
            # hold the shared pages BEFORE allocating: eviction inside the
            # allocation path must not reclaim what was just matched
            self.prefix_cache.acquire(shared)
        try:
            own = self._alloc_pages(need - len(shared))
        except OutOfPages:
            if self.prefix_cache is not None and shared:
                self.allocator.free(self.prefix_cache.release(shared))
            req.cached_tokens = 0
            req._blocked_state = (
                self.allocator.version,
                self.prefix_cache.version if self.prefix_cache else 0,
            )
            return False
        req.pages = shared + own
        req.shared_pages = len(shared)
        req._prefix_hashes = hashes
        if self.prefix_cache is not None:
            self.prefix_cache.acquire(own)
            self.prefix_cache.commit(hashes)
        req.slot = slot
        if req.first_sched_time is None:
            # every admission (bucketed prefill, packed segments, the echo
            # fallback) comes through here: the one stamp that closes the
            # queue wait
            req.first_sched_time = time.monotonic()
            if req.trace is not None:
                req.trace.add("request.queue", req.submit_time, req.first_sched_time, depth=len(self._waiting))
        self._slots[slot] = req
        self._init_slot_gen(req)
        self._eos_on[slot] = 0 if req.ignore_eos else 1
        self._bias[slot] = 0.0
        for t, v in req.logit_bias.items():
            self._bias[slot, t] = v
        row = np.zeros((self.cfg.pages_per_seq,), dtype=np.int32)
        row[: len(req.pages)] = req.pages
        self._page_table[slot] = row
        # penalties count prompt tokens too (OpenAI "text so far")
        self._token_counts[slot] = 0
        np.add.at(self._token_counts[slot], req.prompt, 1)
        self._pres[slot] = req.presence_penalty
        self._freqs[slot] = req.frequency_penalty
        self._temps[slot] = req.temperature
        self._topps[slot] = req.top_p
        if not self.cfg.packed_serving:
            # a packed admission decides in _step_packed what to upload
            self._dirty = True
        return True

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate, evicting LRU cache-only prefix pages under pressure."""
        try:
            return self.allocator.alloc(n)
        except OutOfPages:
            if self.prefix_cache is None:
                raise
            evicted = self.prefix_cache.evict(n - self.allocator.available)
            if not evicted:
                raise
            self.allocator.free(evicted)
            return self.allocator.alloc(n)

    def _prefill_bucket(self, n: int) -> int:
        return prefill_bucket(n, self.cfg.seq_len)

    def _sample_last(self, req: Request, logits: torch.Tensor, n: int):
        """Sample the first generated token from the logits at position
        n-1 of a batch-1 prefill (one draw from the request's generator
        when it samples) — shared by the cold and cache-hit paths."""
        s = req.slot
        out = sample(
            logits[:, n - 1],
            self._to_dev(self._temps[s : s + 1]),
            self._draw_noise([s], 1) if req.temperature > 0 else None,
            top_p=self._to_dev(self._topps[s : s + 1]),
            counts=self._to_dev(self._token_counts[s : s + 1]),
            presence_penalty=self._to_dev(self._pres[s : s + 1]),
            frequency_penalty=self._to_dev(self._freqs[s : s + 1]),
            alt_k=self.cfg.logprobs_topk,
            bias=self._to_dev(self._bias[s : s + 1]),
        )
        return out

    def _run_suffix_segment(self, req: Request, start_pos: int, seg: List[int]) -> torch.Tensor:
        """One prefill segment through ``prefill_continue``: write the
        segment's KV, attend over everything already in the pages. Used by
        prefix-cache hits and chunked prefill. Returns its logits."""
        bucket = self._prefill_bucket(len(seg))
        tokens = np.zeros((1, bucket), dtype=np.int32)
        tokens[0, : len(seg)] = seg
        self._count_bucketed(bucket, len(seg))
        return llama.prefill_continue(
            self.model,
            self._to_ranks(tokens),
            self._to_ranks(np.array([start_pos], dtype=np.int32)),
            self._to_ranks(np.array([len(seg)], dtype=np.int32)),
            self.pool.as_tuple(),
            self._to_ranks(self._page_table[req.slot : req.slot + 1]),
        )

    def _count_bucketed(self, bucket: int, n: int) -> None:
        self.pad_waste_bytes["bucketed"] += (bucket - n) * self._pad_token_bytes
        self.dispatch_tokens["bucketed"] += n

    #: logits rows per log-softmax in :meth:`_prompt_lps`: a Llama-3 row is
    #: 0.5 MB in fp32, so a chunk holds 128 MB and the prompt's whole matrix
    #: of log-probabilities is never made
    PLP_ROWS = 256

    def _prompt_lps(self, logits: torch.Tensor, targets: List[int]) -> torch.Tensor:
        """The log-probability of ``targets[i]`` (the NEXT prompt token)
        under row ``i`` of ``logits`` [s, vocab] fp32, for the first
        ``len(targets)`` rows: each chunk's log-softmax gathered at its
        targets, on the logits' device."""
        tgt = torch.as_tensor(targets, dtype=torch.int64).to(logits.device)
        parts = []
        for r0 in range(0, len(targets), self.PLP_ROWS):
            rows = logits[r0 : r0 + self.PLP_ROWS][: len(targets) - r0]
            t = tgt[r0 : r0 + rows.shape[0]]
            parts.append(rows.gather(-1, t[:, None])[:, 0] - torch.logsumexp(rows, dim=-1))
        return torch.cat(parts) if parts else logits.new_zeros((0,))

    def _run_prefill(self, req: Request) -> None:
        n = len(req.prompt)
        k = req.cached_tokens
        limit = self.cfg.max_prefill_tokens or (n - k)
        plp: List[torch.Tensor] = []
        if k == 0 and n <= limit:
            # single cold segment: the flash-style causal prefill
            bucket = self._prefill_bucket(n)
            tokens = np.zeros((1, bucket), dtype=np.int32)
            tokens[0, :n] = req.prompt
            self.cold_prefills += 1
            self._count_bucketed(bucket, n)
            logits = llama.prefill(
                self.model,
                self._to_ranks(tokens),
                self._to_ranks(np.array([n], dtype=np.int32)),
                self.pool.as_tuple(),
                self._to_ranks(self._page_table[req.slot : req.slot + 1]),
            )
            last = n
            if req.want_prompt_logprobs:
                # position i predicts prompt token i + 1
                plp.append(self._prompt_lps(logits[0], req.prompt[1:]))
        else:
            # prefix-cache hit and/or chunked prefill: run [k, n) in
            # segments of <= limit tokens; only the final one samples
            pos = k
            while pos < n:
                seg = req.prompt[pos : min(n, pos + limit)]
                logits = self._run_suffix_segment(req, pos, seg)
                if req.want_prompt_logprobs:
                    # a segment's last row predicts the next segment's first
                    # token; the prompt's last row predicts nothing
                    plp.append(self._prompt_lps(logits[0], req.prompt[pos + 1 : pos + len(seg) + 1]))
                last = len(seg)
                pos += len(seg)
        out = self._sample_last(req, logits, last)
        if self.prefix_cache is not None and req.variant == 0:
            # the full prompt pages now hold prompt KV: make them reusable
            self.prefix_cache.register(
                req.prompt, req.pages, req.shared_pages,
                known_hashes=getattr(req, "_prefix_hashes", ()),
            )
        tok_h, lp_h = out[0].cpu().numpy(), out[1].cpu().numpy()
        alts = None
        if req.want_top_logprobs and self.cfg.logprobs_topk > 0:
            av_h, ai_h = out[2].cpu().numpy(), out[3].cpu().numpy()
            alts = [(int(ai_h[0, j]), float(av_h[0, j])) for j in range(av_h.shape[1])]
        if req.want_prompt_logprobs:
            req.prompt_logprobs = [None] + [float(v) for v in torch.cat(plp).cpu().tolist()]
        first = int(tok_h[0])
        req.pos = n
        self._emit(req, first, float(lp_h[0]), alts)
        self._positions[req.slot] = req.pos  # position of the token to place
        self._last_tokens[req.slot] = first
        self._budgets[req.slot] = req.max_new_tokens - len(req.out_tokens)
        self._dirty = True

    def _emit(self, req: Request, token: int, logprob: float = 0.0, alts: Optional[list] = None) -> None:
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
            if req.trace is not None and req.first_sched_time is not None:
                req.trace.add(
                    "request.prefill", req.first_sched_time, req.first_token_time,
                    prompt_tokens=len(req.prompt), cached_tokens=req.cached_tokens,
                    packed=bool(self.cfg.packed_serving),
                )
        req.out_tokens.append(token)
        req.out_logprobs.append(logprob)
        req.out_top_logprobs.append(alts or [])
        if req.slot >= 0:
            # host counts mirror the device copy the chunk maintains
            self._token_counts[req.slot, token] += 1
        for seq in req.stop_seqs:
            if len(req.out_tokens) >= len(seq) and tuple(req.out_tokens[-len(seq):]) == seq:
                # OpenAI semantics: finish on the stop sequence and strip it
                del req.out_tokens[-len(seq):]
                del req.out_logprobs[-len(seq):]
                del req.out_top_logprobs[-len(seq):]
                req.done = True
                req.finish_reason = "stop"
                break
        if not req.done:
            eos_hit = (
                token == self.cfg.eos_token_id or token in self.cfg.extra_eos_ids
            ) and not req.ignore_eos
            if req.stop_requested or eos_hit:
                req.done = True
                req.finish_reason = "stop"
            elif len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.finish_reason = "length"
        self._stream(req)

    def _stream(self, req: Request) -> None:
        """Deliver newly-safe tokens to the streaming hook, holding back a
        suffix that may still become a stripped stop sequence."""
        if req.on_token is None:
            return
        if req.done:
            tail = req.out_tokens[req.streamed:]
        else:
            hold = _stop_holdback(req.out_tokens, req.stop_seqs)
            tail = req.out_tokens[req.streamed : len(req.out_tokens) - hold]
        was_done = req.done
        try:
            for i, t in enumerate(tail):
                req.done = was_done and i == len(tail) - 1
                req.on_token(req, t)
                req.streamed += 1
        finally:
            req.done = was_done

    def _retire(self, req: Request) -> None:
        if self.prefix_cache is not None:
            self.allocator.free(self.prefix_cache.release(req.pages))
        else:
            self.allocator.free(req.pages)
        s = req.slot
        self._slots[s] = None
        self._gens[s] = None
        self._page_table[s] = 0
        self._positions[s] = 0
        self._last_tokens[s] = 0
        self._temps[s] = 0.0
        self._topps[s] = 1.0
        self._pres[s] = 0.0
        self._freqs[s] = 0.0
        self._token_counts[s] = 0
        self._budgets[s] = 0
        self._eos_on[s] = 1
        self._bias[s] = 0.0
        req.slot = -1
        self._dirty = True

    # -- the engine loop body ----------------------------------------------

    def step(self) -> List[Request]:
        """Admit + prefill waiting requests (bucketed), or run one packed
        step while prompt work is pending (packed serving), then one
        decode chunk (up to ``decode_chunk`` steps) for the running batch.
        Returns requests that finished."""
        if self.asleep:
            raise EngineAsleep("engine state is offloaded (sleeping)")
        if self.kv_detached:
            raise RuntimeError("the KV pool is detached by a park; rebuild_kv_pool() before serving")
        self.last_step_stats = None
        finished: List[Request] = []
        if self.cfg.packed_serving:
            # prompts stream into one mixed forward beside a decode row
            # per running sequence, then the step falls through to the
            # chunk; a queue blocked on slots or pages packs nothing
            if self._waiting or self._any_prefilling():
                self._step_packed(finished)
        else:
            while self._waiting:
                req = self._waiting[0]
                if not self._admit(req):
                    break
                self._waiting.pop(0)
                self._run_prefill(req)
                if req.done:
                    self._retire(req)
                    finished.append(req)
        running = self._running()
        if running:
            finished.extend(self._drain_chunk(self._dispatch_chunk(running)))
        return finished

    def _running(self) -> Dict[int, Request]:
        # mid-prefill slots (packed serving) are not decodable yet: their
        # budget mirror is 0, so the chunk leaves them inactive
        return {
            r.slot: r
            for r in self._slots
            if r is not None and not r.done and not r.prefilling
        }

    # -- token-packed mixed-batch serving (cfg.packed_serving) ----------------

    def _any_prefilling(self) -> bool:
        return any(r is not None and r.prefilling and not r.done for r in self._slots)

    def _step_packed(self, finished: List[Request]) -> bool:
        """One token-packed mixed-batch step: a decode row per running
        sequence, then prefill segments of the in-flight and the waiting
        requests, packed into the flat buffer; ONE mixed forward; at most
        one token emitted per sequence.

        Returns False without dispatching when no prefill segment could be
        packed (the waiting queue is blocked on slots or pages): the
        caller's decode chunk then serves the running batch.

        Packing layout (the ragged kernel's contract): each sequence's rows
        are contiguous, at consecutive positions, and start on a
        RAGGED_BLOCK boundary; alignment gaps and the tail are padding
        rows (row_slot -1)."""
        qb = RAGGED_BLOCK
        T = self.cfg.packed_token_budget
        b = self.cfg.max_batch
        tokens = np.zeros((T,), dtype=np.int32)
        row_slot = np.full((T,), -1, dtype=np.int32)
        positions = np.zeros((T,), dtype=np.int32)
        #: rows whose token joins its slot's counts BEFORE the sample:
        #: streamed prompt tokens (decode rows' tokens were counted when
        #: they were emitted)
        count_row = np.zeros((T,), dtype=np.int32)
        sample_rows = np.zeros((b,), dtype=np.int32)
        sample_on = np.zeros((b,), dtype=np.int32)
        #: each row's pass (the co-resident variant it runs as; 0 = base)
        tok_pass = np.zeros((T,), dtype=np.int32)
        pass_of = self._variant_pass_index() if self._variants else {}
        rows_used = 0
        decode_reqs: List[Request] = []
        segments: List[Tuple[Request, int, bool]] = []
        seg_cap = self.cfg.max_prefill_tokens or T

        def pack_segment(req: Request) -> None:
            nonlocal rows_used
            take = min(len(req.prompt) - req.pos, seg_cap, T - rows_used)
            start = rows_used
            tokens[start : start + take] = req.prompt[req.pos : req.pos + take]
            row_slot[start : start + take] = req.slot
            positions[start : start + take] = np.arange(req.pos, req.pos + take)
            count_row[start : start + take] = 1
            if req.variant:
                tok_pass[start : start + take] = pass_of[req.variant]
            final = req.pos + take >= len(req.prompt)
            if final:
                # the segment's last row predicts the first generated token
                sample_rows[req.slot] = start + take - 1
                sample_on[req.slot] = 1
            segments.append((req, take, final))
            rows_used += -(-take // qb) * qb

        # 1. one decode row per running sequence, each in its own block
        for slot, req in enumerate(self._slots):
            if req is None or req.done or req.prefilling:
                continue
            tokens[rows_used] = self._last_tokens[slot]
            row_slot[rows_used] = slot
            positions[rows_used] = req.pos
            sample_rows[slot] = rows_used
            sample_on[slot] = 1
            if req.variant:
                tok_pass[rows_used] = pass_of[req.variant]
            decode_reqs.append(req)
            rows_used += qb
        # 2. one segment of each in-flight chunked prefill, in slot order
        for req in self._slots:
            if req is not None and req.prefilling and not req.done and T - rows_used >= qb:
                pack_segment(req)
        # 3. admit waiting requests into the rest of the buffer
        admitted = False
        while self._waiting and T - rows_used >= qb:
            req = self._waiting[0]
            if req.want_prompt_logprobs:
                # echo requests need the bucketed prefill's full logits:
                # the bucketed fallback, in this step
                if not self._admit(req):
                    break
                self._waiting.pop(0)
                self._run_prefill(req)
                if req.done:
                    self._retire(req)
                    finished.append(req)
                continue
            if not self._admit(req):
                break
            self._waiting.pop(0)
            req.prefilling = True
            req.pos = req.cached_tokens
            # the count mirror follows the streaming the mixed forward
            # does: a cached prefix's tokens now (they never enter the
            # buffer), packed rows as they stream (below)
            self._token_counts[req.slot] = 0
            if req.cached_tokens:
                np.add.at(self._token_counts[req.slot], req.prompt[: req.cached_tokens], 1)
            if req.logit_bias or ((req.presence_penalty or req.frequency_penalty) and req.cached_tokens):
                # rows the device cannot rebuild from the buffer: upload all
                self._dirty = True
            admitted = True
            pack_segment(req)
        if not segments:
            return False

        # the smallest buffer shape that fits, against the page table cut
        # to the width the step's longest sequence needs
        shape = next(s for s in packed_budget_shapes(self.cfg) if s >= rows_used)
        valid_rows = row_slot[:shape] >= 0
        valid = int(valid_rows.sum())
        max_kv = int(positions[:shape][valid_rows].max()) + 1
        kvp = kv_pages_bucket(max_kv, self.cfg.page_size, self.cfg.pages_per_seq)
        prefill_tokens = sum(take for _, take, _ in segments)
        # any routed row switches the step to the multi-variant twin
        passes = self._passes(tok_pass[:shape], valid_rows) if tok_pass[:shape].any() else None
        self.packed_steps += 1
        self.packed_passes += 1 if passes is None else len(passes)
        self.variant_steps += passes is not None
        self.packed_tokens_total += valid
        self.pad_waste_bytes["packed"] += (shape - valid) * self._pad_token_bytes
        self.dispatch_tokens["packed"] += valid
        self.last_step_stats = {
            "mode": "packed",
            "rows": shape,
            "tokens": valid,
            "pad_rows": shape - valid,
            "decode_rows": len(decode_reqs),
            "prefill_tokens": prefill_tokens,
            "passes": 1 if passes is None else len(passes),
        }
        if self._dirty:
            self._upload_sched()
        elif admitted:
            # the admissions wrote page-table rows; their slots' count and
            # bias rows are zero on the device since their last retire
            self._copy_table()
            self.step_h2d_bytes["packed"] += (1 + self._extra_devices) * self._page_table.nbytes
        sampled = [s for s in range(b) if sample_on[s] and self._temps[s] > 0]
        per_step = (tokens[:shape], row_slot[:shape], positions[:shape], count_row[:shape],
                    sample_rows, sample_on, self._temps, self._topps, self._pres, self._freqs)
        # tokens, row_slot and positions go to every device of a mesh
        self.step_h2d_bytes["packed"] += (
            sum(a.nbytes for a in per_step) + self._extra_devices * sum(a.nbytes for a in per_step[:3])
            + (tok_pass[:shape].nbytes if passes is not None else 0)
        )
        emitting = [r for r, _, _ in segments] + decode_reqs
        av_h = ai_h = None
        # one span per packed step, closed after the step's host read
        with tracing.span("step.packed", rows=shape, tokens=valid, decode_rows=len(decode_reqs),
                          prefill_tokens=prefill_tokens):
            out = self._mixed(shape, kvp, *per_step, sampled,
                              passes=None if passes is None else (passes, tok_pass[:shape]))
            tok_h, lp_h = out[0].cpu().numpy(), out[1].cpu().numpy()
            if len(out) > 2 and any(r.want_top_logprobs for r in emitting):
                av_h, ai_h = out[2].cpu().numpy(), out[3].cpu().numpy()

        def alts_for(req: Request):
            if not req.want_top_logprobs or av_h is None:
                return None
            return [(int(ai_h[req.slot, j]), float(av_h[req.slot, j])) for j in range(av_h.shape[1])]

        # the host count mirror takes the streamed prompt rows, as the
        # forward added them on the device (req.pos is still pre-step)
        for req, take, _ in segments:
            if req.slot >= 0:
                np.add.at(self._token_counts[req.slot], req.prompt[req.pos : req.pos + take], 1)
        # prefill segments advance; final segments emit their first token
        for req, take, final in segments:
            if req.done:  # aborted mid-step: pages already freed
                continue
            slot = req.slot
            req.pos += take
            if not final:
                continue
            req.prefilling = False
            if self.prefix_cache is not None and req.variant == 0:
                # the whole prompt's KV is in its pages now: reusable
                self.prefix_cache.register(
                    req.prompt, req.pages, req.shared_pages,
                    known_hashes=getattr(req, "_prefix_hashes", ()),
                )
            self._emit(req, int(tok_h[slot]), float(lp_h[slot]), alts_for(req))
            self._positions[slot] = req.pos
            self._last_tokens[slot] = int(tok_h[slot])
            self._budgets[slot] = req.max_new_tokens - len(req.out_tokens)
            if req.done:
                self._retire(req)
                finished.append(req)
        # decode rows emit one token each
        for req in decode_reqs:
            if req.done:
                continue
            slot = req.slot
            req.pos += 1
            self._positions[slot] = req.pos
            self._last_tokens[slot] = int(tok_h[slot])
            self._emit(req, int(tok_h[slot]), float(lp_h[slot]), alts_for(req))
            self._budgets[slot] = req.max_new_tokens - len(req.out_tokens)
            if req.done:
                self._retire(req)
                finished.append(req)
        # positions, last tokens and budgets moved on the host: the next
        # dispatch uploads the mirrors in full
        self._dirty = True
        return True

    @torch.no_grad()
    def _mixed(self, shape, kvp, tokens, row_slot, positions, count_row, sample_rows,
               sample_on, temps, topps, pres, freqs, sampled, passes=None):
        """The mixed forward and its sampling tail, on the device: add the
        streamed prompt rows to their slots' counts BEFORE sampling (the
        final segment's sample sees the whole prompt, as a bucketed
        prefill does), run ``llama.mixed_step`` over the [shape] buffer
        against the page table's first ``kvp`` columns, sample one row per
        slot, and add each sampling slot's emitted token to its counts.
        Only the ``sampled`` slots draw from their generators.

        ``passes`` (the multi-variant twin): ``(passes, tok_pass)``, the
        :meth:`_passes` to run and each row's pass. Pass v runs
        ``mixed_step`` with its variant's leaves and every other row's
        slot set to -1, exactly a padding row (it attends to nothing of
        its own and writes only the null page), so each row's KV is written
        once, by its own weights; the logits merge row by row and the
        sampling tail runs once on the merged logits."""
        d = self._dev
        b = self.cfg.max_batch
        tok_r, slot_r, pos_r = self._to_ranks(tokens), self._to_ranks(row_slot), self._to_ranks(positions)
        # rank 0's copies: the counts live beside the sampler
        tok_d, slot_d = (tok_r, slot_r) if self.mesh is None else (tok_r[0], slot_r[0])
        counts, bias = d["counts"], d["bias"]
        # padding and decode rows add 0 (to row 0), so nothing syncs
        counts.index_put_(
            (slot_d.long().clamp(min=0), tok_d.long()), self._to_dev(count_row), accumulate=True
        )
        if passes is None:
            logits = llama.mixed_step(self.model, tok_r, slot_r, pos_r, self.pool.as_tuple(), self._table(kvp))
        else:
            run, tok_pass = passes
            tp = self._to_dev(tok_pass)
            logits = self._merged(run, tp, lambda model, mine: llama.mixed_step(
                model, tok_r, torch.where(mine, slot_r, -1), pos_r, self.pool.as_tuple(), self._table(kvp)))
        out = sample(
            logits[self._to_dev(sample_rows).long()],
            self._to_dev(temps),
            self._draw_noise(sampled, b) if sampled else None,
            top_p=self._to_dev(topps), counts=counts,
            presence_penalty=self._to_dev(pres), frequency_penalty=self._to_dev(freqs),
            alt_k=self.cfg.logprobs_topk, bias=bias,
        )
        rows = torch.arange(b, device=self.device)
        counts.index_put_((rows, out[0].long()), self._to_dev(sample_on), accumulate=True)
        return out

    @staticmethod
    def _merged(passes, index: torch.Tensor, forward) -> torch.Tensor:
        """Run ``forward(model, mine)`` once per pass, ``mine`` the rows
        whose pass it is, and merge the logits row by row (the first pass
        run fills the rows no pass owns, which nobody reads)."""
        logits = None
        for model, v in passes:
            mine = index == v
            lg = forward(model, mine)
            logits = lg if logits is None else torch.where(mine[:, None], lg, logits)
        return logits

    @torch.no_grad()
    def _dispatch_chunk(self, running: Dict[int, Request]):
        """Enqueue one decode chunk on the device (T decode+sample steps
        whose state never leaves it); the matching _drain_chunk does the
        one host read."""
        max_remaining = max(r.max_new_tokens - len(r.out_tokens) for r in running.values())
        # the batch's drain tail runs single steps (the reference's
        # drain_tail="single", its choice off-TPU)
        T = self.cfg.decode_chunk if max_remaining >= self.cfg.decode_chunk else 1
        if self._dirty:
            self._upload_sched()
        sampled = [s for s, r in running.items() if r.temperature > 0]
        if sampled:
            self._draw_chunk_noise(sampled, T)
        self.decode_chunks += 1
        self.chunk_steps += T
        if any(r.variant for r in running.values()):
            # a routed slot: the multi-variant twin, eagerly; the captured
            # graphs run the base alone
            pass_of = self._variant_pass_index()
            slot_pass = np.zeros((self.cfg.max_batch,), dtype=np.int32)
            live = np.zeros((self.cfg.max_batch,), dtype=bool)
            for slot, r in running.items():
                slot_pass[slot] = pass_of[r.variant] if r.variant else 0
                live[slot] = True
            self.variant_chunks += 1
            self.step_h2d_bytes[self._h2d_path] += slot_pass.nbytes
            passes = (self._passes(slot_pass, live), self._to_dev(slot_pass))
            self.variant_chunk_steps += T
            self.variant_decode_forwards += T * len(passes[0])
            toks, lps, alts = self.chunk_eager(T, bool(sampled), passes)
            return toks, lps, alts, running, T
        run = self.chunk_eager if self.graphs is None else self.graphs.replay
        toks, lps, alts = run(T, bool(sampled))
        return toks, lps, alts, running, T

    @torch.no_grad()
    def chunk_eager(self, T: int, sampled: bool, passes=None) -> tuple:
        """Run :meth:`chunk_body` eagerly (the CPU, a mesh, the warm-up
        before a capture, and the multi-variant twin); counts its decode
        forwards, ``T`` per pass."""
        out = self.chunk_body(T, sampled, passes)
        self.decode_steps += T * (1 if passes is None else len(passes[0]))
        return out

    def chunk_body(self, T: int, sampled: bool, passes=None) -> tuple:
        """One decode chunk over the static device state: ``T`` decode and
        sample steps for every slot; a slot with budget 0 is inactive and
        writes only the null page. ``sampled``: whether the noise buffer's
        first ``T`` steps are read (:meth:`_draw_chunk_noise` fills them);
        otherwise every row is greedy. Writes the last tokens, positions,
        budgets and token counts back in place, reads nothing on the host,
        and returns (tokens [T, b], logprobs [T, b], top-k alternatives or
        None): what a CUDA graph captures (``engine/graphs.py``).

        ``passes`` (the multi-variant twin, never captured): ``(passes,
        slot_pass)``, the :meth:`_passes` to run and each slot's pass; each
        step runs one decode forward per pass with the slots of other passes
        inactive (their K/V go to the null page), merges the logits by slot
        and samples once."""
        d = self._dev
        alt_k = self.cfg.logprobs_topk
        eos = self.cfg.eos_token_id
        lt, pos, budget, counts = d["lt"], d["pos"], d["budget"], d["counts"]
        toks, lps, avs, ais = [], [], [], []
        for t in range(T):
            active = budget > 0
            if passes is None:
                logits = llama.decode_step(self.model, lt, pos, self.pool.as_tuple(), self._table(), active)
            else:
                logits = self._merged(passes[0], passes[1], lambda model, mine: llama.decode_step(
                    model, lt, pos, self.pool.as_tuple(), self._table(), active & mine))
            out = sample(
                logits, d["temps"], d["noise"][t] if sampled else None,
                top_p=d["topp"], counts=counts, presence_penalty=d["pres"],
                frequency_penalty=d["freq"], alt_k=alt_k, bias=d["bias"],
            )
            nxt = torch.where(active, out[0], lt)
            a32 = active.to(torch.int32)
            # the emitted token joins the counts the NEXT step penalizes
            # (one index per row: a scatter-add, whose index check runs on the
            # device; index_put_'s accumulate path may read its indices on the
            # host, which a capture forbids)
            counts.scatter_add_(1, nxt.long()[:, None], a32[:, None])
            pos = pos + a32
            budget = budget - a32
            if eos >= 0:
                budget = torch.where(active & (nxt == eos) & (d["eos_on"] > 0), 0, budget)
            lt = nxt
            toks.append(nxt)
            lps.append(out[1])
            if alt_k > 0:
                avs.append(out[2])
                ais.append(out[3])
        d["lt"].copy_(lt)
        d["pos"].copy_(pos)
        d["budget"].copy_(budget)
        alts = (torch.stack(avs), torch.stack(ais)) if alt_k > 0 else None
        return torch.stack(toks), torch.stack(lps), alts

    def _drain_chunk(self, inflight) -> List[Request]:
        """Read one chunk's [T, b] results back (the one host sync per
        chunk) and emit its tokens."""
        toks_dev, lps_dev, alts_dev, running, T = inflight
        toks = toks_dev.cpu().numpy()
        lps = lps_dev.cpu().numpy()
        if alts_dev is not None and any(r.want_top_logprobs for r in running.values()):
            avs, ais = alts_dev[0].cpu().numpy(), alts_dev[1].cpu().numpy()
        else:
            avs = ais = None
        finished: List[Request] = []
        running = dict(running)
        for t in range(T):
            for slot, req in list(running.items()):
                tok = int(toks[t, slot])
                req.pos += 1
                self._positions[slot] = req.pos
                self._last_tokens[slot] = tok
                alts = None
                if req.want_top_logprobs and avs is not None:
                    alts = [(int(ais[t, slot, j]), float(avs[t, slot, j])) for j in range(avs.shape[2])]
                self._emit(req, tok, float(lps[t, slot]), alts)
                # keep the budget mirror exact: a dirty re-upload with a
                # stale budget would un-freeze finished slots on device
                self._budgets[slot] = req.max_new_tokens - len(req.out_tokens)
                if req.done:
                    self._retire(req)
                    finished.append(req)
                    del running[slot]
        return finished

    def has_work(self) -> bool:
        return bool(self._waiting) or any(s is not None for s in self._slots)

    def abort(self, seq_id: int, reason: str = "aborted") -> bool:
        """Abort one request: waiting requests are dropped, running ones
        retired — their pages return to the pool this step."""
        for i, req in enumerate(self._waiting):
            if req.seq_id == seq_id:
                self._waiting.pop(i)
                req.done = True
                req.error = reason
                return True
        for req in self._slots:
            if req is not None and req.seq_id == seq_id:
                self._retire(req)
                req.done = True
                req.error = reason
                return True
        return False

    def abort_all(self, reason: str) -> List[Request]:
        """Fail every waiting and running request and reset the scheduler
        (slots, page tables, allocator, prefix cache) — used when a
        level-2 sleep discarded the KV cache."""
        aborted = list(self._waiting)
        self._waiting.clear()
        for req in list(self._slots):
            if req is not None:
                aborted.append(req)
                self._retire(req)
        for req in aborted:
            req.done = True
            req.error = reason
        if self.prefix_cache is not None:
            # the KV content backing the index is gone
            self.allocator.free(self.prefix_cache.clear())
        return aborted

    # -- zero-drain park and resume (engine/parked.py) -------------------------

    def parked_page_ids(self) -> List[int]:
        """The unique pool pages a park would page out now: the first
        ``ceil(pos / page_size)`` pages of every request mid-decode, in
        order of first use (a shared prefix page once). The cost oracle
        prices a park from this list, and the park gathers it, so the
        predicted and the moved bytes agree by construction."""
        out: List[int] = []
        seen: set = set()
        for req in self._slots:
            if req is None or req.done or req.prefilling:
                continue
            used = PageAllocator.pages_needed(req.pos, self.cfg.page_size) if req.pos > 0 else 0
            for p in req.pages[:used]:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
        return out

    def key_data(self, req: Request) -> np.ndarray:
        """The key a parked ``req`` carries: its slot generator's state
        when it samples, :func:`~.parked.greedy_key` when it does not."""
        from .parked import greedy_key

        if req.temperature > 0 and self._gens[req.slot] is not None:
            return self._gens[req.slot].get_state().numpy().copy()
        return greedy_key()

    @torch.no_grad()
    def park_requests(self, bucket_bytes: "int | None" = None):
        """Preempt every running and queued request into a host
        :class:`~.parked.ParkedRequests` bundle and release the KV pool's
        memory (``kv_detached``): the engine is then empty, an actuation
        can sleep or swap it without aborting anything, and
        :meth:`resume_parked` seats the bundle again afterwards.

        The page-out (fault point ``kvsave.d2h``) runs before any
        scheduler state is touched, so a failed page-out raises with the
        engine still serving and the caller takes the abort path. A decode
        chunk is never in flight between steps here (each step reads its
        chunk back), so the emitted tokens and the generators' states
        agree. Returns ``(bundle, finished)``; ``finished`` is always
        empty (the reference's pipelined drain may finish requests).

        Requests mid-prefill (packed serving) go back to the waiting
        queue without KV: a prefill is a function of the prompt and draws
        nothing before its last segment, so running it again gives the
        same tokens. The prefix cache restarts empty."""
        from . import parked as parked_mod

        if self.mesh is not None:
            raise ValueError("zero-drain parking on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)")
        live_reqs = [r for r in self._slots if r is not None and not r.done and not r.prefilling]
        demote = [r for r in self._slots if r is not None and not r.done and r.prefilling]
        page_ids = self.parked_page_ids()
        k_host = v_host = None
        kv_nbytes, pageout_s, pin_s = 0, 0.0, 0.0
        if page_ids:
            # the faultable transfer first: nothing below runs unless every
            # live page landed; its window excludes the pinning, so the
            # kvsave.d2h bandwidth sees the copies alone
            t0 = time.monotonic()
            k_host, v_host, pin_s = parked_mod.gather_pages_d2h(
                self.pool, page_ids, bucket_bytes=bucket_bytes, span_name="swap.kv_pageout")
            pageout_s = time.monotonic() - t0 - pin_s
            kv_nbytes = k_host.numel() * k_host.element_size() + v_host.numel() * v_host.element_size()
        bundle = parked_mod.ParkedRequests(page_ids=page_ids, k_host=k_host, v_host=v_host, kv_nbytes=kv_nbytes,
                                           pageout_s=pageout_s, pin_s=pin_s)
        meta_nbytes = 0
        for r in live_reqs:
            used = PageAllocator.pages_needed(r.pos, self.cfg.page_size)
            pr = parked_mod.ParkedRequest(req=r, old_pages=list(r.pages[:used]),
                                          counts_row=np.array(self._token_counts[r.slot], copy=True),
                                          key_data=self.key_data(r))
            meta_nbytes += pr.counts_row.nbytes + pr.key_data.nbytes
            bundle.live.append(pr)
        if self.prefix_cache is not None:
            # its references and index die with the pool; resumed pages take
            # fresh references
            for r in live_reqs + demote:
                self.prefix_cache.release(r.pages)
            self.prefix_cache.clear()
        for r in demote:
            r.prefilling = False
            r.pos = 0
            r.cached_tokens = 0
            r.shared_pages = 0
            r.pages = []
            r.slot = -1
            r._prefix_hashes = ()
            if hasattr(r, "_blocked_state"):
                del r._blocked_state
            bundle.waiting.append(r)
        for r in live_reqs:
            r.slot = -1
            r.pages = []
        bundle.waiting.extend(self._waiting)
        bundle.nbytes = kv_nbytes + meta_nbytes
        # detach: the scheduler is wiped whole; the pool's memory goes back
        # to the card and the allocator is made anew when it is rebuilt
        b = self.cfg.max_batch
        self._slots = [None] * b
        self._gens = [None] * b
        self._waiting = []
        for a, v in ((self._page_table, 0), (self._positions, 0), (self._last_tokens, 0), (self._temps, 0.0),
                     (self._topps, 1.0), (self._pres, 0.0), (self._freqs, 0.0), (self._token_counts, 0),
                     (self._budgets, 0), (self._eos_on, 1), (self._bias, 0.0)):
            a[:] = v
        self._dirty = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # nothing queued may still read the pool
        self.arenas[self.device].unmap(self.pool.tensors())
        self.kv_detached = True
        return bundle, []

    def rebuild_kv_pool(self) -> None:
        """An empty pool after a park released it: its memory mapped again
        at the same addresses (the captured graphs read them), zeroed, and
        a fresh allocator. Called when the sleeper's state comes back
        without the pool, and by the rollback paths."""
        self.arenas[self.device].map(self.pool.tensors())
        for t in self.pool.tensors():
            t.zero_()
        self.allocator = PageAllocator(self.cfg.num_pages)
        self.kv_detached = False
        self._dirty = True

    def resume_parked(self, bundle, bucket_bytes: "int | None" = None) -> Tuple[int, int]:
        """Seat a parked bundle into this engine (awake, its pool
        rebuilt): allocate pages, page the KV back in (fault point
        ``kvrestore.h2d``), write the page tables through the old -> new
        page map (pages shared by live requests stay shared), and restore
        every per-slot mirror and generator; the next dispatch uploads the
        whole scheduler state, so each stream goes on mid-decode. A
        request may land in another slot: the chunk runs every slot alike.

        Returns ``(live_resumed, kv_pagein_bytes)``. On a page-in failure
        everything is unwound (pages freed, no slot seated, the waiting
        requests queued again: they carried no KV) and
        :class:`~.parked.ParkedResumeFailed` is raised, so the caller
        aborts the live requests with cause ``state_loss``; the engine
        serves on with an empty pool."""
        from . import parked as parked_mod

        if self.kv_detached:
            raise parked_mod.ParkedResumeFailed("resume before the KV pool was rebuilt")
        old2new: Dict[int, int] = {}
        seated: List[tuple] = []
        moved = 0
        try:
            for pr in bundle.live:
                r = pr.req
                need = PageAllocator.pages_needed(len(r.prompt) + r.max_new_tokens, self.cfg.page_size)
                new_pages: List[int] = []
                fresh: List[int] = []  # allocated for this request
                fresh_old: List[int] = []  # ... and entered in old2new
                try:
                    for j in range(need):
                        old = pr.old_pages[j] if j < len(pr.old_pages) else None
                        if old is not None and old in old2new:
                            new_pages.append(old2new[old])
                            continue
                        got = self._alloc_pages(1)[0]
                        fresh.append(got)
                        if old is not None:
                            old2new[old] = got
                            fresh_old.append(old)
                        new_pages.append(got)
                except BaseException:
                    # this request's own pages; seated ones are unwound below
                    self.allocator.free(fresh)
                    for old in fresh_old:
                        old2new.pop(old, None)
                    raise
                if self.prefix_cache is not None:
                    # one reference per sequence, as an admission takes
                    self.prefix_cache.acquire(new_pages)
                seated.append((pr, new_pages))
            if bundle.page_ids:
                pairs = [(i, old2new[p]) for i, p in enumerate(bundle.page_ids) if p in old2new]
                moved = parked_mod.scatter_pages_h2d(self.pool, pairs, bundle.k_host, bundle.v_host,
                                                     bucket_bytes=bucket_bytes, span_name="wake.kv_pagein")
        except BaseException as e:
            for _, new_pages in seated:
                if self.prefix_cache is not None:
                    self.allocator.free(self.prefix_cache.release(new_pages))
                else:
                    self.allocator.free(new_pages)
            self._waiting.extend(bundle.waiting)
            self._dirty = True
            raise parked_mod.ParkedResumeFailed(f"{type(e).__name__}: {e}") from e
        # nothing below can fail: host bookkeeping
        for pr, new_pages in seated:
            r = pr.req
            slot = self._free_slot()
            assert slot is not None, "the parked batch exceeds max_batch"
            r.slot = slot
            r.pages = new_pages
            r.shared_pages = 0
            r._prefix_hashes = ()
            self._slots[slot] = r
            row = np.zeros((self.cfg.pages_per_seq,), dtype=np.int32)
            row[: len(new_pages)] = new_pages
            self._page_table[slot] = row
            self._positions[slot] = r.pos
            self._last_tokens[slot] = r.out_tokens[-1] if r.out_tokens else 0
            self._temps[slot] = r.temperature
            self._topps[slot] = r.top_p
            self._pres[slot] = r.presence_penalty
            self._freqs[slot] = r.frequency_penalty
            self._token_counts[slot] = pr.counts_row
            self._budgets[slot] = r.max_new_tokens - len(r.out_tokens)
            self._eos_on[slot] = 0 if r.ignore_eos else 1
            self._bias[slot] = 0.0
            for t, v in r.logit_bias.items():
                self._bias[slot, t] = v
            if r.temperature > 0 and parked_mod.key_kind(pr.key_data) == "torch":
                gen = torch.Generator(device=self.device)
                gen.set_state(torch.from_numpy(np.ascontiguousarray(pr.key_data, dtype=np.uint8)))
                self._gens[slot] = gen
            else:
                # a greedy stream draws nothing (the service refuses a
                # sampled one whose key is the reference's)
                self._init_slot_gen(r)
        self._waiting = list(bundle.waiting) + self._waiting
        self._dirty = True
        return len(seated), moved

    # -- convenience --------------------------------------------------------

    def generate(
        self,
        prompts: Seq[Seq[int]],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
    ) -> List[List[int]]:
        ids = [self.add_request(p, max_new_tokens, temperature) for p in prompts]
        results: Dict[int, List[int]] = {}
        while self.has_work():
            for req in self.step():
                results[req.seq_id] = req.out_tokens
        return [results[i] for i in ids]
