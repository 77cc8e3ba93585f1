"""The port's engine HTTP server, on the standard library.

Port of ``llm_d_fast_model_actuation_tpu/engine/server.py``: one engine
thread fed by a submit queue, and the routes

  GET  /health, /is_sleeping, /v1/models, /v1/stats, /v1/swap, /v1/faults,
       /v1/prefetch, /v1/costs, /v1/actuations, /metrics, /v1/traces,
       /v1/profile
  POST /sleep?level=1|2, /wake_up, /v1/completions, /v1/chat/completions,
       /v1/swap, /v1/faults, /v1/prefetch, /v1/profile
  DELETE /v1/faults, /v1/prefetch, /v1/profile

and one of the port's own, ``GET /v1/device``: the card the engine runs
on as the CUDA runtime names it, the kernel launches of this process and
its memory (:meth:`EngineService.device_info`), for a caller that did not start the
process itself, such as a launcher's client.

with the reference's flag names for the flags it keeps, among them
``--packed-serving on|off``, ``--token-budget``, ``--attention-impl``,
``--tensor-parallel-size N`` (one process drives the ``N`` ranks; with it
``--device`` takes a comma-separated list of ``N`` devices, which may name
one device more than once, and a single ``cuda`` means the first ``N``
cards), ``--tokenizer`` and ``--eos-token-id``.

``--model`` takes a named config (random weights from ``--seed``) or
``hf:<dir>``, a Hugging Face checkpoint directory: its ``config.json``,
its eos ids (all of them, ``generation_config.json`` too) and its
tokenizer, and its weights written into the engine's arena before the
decode chunk's graphs are captured (``models/hf.py``); a level-2 wake
reads the directory again. The tokenizer is the directory's (or
``--tokenizer``'s) when it has tokenizer files, which needs
``transformers``; else the byte-level fallback of the reference.

Requests take token-id or string prompts, token-id or string stops,
``stream`` (server-sent events, written as chunked responses by the
handler itself), ``logprobs`` and ``top_logprobs`` of the generated
tokens, ``echo`` (with ``logprobs``, the prompt's logprobs too: the
request bypasses the prefix cache and runs the bucketed prefill, also on
the packed path), ``n``, ``seed``, ``ignore_eos``, ``logit_bias`` and
``stop_token_ids``; their JSON and SSE shapes are the reference's. Not
ported yet, and answered with a 400 that says so: the other routes of the
reference (``UNPORTED_ROUTES``: parked, residents). Not ported yet and
absent from the options: the reference's
other engine flags (``--pipeline-decode``, ``--speculative-ngram``,
``--quantization``, ``--resident-variants``, multi-host gangs, ...), also
where the reference combines them with tensor parallelism.

**Model hot-swap** (``POST /v1/swap {"model": ..., "request_id": ...}``),
the reference's verb: the engine changes the model it serves without a
restart. The outgoing model sleeps into a host pool (``--model-pool-mib``,
``engine/model_pool.py``) while the incoming one comes back from it
(``engine/sleep.py:swap_states``: overlapped, and by digest only the delta
between siblings moves, ``--content-hash``), or is built cold (a named
config, an ``hf:`` directory, or weights rebuilt from the pool's chunk
tiers, ``--pool-disk-dir``). Each model keeps its own engine, its arenas
and its captured graphs, so a swap back re-captures nothing. A failed
transfer rolls back (503, ``/health`` DEGRADED until the next committed
swap); ``GET /v1/swap`` is the last committed swap, and a repeated
``request_id`` replays it. The fault points of ``utils/faults.py`` are armed
by ``--faults``, ``FMA_FAULTS`` or ``/v1/faults``. Not ported: a swap on a
tensor-parallel mesh and an Orbax ``checkpoint_dir`` (400s that say so),
and zero-drain parking.

**Compressed actuation** (``--sleep-quant int8|fp8``, ``models/quant.py``):
a level-1 sleep quantizes the layer weight stacks on the card and moves
only their payloads, a wake dequantizes them on the card into the
engine's own tensors, a swap moves quantized payloads both ways (a
full-precision pool entry crosses as a copy quantized on the host), and a
prefetch stages payloads, so the pool holds about 1.5 times fewer bytes
per model. Lossy once: the first quantized offload rounds the weights,
later cycles reproduce the same bits. ``--sleep-quant-hot-head on`` (the
default) keeps ``embed`` and ``lm_head`` at full precision. The swap
response, ``GET /v1/swap`` and ``/v1/stats`` (``quant`` block) report the
mode, ``bytes_full`` and ``bytes_saved_quant``. With
``--tensor-parallel-size`` above 1 the flag is refused (ROADMAP queue 1
item 14).

**The cost oracle** (``utils/costs.py``): every sleep, wake, swap window,
cold load and prefetch feeds per-kind bandwidth EWMAs, and every sleep,
wake and swap leaves a flight-recorder row with its prediction and its
actual bytes and seconds. ``GET /v1/costs`` (``?model=`` adds a
candidate) prices a sleep, a wake and a swap to each candidate (the
serving model, each pooled or prefetched model, each evicted model the
chunk tiers still hold) before a byte moves: a pool-tier swap's
``predicted_bytes`` comes from the ``plan_swap`` that the swap executes,
so it equals the swap's ``bytes_moved``. ``GET /v1/actuations``
(``?n=&kind=``) serves the recorder, and ``/v1/stats`` its summary
(``costs``). The reference's rows for migration, attach and detach wait
for those verbs (ROADMAP queue 1 items 11 and 12).

**Cold load, prefetch and warm-up.** A checkpoint is read by
``--load-workers`` readers over its shards (``models/hf.py``), and a
build's chunk graphs are captured once its weights are written
(``engine/exec_pool.py:warm_up``, with ``--warmup-buckets`` prefill
buckets run once); its digests are hashed after the load beside the
captures and serving, off the build's path, and joined only where they
are read (pooling, a swap's delta plan, a sleep; ``/v1/stats`` reports
them once they are done). ``POST /v1/prefetch {"model": "hf:<dir>"}``
stages a checkpoint on the host (pinned, throttled by
``--prefetch-mib-s``, abortable by ``DELETE /v1/prefetch``, its state at
``GET /v1/prefetch``) into the model pool without touching the card, and
the first swap to it is tier ``prefetched``: no checkpoint read, the
staged weights copied to the card and the graphs captured after them. Pooled engines keep their graphs
within ``--exec-pool-mib`` of the card (``ExecutablePool``); over it the
least recently pooled engine's graphs are released and captured again
when it serves again.

**Observability.** ``GET /metrics`` is the reference's catalog in the
Prometheus text format (``engine/metrics.py``, written by hand in
``utils/prom.py``; the families of features the port lacks are left
out), its gauges refreshed from host-side counters at the scrape, which
never reads the device. ``GET /v1/traces`` (``?format=chrome|tree``,
``trace_id``, ``clear``) exports this process's spans
(``utils/tracing.py``): ``engine.start`` (parented on
``FMA_TRACEPARENT``), ``engine.build_runtime``, ``engine.sleep``,
``engine.wake``, ``engine.swap``, ``engine.prefetch`` with the cost
oracle's ``predicted_bytes`` and ``predicted_s``, the bucket spans of
``engine/sleep.py``, the loader's and the warm-up's, ``step.packed``, and
the request traces: ``--trace-requests`` head-samples them, a client's
``traceparent`` forces one, and a request that violated an SLO
(``--slo-ttft-ms``, ``--slo-tpot-ms``) or was aborted keeps its spans
(tail-keep); ``/v1/stats.slo_exemplars`` lists the last violations with
their trace ids. Every admin route runs under the caller's
``traceparent``, carried to the engine thread. ``POST /v1/profile``
starts a ``torch.profiler`` capture (CPU and CUDA activities, started and
stopped on the engine thread, whose operators it then records), one at a
time (409 otherwise); ``DELETE`` stops it and writes its Chrome trace
under ``log_dir``; ``GET`` says whether one runs.

Run: ``python -m llm_d_fast_model_actuation_tpu_torch.engine.server
--model llama3-8b`` or ``--model hf:/path/to/model`` (on the card;
``--device cpu`` to run on the CPU; ``--tensor-parallel-size 2`` on two
cards, or with ``--device cuda:0,cuda:0`` as two ranks on one). The
launcher's child runs :func:`run_server` on the options string of its
instance, parsed by :func:`parse_engine_options` as the reference parses
it; it serves until SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextvars
import dataclasses
import gc
import json
import math
import os
import queue
import shlex
import signal
import threading
import time
import traceback
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import torch

from ..models import hf as hf_models
from ..models import llama
from ..models import quant as transfer_quant
from ..ops.cuda import kernel_launches
from ..ops.cuda.ragged import PAGE_SIZES
from ..parallel.mesh import serving_mesh
from ..utils import faults, tracing
from ..utils.costs import CostBook
from ..utils.prom import exposition
from . import metrics as fm
from . import tokenizer as tokenizer_mod
from .chunk_store import ChunkStore, DigestJob, default_disk_dir, flatten_state, map_leaves
from .engine import ATTENTION_IMPLS, EngineConfig, InferenceEngine, validate_logit_bias
from .exec_pool import ExecutablePool, exec_key, parse_warmup_buckets
from .graphs import release_cached_memory
from .kv_cache import PageAllocator, PagePool
from .model_pool import HostModelPool, PrefetchedWeights
from .sleep import SleepManager, SwapRolledBack, attach_sleep, fresh_state, plan_swap, swap_states

MODEL_CONFIGS = {
    "tiny": llama.LlamaConfig.tiny,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "llama3-70b": llama.LlamaConfig.llama3_70b,
    "tiny-gemma": llama.LlamaConfig.tiny_gemma,
    "gemma3-4b": llama.LlamaConfig.gemma3_4b,
    "qwen2-7b": lambda: llama.LlamaConfig(
        vocab_size=152064,
        hidden_size=3584,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        rope_theta=1e6,
        max_seq_len=32768,
    ),
    "tinyllama-1.1b": lambda: llama.LlamaConfig(
        vocab_size=32000,
        hidden_size=2048,
        num_layers=22,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        intermediate_size=5632,
        rope_theta=10000.0,
        max_seq_len=2048,
    ),
    "bench-1b": lambda: llama.LlamaConfig(
        vocab_size=32000,
        hidden_size=2048,
        num_layers=24,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=5632,
        rope_theta=10000.0,
        max_seq_len=2048,
    ),
}

#: routes of the reference server this port does not serve yet, matched
#: with everything under them (``/v1/parked/claims/{id}``, ...): zero-drain
#: parking (ROADMAP queue 1 item 11) and co-resident variants (item 12)
UNPORTED_ROUTES = ("/v1/parked", "/v1/residents")


def unported_route(path: str) -> bool:
    """Whether ``path`` is one of :data:`UNPORTED_ROUTES` or under one."""
    return any(path == r or path.startswith(r + "/") for r in UNPORTED_ROUTES)


def make_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fma-torch-engine", exit_on_error=False)
    p.add_argument("--model", default="tiny", help="a named config, or hf:<model-dir>")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-model-len", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eos-token-id", type=int, default=-1)
    p.add_argument(
        "--tokenizer", default="",
        help="HF tokenizer directory (text prompts, chat templates, stop "
        "strings, response text). Defaults to the hf: model directory when "
        "it ships tokenizer files; otherwise a byte-level fallback",
    )
    p.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu; with --tensor-parallel-size N > 1 also a "
        "comma-separated list of N devices, one per rank (a device may repeat: "
        "cuda:0,cuda:0), where a single cuda means the first N cards",
    )
    p.add_argument(
        "--tensor-parallel-size", type=int, default=1,
        help="shard the model and the KV cache over this many ranks, all "
        "driven by this one process",
    )
    p.add_argument(
        "--attention-impl", default="auto", choices=list(ATTENTION_IMPLS),
        help="decode cache-write strategy: reference = scatter-first, "
        "the others inline (auto = grouped); the kernels follow the device",
    )
    p.add_argument(
        "--packed-serving", choices=["on", "off"], default="off",
        help="token-packed mixed-batch serving: whenever prompt work is "
        "pending, one forward over a flat [token-budget] buffer packs "
        "prefill segments AND a decode row per running sequence (ragged "
        "paged attention). off (default) keeps the bucketed path",
    )
    p.add_argument(
        "--token-budget", type=int, default=0,
        help="row capacity of the packed buffer (--packed-serving). 0 = "
        "auto (256, floored so every decode slot plus one prefill block fits)",
    )
    p.add_argument(
        "--model-pool-mib", type=int, default=4096,
        help="pinned-host byte budget (MiB) for the slept-model pool backing "
        "POST /v1/swap: models swapped out stay host-resident up to this "
        "budget so swapping back re-reads no checkpoint; 0 disables pooling "
        "(every swap-in is a cold build)",
    )
    p.add_argument(
        "--pool-disk-dir", default="",
        help="local-disk spill tier below the host model pool: weight chunks "
        "whose last pooled reference is evicted spill here (atomic rename, "
        "content-verified reload), so a swap back to an evicted model rebuilds "
        "from local disk instead of re-reading its checkpoint. Defaults to "
        "FMA_POOL_SPILL_DIR; empty disables the tier",
    )
    p.add_argument(
        "--pool-disk-mib", type=int, default=4096,
        help="byte budget (MiB) for the model pool's disk spill tier (LRU "
        "beyond it); 0 disables the tier",
    )
    p.add_argument(
        "--content-hash", default="on", choices=["on", "off"],
        help="content-address pooled weights (sha256 per leaf, computed once "
        "at load): dedupes sibling fine-tune variants in the host pool and "
        "lets hot-swaps move only the delta between models sharing tensors. "
        "Off with --tensor-parallel-size > 1",
    )
    p.add_argument(
        "--sleep-quant", default="off", choices=list(transfer_quant.TRANSFER_MODES),
        help="compressed actuation: a level-1 sleep quantizes the weight stacks on "
        "the card to int8 (a scale per output channel) or fp8 (e4m3), only the "
        "payload crosses PCIe, and a wake dequantizes on the card; swaps and "
        "prefetches move and stage payloads too. Lossy once: the first "
        "quantized offload rounds the weights, every later cycle reproduces "
        "the same bits. off (default) keeps every transfer bit-exact. Refused "
        "with --tensor-parallel-size > 1",
    )
    p.add_argument(
        "--sleep-quant-hot-head", default="on", choices=["on", "off"],
        help="keep embed and lm_head at full precision under --sleep-quant (the "
        "default); off quantizes them too",
    )
    p.add_argument(
        "--swap-bucket-mib", type=int, default=256,
        help="transfer bucket size (MiB) for chunked sleep/wake and "
        "overlapped hot-swap: bounds the extra card memory and the in-flight "
        "window to about one bucket per direction (a bucket holds whole "
        "tensors, so never less than one)",
    )
    p.add_argument(
        "--exec-pool-mib", type=int, default=256,
        help="card byte budget (MiB) for pooled engines' captured chunk graphs "
        "(engine/exec_pool.py): over it the least recently pooled engine's "
        "graphs are released, and captured again when it serves again; 0 "
        "releases every pooled engine's graphs",
    )
    p.add_argument(
        "--warmup-buckets", default="",
        help="comma-separated prefill token buckets a build runs once while "
        "its weights arrive, beside its graph captures (rounded up to the "
        "engine's power-of-two buckets). Empty runs none",
    )
    p.add_argument(
        "--load-workers", type=int, default=0,
        help="parallel shard readers for a checkpoint's load and a prefetch "
        "(0 = auto: min(8, cpu count))",
    )
    p.add_argument(
        "--load-inflight-mib", type=int, default=512,
        help="pinned staging bytes (MiB) of a checkpoint's load, all readers' "
        "double buffers together",
    )
    p.add_argument(
        "--prefetch-mib-s", type=int, default=0,
        help="read rate (MiB/s) of a prefetch (POST /v1/prefetch), so staging "
        "the next model does not starve the serving one; 0 = unthrottled",
    )
    p.add_argument(
        "--slo-ttft-ms", type=float, default=0.0,
        help="TTFT SLO target in milliseconds (submit -> first token). Finished "
        "requests are judged against it (fma_engine_slo_requests_total{slo=ttft}) "
        "and only SLO-met requests count toward fma_engine_goodput_tokens_total; "
        "0 disables",
    )
    p.add_argument(
        "--slo-tpot-ms", type=float, default=0.0,
        help="time-per-output-token SLO target in milliseconds (mean inter-token "
        "time after the first token); judged per finished request like "
        "--slo-ttft-ms; 0 disables",
    )
    p.add_argument(
        "--trace-requests", type=float, default=0.0,
        help="head-sampling fraction [0, 1] for per-request lifecycle traces "
        "(request.* spans: queue, prefill and decode legs, kept in a trace ring "
        "of their own served by GET /v1/traces). SLO-violated and aborted "
        "requests keep their spans whatever the fraction (tail-keep), and a "
        "client traceparent traces its request. 0 (default) records nothing "
        "per request",
    )
    p.add_argument(
        "--faults", default="",
        help="arm fault-injection points at startup (utils/faults.py), e.g. "
        "'swap.h2d=fail:1'; also the FMA_FAULTS env and POST /v1/faults",
    )
    return p


def parse_engine_options(options: str) -> argparse.Namespace:
    """Parse an instance's options string as the reference does: split as
    a shell splits it (``shlex``: quotes and escapes, so an ``hf:`` path
    may hold a space), every unknown flag refused in one message; a bad
    value or model raises ValueError too."""
    try:
        args, unknown = make_arg_parser().parse_known_args(shlex.split(options or ""))
    except (argparse.ArgumentError, SystemExit) as e:
        raise ValueError(f"invalid engine options {options!r}: {e}")
    if unknown:
        raise ValueError(f"unknown engine options: {unknown}")
    check_engine_options(args)
    return args


def check_engine_options(args: argparse.Namespace) -> None:
    """The reference's checks of the options the port has; raises
    ValueError. An ``hf:`` directory is looked at when the engine starts,
    not here."""
    if args.model.startswith("hf:"):
        if not args.model[3:]:
            raise ValueError("--model hf: needs a directory path")
    elif args.model not in MODEL_CONFIGS:
        raise ValueError(f"unknown model {args.model!r}; known: {sorted(MODEL_CONFIGS)} or hf:<model-dir>")
    if args.token_budget < 0:
        raise ValueError("--token-budget must be >= 0, or 0 for auto")
    if args.swap_bucket_mib < 1:
        raise ValueError("--swap-bucket-mib must be >= 1")
    if args.exec_pool_mib < 0:
        raise ValueError("--exec-pool-mib must be >= 0")
    parse_warmup_buckets(args.warmup_buckets)
    if args.load_workers < 0:
        raise ValueError("--load-workers must be >= 0 (0 = auto)")
    if args.load_inflight_mib < 1:
        raise ValueError("--load-inflight-mib must be >= 1")
    if args.prefetch_mib_s < 0:
        raise ValueError("--prefetch-mib-s must be >= 0 (0 = unthrottled)")
    if args.faults:
        try:
            faults.parse_spec(args.faults)
        except ValueError as e:
            raise ValueError(f"--faults: {e}")
    if args.tensor_parallel_size < 1:
        raise ValueError("--tensor-parallel-size must be >= 1")
    if args.slo_ttft_ms < 0:
        raise ValueError("--slo-ttft-ms must be >= 0 (0 = off)")
    if args.slo_tpot_ms < 0:
        raise ValueError("--slo-tpot-ms must be >= 0 (0 = off)")
    if not 0.0 <= args.trace_requests <= 1.0:
        raise ValueError("--trace-requests must be in [0, 1]")
    if args.sleep_quant != "off":
        reason = transfer_quant.transfer_quant_supported(args.sleep_quant)
        if reason:
            raise ValueError(f"--sleep-quant {args.sleep_quant}: {reason}")
        if args.tensor_parallel_size > 1:
            raise ValueError(
                "--sleep-quant on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)"
            )
    devices = args.device.split(",")
    if len(devices) > 1 and len(devices) != args.tensor_parallel_size:
        raise ValueError(
            f"--device names {len(devices)} devices for --tensor-parallel-size "
            f"{args.tensor_parallel_size}"
        )
    on_card = any(d.split(":")[0] != "cpu" for d in devices)
    if args.packed_serving == "on" and on_card and args.page_size not in PAGE_SIZES:
        raise ValueError(
            f"--packed-serving on takes --page-size in {PAGE_SIZES} on the card (the ragged "
            f"kernel's), got {args.page_size}"
        )


def mesh_from_options(args: argparse.Namespace):
    """The tensor-parallel mesh the options ask for; None for one rank. A
    device list is taken as given; a single ``cuda`` means the first N
    cards and raises when there are fewer; a single other device is every
    rank's."""
    tp = args.tensor_parallel_size
    if tp == 1:
        return None
    devices = args.device.split(",")
    if len(devices) == 1:
        devices = None if devices[0] == "cuda" else devices * tp
    return serving_mesh(tp, devices)


def resolve_model(args: argparse.Namespace, model_id: str):
    """(model config, eos id, extra eos ids, hf directory or "",
    tokenizer) for ``model_id``, as the reference's ``_resolve_model``:
    an ``hf:`` directory gives its config and all its eos ids (the first
    is the engine's eos, the rest its extra ones) unless
    ``--eos-token-id`` names one; the tokenizer is ``--tokenizer``'s, else
    the directory's when it has tokenizer files, else bytes; as a last
    resort the tokenizer's own eos."""
    hf_dir = ""
    eos = args.eos_token_id
    extra: tuple = ()
    if model_id.startswith("hf:"):
        hf_dir = model_id[3:]
        model_cfg = hf_models.config_from_hf(hf_dir)
        if eos < 0:
            ids = hf_models.eos_token_ids_from_hf(hf_dir)
            if ids:
                eos, extra = ids[0], tuple(ids[1:])
    else:
        model_cfg = MODEL_CONFIGS[model_id]()
    tok_path = args.tokenizer or (hf_dir if hf_dir and tokenizer_mod.has_tokenizer_files(hf_dir) else "")
    tok = tokenizer_mod.load_tokenizer(tok_path)
    if eos < 0 and hf_dir:
        eos = tok.eos_token_id if tok.eos_token_id is not None else -1
    return model_cfg, eos, extra, hf_dir, tok


class ProfileConflict(Exception):
    """POST /v1/profile while a capture runs (the profiler is process
    global: one capture at a time), or DELETE with none: a 409."""


class _RateEWMA:
    """Exponentially decayed event rate (events/second), the reference's:
    each arrival adds ``1/tau``, the estimate decays by ``exp(-dt/tau)``
    between observations. Callers hold the service's lock."""

    def __init__(self, tau_s: float = 30.0) -> None:
        self.tau_s = tau_s
        self._rate = 0.0
        self._t: Optional[float] = None

    def _decay(self, now: float) -> None:
        if self._t is not None and now > self._t:
            self._rate *= math.exp(-(now - self._t) / self.tau_s)
        self._t = now if self._t is None or now > self._t else self._t

    def observe(self, now: float) -> None:
        self._decay(now)
        self._rate += 1.0 / self.tau_s

    def rate(self, now: float) -> float:
        self._decay(now)
        return self._rate


@dataclasses.dataclass
class _ModelRuntime:
    """Everything model-specific the service owns: swapping models means
    swapping this bundle. A pooled (slept) runtime keeps its engine, and
    with it its arenas (their addresses reserved, nothing mapped) and its
    captured chunk graphs, so a swap back re-captures nothing and reads no
    checkpoint."""

    model_id: str
    cfg: EngineConfig
    tokenizer: Any
    hf_dir: str
    engine: Any = None
    sleeper: Any = None
    #: flat weight key -> content digest, computed once at load (None for
    #: a named config's random weights, and with --content-hash off);
    #: read through :meth:`EngineService._digests`, which joins the job
    digests: Optional[Dict[str, str]] = None
    #: the load's digests while they are still being hashed, off the
    #: build's path (``chunk_store.DigestJob``)
    digest_job: Any = None
    #: the most recent load of the checkpoint (at the build, then at each
    #: level-2 wake), and how many there were; None for a named config
    load_stats: Optional[hf_models.LoadStats] = None
    loads: int = 0


class EngineService:
    """One engine plus its sleep manager, driven by one engine thread.
    The engine is built, its weights loaded or drawn, and on one card its
    chunk graphs captured, before the service takes a request.

    Requests enter through :meth:`submit` (any thread) and are resolved
    through futures. Sleep, wake and swap are handed to the engine thread
    too and run between engine steps; while asleep the loop does not step
    and new requests wait, and requests that arrive during a swap wait for
    the incoming model."""

    def __init__(self, args: argparse.Namespace) -> None:
        self.args = args
        faults.load_env()
        if getattr(args, "faults", ""):
            faults.arm_spec(args.faults)
        #: content-addressed weights: digests at load, the pool's dedup and
        #: the delta swap (off on a mesh, where swap is not ported)
        self._content_hash = args.content_hash == "on" and args.tensor_parallel_size == 1
        self._swap_bucket_bytes = args.swap_bucket_mib << 20
        #: compressed actuation (--sleep-quant): "off", "int8" or "fp8"
        self._sleep_quant = args.sleep_quant
        self._sleep_quant_hot_head = args.sleep_quant_hot_head != "off"
        #: the cost oracle: bandwidth EWMAs fed by every transfer, and the
        #: flight recorder of every actuation (GET /v1/costs, /v1/actuations)
        self.costs = CostBook(capacity=int(os.environ.get("FMA_FLIGHT_RECORDER_CAP", "512") or 512))
        self._warmup_buckets = parse_warmup_buckets(args.warmup_buckets)
        #: pinned host memory is in use (a prefetch stages into it)
        self._pin_host = torch.cuda.is_available()
        #: pooled engines' captured graphs, under a card budget
        self.exec_pool = ExecutablePool(budget_bytes=max(0, args.exec_pool_mib) << 20)
        #: the background prefetch (POST /v1/prefetch): one at a time
        self._prefetch_mu = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_abort = threading.Event()
        self.last_prefetch: Dict[str, Any] = {"state": "idle"}
        self.model_pool = HostModelPool(
            budget_bytes=max(0, args.model_pool_mib) << 20,
            chunks=ChunkStore(
                disk_dir=args.pool_disk_dir or default_disk_dir(),
                disk_budget_bytes=max(0, args.pool_disk_mib) << 20,
            ) if self._content_hash else None,
        )
        #: cold runtime builds (checkpoint read or random init); a pool hit
        #: on swap does not count
        self.builds_total = 0
        #: the last committed swap (GET /v1/swap, request_id replay)
        self.last_swap: Dict[str, Any] = {}
        #: a recoverable failure healed in-process (a rolled-back swap):
        #: /health stays 200 but reports DEGRADED until the next committed swap
        self.degraded: Optional[str] = None
        #: the transfer figures of the last build (what a cold swap reports)
        self._last_build_stats: Dict[str, Any] = {}
        #: each model's resolve_model answer, from its last build
        self._resolved: Dict[str, tuple] = {}
        #: guards a runtime's digests while their job is joined
        self._digest_mu = threading.Lock()
        # request-lifecycle SLO and goodput accounting: targets in seconds
        # (0 = off), counters guarded by _mu
        self._slo_ttft_s = max(0.0, getattr(args, "slo_ttft_ms", 0.0) or 0.0) / 1e3
        self._slo_tpot_s = max(0.0, getattr(args, "slo_tpot_ms", 0.0) or 0.0) / 1e3
        self._slo_met = self._slo_violated = self._goodput_tokens = 0
        #: request traces: head sampling at submit, tail-keep at the finish;
        #: each retained violation with its legs (/v1/stats.slo_exemplars)
        tracing.configure_request_sampling(getattr(args, "trace_requests", 0.0) or 0.0)
        self._slo_exemplars: deque = deque(maxlen=int(os.environ.get("FMA_SLO_EXEMPLARS", "16") or 16))
        #: the running torch.profiler capture (POST/DELETE /v1/profile)
        self._profile_mu = threading.Lock()
        self._profile: Any = None
        self._profile_dir: Optional[str] = None
        #: cumulative counters of the engines and pools, as last mirrored
        #: into Prometheus counters (the scrape adds what they grew by)
        self._seen: Dict[str, float] = {}
        # the startup span parents on FMA_TRACEPARENT when the spawning
        # launcher passed one: the first build joins the create's trace
        with tracing.span("engine.start", parent=tracing.env_context(), model=args.model, pid=os.getpid()):
            self._runtime = self._build_runtime(args.model)
        # the recorder's first row: the initial cold build ("restart" when
        # a supervising launcher spawned this child again)
        self._record_actuation(
            "coldload", args.model, trigger="restart" if os.environ.get("FMA_RESTARTED") else "startup",
            tier="cold", pred=None, actual_bytes=self._last_build_stats.get("bytes_in", 0),
            actual_s=self._last_build_stats.get("h2d_s", 0.0),
        )
        self.failure: Optional[str] = None
        self.started_at = time.monotonic()
        self._mu = threading.Lock()  # guards the queues and counters below
        self._pending: List[Tuple[Dict[str, Any], concurrent.futures.Future]] = []
        self._admin: List[Tuple[Any, concurrent.futures.Future]] = []
        self._futures: Dict[int, concurrent.futures.Future] = {}
        self._arrival = _RateEWMA()
        self._finished_requests = 0
        self._generated_tokens = 0
        self._aborted: Dict[str, int] = {}
        self._actuations: Dict[str, int] = {}
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="engine", daemon=True)
        self._thread.start()

    # -- model runtimes --------------------------------------------------------

    def _build_runtime(
        self,
        model_id: str,
        staged_params: Optional[Dict[str, Any]] = None,
        staged_digests: Optional[Dict[str, str]] = None,
        staged_quant: Optional[List[Any]] = None,
    ) -> _ModelRuntime:
        """:meth:`_build_runtime_impl` under an ``engine.build_runtime``
        span, ended (with the error) when the build raises."""
        with tracing.span("engine.build_runtime", model=model_id, checkpoint_dir="",
                          staged=staged_params is not None):
            return self._build_runtime_impl(model_id, staged_params, staged_digests, staged_quant)

    def _build_runtime_impl(
        self,
        model_id: str,
        staged_params: Optional[Dict[str, Any]] = None,
        staged_digests: Optional[Dict[str, str]] = None,
        staged_quant: Optional[List[Any]] = None,
    ) -> _ModelRuntime:
        """Cold-build an awake runtime for ``model_id``: config, tokenizer,
        engine (weights from the ``hf:`` directory, from ``staged_params``
        — a host tree rebuilt from the pool's chunk tiers, flat keys
        ``layers/wq`` nested, or a prefetch's, whose payloads
        ``staged_quant`` marks: they are dequantized on the card — or
        drawn from ``--seed``), its graphs captured, and its sleeper.
        Leaves the build's transfer figures in ``_last_build_stats`` and
        feeds the load's read and copy windows to the cost oracle."""
        args = self.args
        if staged_params is None or model_id not in self._resolved:
            # a build from the tiers reuses the model's config and
            # tokenizer: its directory may be gone
            self._resolved[model_id] = resolve_model(args, model_id)
        model_cfg, eos, extra_eos, hf_dir, tok = self._resolved[model_id]
        cfg = EngineConfig(
            model=model_cfg,
            max_batch=args.max_batch,
            page_size=args.page_size,
            num_pages=args.num_pages,
            max_seq_len=args.max_model_len,
            eos_token_id=eos,
            extra_eos_ids=extra_eos,
            attention_impl=args.attention_impl,
            packed_serving=args.packed_serving == "on",
            token_budget=args.token_budget,
        )
        rt = _ModelRuntime(model_id=model_id, cfg=cfg, tokenizer=tok, hf_dir=hf_dir)
        content_hash = self._content_hash

        def load(model) -> None:
            # the directory into the model's tensors in place; the digests
            # once, at the first load, hashed from the card beside what
            # follows (the captures, serving) and joined where read
            rt.load_stats = hf_models.load_params(
                hf_dir, model, workers=args.load_workers or None, max_inflight_bytes=args.load_inflight_mib << 20
            )
            if rt.loads == 0 and content_hash:
                rt.digest_job = DigestJob(hf_models.model_leaves(model))
            rt.loads += 1

        staged_stats = hf_models.LoadStats()

        def load_staged(model) -> None:
            hf_models.place_staged_params(staged_params, model, stats=staged_stats, quant_metas=staged_quant)

        mesh = mesh_from_options(args)
        t0 = time.monotonic()
        params = load_staged if staged_params is not None else (load if hf_dir else None)
        rt.engine = InferenceEngine(
            cfg, params=params, seed=args.seed,
            device=args.device if mesh is None else None, mesh=mesh,
            warmup_buckets=self._warmup_buckets,
        )
        if staged_params is not None:
            # the tiers or a prefetch served this build; a level-2 wake
            # reads the directory
            rt.engine._load = load if hf_dir else None
            rt.digests = dict(staged_digests) if content_hash and staged_digests else None
        rt.sleeper = attach_sleep(
            rt.engine, bucket_bytes=self._swap_bucket_bytes, quant_mode=self._sleep_quant,
            quant_hot_head=self._sleep_quant_hot_head, on_transfer=self.costs.observe_transfer,
        )
        state_bytes = sum(t.numel() * t.element_size() for t in rt.engine.model.parameters())
        state_bytes += rt.engine.pool.nbytes()
        if rt.engine.graphs is not None:
            self.exec_pool.note_compile(rt.engine.capture_s)
        load = rt.load_stats if staged_params is None else staged_stats
        for figure in load.transfer_figures() if load is not None else ():
            self.costs.observe_transfer(*figure)
        if load is not None and (hf_dir or staged_params is not None):
            for phase, v in (("read", load.read_s), ("convert", load.convert_s), ("h2d", load.h2d_s),
                             ("total", load.total_s)):
                fm.ENGINE_COLDLOAD_PHASE_SECONDS.labels(model=model_id, phase=phase).set(v)
            fm.ENGINE_COLDLOAD_OVERLAP_FRAC.labels(model=model_id).set(load.overlap_frac)
        warm = rt.engine.warmup_stats
        for program, secs in (warm.get("program_s") or {}).items():
            fm.ENGINE_WARMUP_SECONDS.labels(program=program).set(secs)
        self._last_build_stats = {
            "h2d_s": load.h2d_s if hf_dir or staged_params is not None else warm["load_s"],
            "bytes_in": state_bytes,
            "build_s": time.monotonic() - t0,
            "load_s": warm["load_s"],
            "read_s": load.read_s if load is not None else 0.0,
            "workers": load.workers if load is not None else 0,
            "capture_s": rt.engine.capture_s,
            "warmup": {k: warm[k] for k in ("programs", "compiled", "compile_s", "capture_s")},
        }
        self.builds_total += 1
        return rt

    def _digests(self, rt: _ModelRuntime) -> Optional[Dict[str, str]]:
        """A runtime's weight digests, joining their job if it still runs
        (a sleep or a swap must not unmap what it reads). The job stays on
        the runtime until it is joined, so every caller waits on it."""
        job = rt.digest_job
        if job is not None:
            digests = job.result()
            with self._digest_mu:
                if rt.digest_job is job:
                    rt.digests = dict(digests) or None
                    if rt.load_stats is not None:
                        rt.load_stats.digests = dict(digests)
                        rt.load_stats.digest_s, rt.load_stats.digest_times = job.seconds, job.times
                    rt.digest_job = None
        return rt.digests

    # the serving runtime's parts (``_runtime`` is set at start and by a
    # committed swap)

    @property
    def model(self) -> str:
        """The name of the model the service serves."""
        return self._runtime.model_id

    @property
    def engine(self) -> InferenceEngine:
        return self._runtime.engine

    @property
    def sleeper(self) -> SleepManager:
        return self._runtime.sleeper

    @property
    def tokenizer(self):
        return self._runtime.tokenizer

    @property
    def hf_dir(self) -> str:
        return self._runtime.hf_dir

    @property
    def cfg(self) -> EngineConfig:
        return self._runtime.cfg

    @property
    def load_stats(self) -> Optional[hf_models.LoadStats]:
        """The serving model's last checkpoint load (None for a named config)."""
        return self._runtime.load_stats

    @property
    def loads(self) -> int:
        return self._runtime.loads

    # -- engine thread --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._work.wait(timeout=0.5)
            self._work.clear()
            try:
                while not self._stop.is_set():
                    self._run_admin()
                    self._admit_pending()
                    if self.sleeper.is_sleeping or not self.engine.has_work():
                        break
                    for req in self.engine.step():
                        self._resolve(req)
                    self._observe_step()
            except Exception as e:  # noqa: BLE001 — the loop's boundary
                traceback.print_exc()
                with self._mu:
                    self.failure = f"{type(e).__name__}: {e}"
                self._fail_all(RuntimeError(self.failure))
                return

    def _run_admin(self) -> None:
        with self._mu:
            ops, self._admin = self._admin, []
        for fn, fut in ops:
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — reported to the caller
                fut.set_exception(e)

    def _admit_pending(self) -> None:
        with self._mu:
            batch, self._pending = self._pending, []
        for kw, fut in batch:
            try:
                sid = self.engine.add_request(**kw)
            except ValueError as e:
                fut.set_exception(e)
                continue
            self._futures[sid] = fut

    def _resolve(self, req) -> None:
        req.done_time = time.monotonic()
        fut = self._futures.pop(req.seq_id, None)
        # observed before the future resolves: the usage block reads the
        # trace id the trace's finish stamps
        if req.error:
            self._finish_request_trace(req, req.done_time, aborted=True)
        else:
            self._observe_finished(req)
        if fut is None or fut.done():
            return
        if req.error:
            fut.set_exception(RuntimeError(req.error))
        else:
            fut.set_result(req)

    def _count_abort(self, cause: str, n: int = 1) -> None:
        if n > 0:
            fm.ENGINE_ABORTS.labels(model=self.model, reason=cause).inc(n)
            with self._mu:
                self._aborted[cause] = self._aborted.get(cause, 0) + n

    # -- request observation (the engine thread) -------------------------------

    def _observe_finished(self, req) -> None:
        """A finished request's metrics, its SLO judgment (each enabled
        target on its own; goodput counts its tokens only when none was
        violated, so with no target set every request's count), its trace
        and, when it violated a target, an exemplar."""
        m = self.model
        now = req.done_time if req.done_time is not None else time.monotonic()
        ttft = None if req.first_token_time is None else req.first_token_time - req.submit_time
        if ttft is not None:
            fm.ENGINE_TTFT.labels(model=m).observe(ttft)
        if req.first_sched_time is not None:
            fm.ENGINE_QUEUE_WAIT.labels(model=m).observe(max(0.0, req.first_sched_time - req.submit_time))
        fm.ENGINE_E2E_LATENCY.labels(model=m).observe(now - req.submit_time)
        fm.ENGINE_PROMPT_TOKENS.labels(model=m).inc(len(req.prompt))
        gen = len(req.out_tokens)
        fm.ENGINE_GENERATED_TOKENS.labels(model=m).inc(gen)
        met_all, evaluated, violated_slos = True, False, []
        if self._slo_ttft_s > 0:
            ok = ttft is not None and ttft <= self._slo_ttft_s
            fm.ENGINE_SLO_REQUESTS.labels(model=m, slo="ttft", outcome="met" if ok else "violated").inc()
            if not ok:
                violated_slos.append("ttft")
            met_all, evaluated = met_all and ok, True
        if self._slo_tpot_s > 0:
            if req.first_token_time is not None and gen > 1:
                ok = (now - req.first_token_time) / (gen - 1) <= self._slo_tpot_s
            else:
                # one token (or none) has no inter-token time to judge
                ok = req.first_token_time is not None
            fm.ENGINE_SLO_REQUESTS.labels(model=m, slo="tpot", outcome="met" if ok else "violated").inc()
            if not ok:
                violated_slos.append("tpot")
            met_all, evaluated = met_all and ok, True
        if met_all:
            fm.ENGINE_GOODPUT_TOKENS.labels(model=m).inc(gen)
        violated = evaluated and not met_all
        trace_id = self._finish_request_trace(req, now, violated=violated)
        with self._mu:
            self._finished_requests += 1
            self._generated_tokens += gen
            if met_all:
                self._goodput_tokens += gen
            if evaluated:
                if met_all:
                    self._slo_met += 1
                else:
                    self._slo_violated += 1
            if violated and trace_id:
                self._slo_exemplars.append({
                    "trace_id": trace_id, "model": m, "violated": violated_slos,
                    "ttft_s": None if ttft is None else round(ttft, 6),
                    "legs": {k: round(v, 6) for k, v in _request_legs(req, now).items()},
                })

    def _finish_request_trace(self, req, now: float, violated: bool = False, aborted: bool = False) -> str:
        """Close a request's lifecycle trace: keep it when it was
        head-sampled or violated an SLO or was aborted (with
        ``--trace-requests 0`` such a request gets a trace made here from
        its stamps), with one span for the whole decode window, never one
        per step; stamp ``req.trace_id``. Returns the trace id when the
        spans were kept, else ""."""
        if getattr(req, "_trace_done", False):
            return req.trace_id
        req._trace_done = True
        tr = req.trace
        if tr is None:
            if not (violated or aborted) or not tracing.enabled():
                return ""
            tr = tracing.RequestTrace(sampled=True)
            if req.first_sched_time is not None:
                tr.add("request.queue", req.submit_time, req.first_sched_time)
                tr.add("request.prefill", req.first_sched_time,
                       req.first_token_time if req.first_token_time is not None else now,
                       prompt_tokens=len(req.prompt), cached_tokens=req.cached_tokens, synthesized=True)
        if req.first_token_time is not None and now > req.first_token_time:
            tr.add("request.decode", req.first_token_time, now, tokens=len(req.out_tokens),
                   finish_reason=req.finish_reason or "")
        keep = tr.sampled or violated or aborted
        tid = tr.finish(req.submit_time, now, keep, outcome="aborted" if aborted else "finished",
                        violated=bool(violated), prompt_tokens=len(req.prompt), tokens=len(req.out_tokens),
                        preempt_s=0.0)
        req.trace = None
        req.trace_id = tid if keep else ""
        return req.trace_id

    def _observe_step(self) -> None:
        """After each engine step: KV usage, decode-slot occupancy, the
        packed step's tokens, and the engine's cumulative per-path byte
        counters mirrored into their counters."""
        eng = self.engine
        m = self.model
        alloc = eng.allocator
        total = max(1, alloc.num_pages - 1)
        fm.ENGINE_KV_USAGE.labels(model=m).set((total - alloc.available) / total)
        fm.ENGINE_SLOT_OCCUPANCY.labels(model=m).set(
            sum(1 for s in eng._slots if s is not None) / max(1, eng.cfg.max_batch))
        stats = eng.last_step_stats
        if stats is not None and stats.get("mode") == "packed":
            fm.ENGINE_PACKED_TOKENS.labels(model=m).observe(stats["tokens"])
        for family, totals in ((fm.ENGINE_PAD_WASTE_BYTES, eng.pad_waste_bytes),
                               (fm.ENGINE_STEP_H2D_BYTES, eng.step_h2d_bytes)):
            for path, value in totals.items():
                self._mirror(family.labels(model=m, path=path), f"{family.name}/{path}", value)

    def _mirror(self, child, key: str, total: float) -> None:
        """Add what the cumulative ``total`` grew by since the last call
        to the counter ``child``; a total that went back (a swap installed
        an engine whose counters start at 0) restarts the mirror."""
        seen = self._seen.get(key, 0)
        if total > seen:
            child.inc(total - seen)
        self._seen[key] = total

    def _fail_all(self, exc: BaseException) -> None:
        with self._mu:
            batch = self._pending + self._admin
            self._pending, self._admin = [], []
        for _, fut in batch:
            fut.set_exception(exc)
        for fut in self._futures.values():
            if not fut.done():
                fut.set_exception(exc)
        self._futures.clear()

    def _on_loop(self, fn, wait: bool = True) -> Any:
        """Run ``fn`` on the engine thread between steps, in a copy of the
        caller's context (its span is the parent of ``fn``'s); wait for
        it."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        ctx = contextvars.copy_context()
        with self._mu:
            if self.failure is not None:
                raise RuntimeError(self.failure)
            self._admin.append((lambda: ctx.run(fn), fut))
        self._work.set()
        return fut.result() if wait else None

    # -- API ------------------------------------------------------------------

    def submit(self, trace_ctx: "tracing.SpanContext | None" = None, **kw) -> concurrent.futures.Future:
        """Enqueue one request (``InferenceEngine.add_request`` keywords).
        ``trace_ctx``, a client's ``traceparent``, traces the request
        (whatever ``--trace-requests`` says) under the client's span; with
        neither, nothing per request is recorded."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        now = time.monotonic()
        kw.setdefault("submit_time", now)
        if tracing.enabled() and (trace_ctx is not None or tracing.request_sampling() > 0.0):
            kw["trace"] = tracing.RequestTrace(sampled=trace_ctx is not None or tracing.sample_request(),
                                               parent=trace_ctx)
        with self._mu:
            self._arrival.observe(now)
            if self.failure is not None:
                fut.set_exception(RuntimeError(self.failure))
                return fut
            self._pending.append((kw, fut))
        self._work.set()
        return fut

    def abort(self, fut: concurrent.futures.Future) -> None:
        """The client went away or its stop string matched: stop
        generating for the request of ``fut``, at the engine thread's next
        turn, and fail the future. Does not wait."""

        def drop():
            with self._mu:
                kept = [(kw, f) for kw, f in self._pending if f is not fut]
                gone = len(self._pending) - len(kept)
                self._pending = kept
            for sid, f in list(self._futures.items()):
                if f is fut:
                    self.engine.abort(sid, "aborted by the client")
                    del self._futures[sid]
                    gone += 1
            self._count_abort("client", gone)
            if not fut.done():
                fut.set_exception(RuntimeError("request aborted"))

        try:
            self._on_loop(drop, wait=False)
        except RuntimeError:  # the loop has failed: every future has too
            pass

    def queue_depth(self) -> int:
        """Waiting and running requests."""
        eng = self.engine
        with self._mu:
            pending = len(self._pending)
        return pending + len(eng._waiting) + sum(1 for s in eng._slots if s is not None)

    def sleep(self, level: int) -> Dict[str, Any]:
        if level not in (1, 2):
            raise ValueError("sleep level must be 1 or 2")

        def go():
            self._digests(self._runtime)  # the digest job reads the card
            was_sleeping, prev_level = self.sleeper.is_sleeping, self.sleeper.level
            # a level-1 offload is priced; a level-2 sleep discards
            pred = self._priced(self.price_sleep) if level == 1 and not was_sleeping else None
            t0 = time.monotonic()
            with tracing.span("engine.sleep", level=level, model=self.model) as sp:
                if pred is not None:
                    sp.set(predicted_bytes=pred.get("predicted_bytes"), predicted_s=pred.get("predicted_s"))
                out = self.sleeper.sleep(level)
            sleep_s = time.monotonic() - t0
            if out.get("bytes_offloaded") and not was_sleeping:
                fm.ENGINE_ACTUATION_BYTES.labels(mode=out.get("quant", "off") or "off", dir="d2h").inc(
                    out["bytes_offloaded"])
            if not was_sleeping:
                if int(self.sleeper.level) == 1:
                    fm.ENGINE_ACTUATION_SECONDS.labels(kind="sleep", phase="d2h").observe(
                        max(0.0, self.sleeper.stats.last_sleep_transfer_s))
                fm.ENGINE_ACTUATION_SECONDS.labels(kind="sleep", phase="total").observe(sleep_s)
            if not was_sleeping or self.sleeper.level != prev_level:
                self._bump_actuation("sleep")
                priced = pred is not None and int(self.sleeper.level) == 1
                self._record_actuation(
                    "sleep", self.model,
                    # an L1 -> L2 change while asleep drops the host copy
                    trigger="escalation" if was_sleeping else "client",
                    tier="host" if int(self.sleeper.level) == 1 else "discard",
                    pred=pred if priced else None,
                    actual_bytes=out.get("bytes_offloaded", 0),
                    actual_s=self.sleeper.stats.last_sleep_transfer_s if priced else (0.0 if was_sleeping else sleep_s),
                )
            return out

        return self._on_loop(go)

    def wake_up(self) -> Dict[str, Any]:
        def wake():
            if not self.sleeper.is_sleeping:
                return self.sleeper.wake_up()
            pred = self._priced(self.price_wake)
            was_l1 = self.sleeper.level == 1
            if self.sleeper.level == 2:
                # the KV state is gone: fail whatever was mid-generation,
                # then write the weights (the checkpoint reread, or drawn
                # from the seed) and a zero pool in place
                aborted = self.engine.abort_all("level-2 sleep discarded state")
                self._count_abort("state_loss", len(aborted))
                for req in aborted:
                    self._resolve(req)
            with tracing.span("engine.wake", model=self.model) as sp:
                if pred is not None:
                    sp.set(predicted_bytes=pred.get("predicted_bytes"), predicted_s=pred.get("predicted_s"))
                if was_l1:
                    out = self.sleeper.wake_up()
                else:
                    out = self.sleeper.wake_up(reinit=lambda: fresh_state(self.engine))
            self._bump_actuation("wake")
            st = self.sleeper.stats
            if was_l1 and st.last_wake_bytes:
                fm.ENGINE_ACTUATION_BYTES.labels(mode=st.last_quant or "off", dir="h2d").inc(st.last_wake_bytes)
            if was_l1 and st.last_wake_transfer_s > 0:
                fm.ENGINE_ACTUATION_SECONDS.labels(kind="wake", phase="h2d").observe(st.last_wake_transfer_s)
            fm.ENGINE_ACTUATION_SECONDS.labels(kind="wake", phase="total").observe(max(0.0, st.last_wake_seconds))
            self._record_actuation(
                "wake", self.model, trigger="client", tier="host" if was_l1 else "cold",
                # a level-2 wake writes fresh weights: outside the pricing
                pred=pred if was_l1 else None,
                actual_bytes=st.last_wake_bytes if was_l1 else 0,
                actual_s=st.last_wake_transfer_s if was_l1 else st.last_wake_seconds,
            )
            return out

        return self._on_loop(wake)

    # -- model hot-swap ----------------------------------------------------------

    def swap(self, model: str, checkpoint_dir: str = "", request_id: str = "") -> Dict[str, Any]:
        """POST /v1/swap: change the model this card serves, on the engine
        thread between steps (:meth:`_swap_impl`). Raises ValueError for a
        request the service refuses (a 400), :class:`SwapRolledBack` for a
        rolled-back transfer (a 503)."""
        if checkpoint_dir:
            raise ValueError(
                "an Orbax checkpoint_dir is not ported yet (ROADMAP queue 1 item 2); "
                "name a Hugging Face directory as the model, hf:<dir>"
            )
        if self.args.tensor_parallel_size > 1:
            raise ValueError("model hot-swap on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)")
        if model.startswith("hf:"):
            if not model[3:]:
                raise ValueError("swap model hf: needs a directory path")
        elif model not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {model!r}; known: {sorted(MODEL_CONFIGS)} or hf:<model-dir>")
        return self._on_loop(lambda: self._priced_swap(model, request_id))

    def _priced_swap(self, model: str, request_id: str) -> Dict[str, Any]:
        """:meth:`_swap_impl`, priced just before it runs (on the engine
        thread, so nothing moves in between) and recorded after it: a
        committed swap with its bytes and seconds, a rolled-back or failed
        one with none (a refusal moved nothing and is not recorded)."""
        replay = request_id and self.last_swap.get("request_id") == request_id
        pred = None if replay or model == self.model else self._priced(lambda: self.price_swap(model))

        def record_failure(outcome: str) -> None:
            self._record_actuation(
                "swap", model, trigger="client", tier=pred.get("tier", "") if pred else "",
                pred=pred, actual_bytes=0, actual_s=0.0, outcome=outcome,
            )

        def recovery(path: str) -> None:
            fm.ENGINE_RECOVERIES.labels(path=path, outcome="rolled_back" if self.failure is None
                                        else "rollback_failed").inc()

        with tracing.span("engine.swap", model=model, previous=self.model, request_id=request_id) as sp:
            if pred is not None:
                sp.set(predicted_bytes=pred.get("predicted_bytes"), predicted_s=pred.get("predicted_s"),
                       predicted_tier=pred.get("tier"))
            try:
                out = self._swap_impl(model, request_id)
            except SwapRolledBack:
                recovery("swap")
                record_failure("rolled_back")
                raise
            except ValueError as e:
                # a refusal moved nothing and leaves no trace; a build that
                # failed after the outgoing model slept may raise a
                # ValueError too, and is marked so
                if getattr(e, "fma_swap_actuated", False):
                    recovery("swap_cold")
                    record_failure("failed")
                raise
            except Exception as e:
                recovery("swap_cold" if getattr(e, "fma_swap_actuated", False) else "swap")
                record_failure("failed")
                raise
            if out.get("swapped") and not out.get("replayed"):
                sp.set(pool_hit=bool(out.get("pool_hit")), tier=out.get("tier", ""),
                       bytes_moved=out.get("bytes_moved", 0))
                self._observe_swap(model, out)
        if out.get("swapped") and not out.get("replayed"):
            rec = self._record_actuation(
                "swap", model, trigger="client", tier=out.get("tier", ""), pred=pred,
                actual_bytes=out.get("bytes_moved", 0), actual_s=out.get("swap_total_s", 0.0),
            )
            out["costs"] = self.last_swap["costs"] = rec.as_dict()
        return out

    def _abort_for_swap(self, previous: str, model: str) -> None:
        """Fail the queued and the in-flight requests: they target the
        outgoing model. An idle engine's prefix cache survives the swap
        (its pages move bit-exact)."""
        exc = RuntimeError(f"aborted by model swap ({previous} -> {model})")
        with self._mu:
            queued, self._pending = self._pending, []
        for _, fut in queued:
            if not fut.done():
                fut.set_exception(exc)
                self._count_abort("swap")
        if self.engine.has_work():
            aborted = self.engine.abort_all(f"model swapped out for {model}")
            self._count_abort("swap", len(aborted))
            for req in aborted:
                fut = self._futures.pop(req.seq_id, None)
                if fut is not None and not fut.done():
                    fut.set_exception(exc)

    def _swap_impl(self, model: str, request_id: str = "") -> Dict[str, Any]:
        """The reference's ``_swap_impl`` (``tier``: ``pool`` for a slept
        runtime from the pool, ``prefetched`` for a prefetch's staged host
        weights, ``host`` or ``disk`` for weights rebuilt from the chunk
        tiers, ``cold`` for a build from the source):

          * a pool hit swaps the two states with :func:`swap_states`
            (overlapped; by digest only the delta moves); a failed
            transfer rolls back, re-pools the entry and raises
            :class:`SwapRolledBack` with the service DEGRADED, and a failed
            rollback fails the service. An engine whose graphs the exec
            pool released captures them again once its state is back; a
            re-capture that fails swaps the two back, as a rollback;
          * a miss, or prefetched weights, sleeps the outgoing model and
            builds the incoming one, its graphs captured once its weights
            are written; a failed build wakes the outgoing model again
            (DEGRADED), and weights staged on the host (a prefetch's, or
            rebuilt from the tiers) go back to the pool as prefetched;
          * the outgoing runtime is pooled, and what the pool evicts is
            destroyed (engine, graphs, arena range).

        A ``request_id`` equal to the last committed swap's replays it."""
        if request_id and self.last_swap.get("request_id") == request_id:
            # the caller lost the answer: swapping again would swap away
            return dict(self.last_swap, replayed=True)
        previous = self.model
        if model == previous:
            return {"model": model, "previous_model": previous, "checkpoint_dir": "", "swapped": False,
                    "pool": self.model_pool.describe()}
        if self.sleeper.is_sleeping:
            raise ValueError("engine is sleeping; wake_up before swapping models")
        t0 = time.monotonic()
        self._abort_for_swap(previous, model)
        outgoing = self._runtime
        out_digests = self._digests(outgoing)
        entry = self.model_pool.take_match(model)
        pool_hit = entry is not None
        prefetched = pool_hit and isinstance(entry.runtime, PrefetchedWeights)
        tier = "pool" if pool_hit and not prefetched else "cold"
        warm_stats = None
        if pool_hit and not prefetched:
            rt = entry.runtime
            # an engine without graphs (the CPU, a mesh) has none to keep
            kept = rt.engine.graphs is None or self.exec_pool.take(self._exec_key(entry.model_id, rt)) is not None
            digests = self._content_hash
            try:
                metrics = swap_states(
                    outgoing.sleeper, rt.sleeper, bucket_bytes=self._swap_bucket_bytes,
                    out_digests=out_digests if digests else None,
                    in_digests=self._digests(rt) if digests else None,
                    quant=self._sleep_quant,
                )
                metrics["d2h_transfer_s"], metrics["h2d_transfer_s"] = metrics["d2h_s"], metrics["h2d_s"]
                metrics["transfer_s"] = metrics["swap_total_s"]  # swap_states' own wall; the verb's below
            except ValueError:
                # refused before any transfer: the entry goes back intact
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                raise
            except SwapRolledBack as e:
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                self.degraded = f"hot-swap {previous}->{model} rolled back: {e}"
                raise
            except Exception as e:
                # the rollback failed: the state is partially moved
                self.failure = f"hot-swap {previous}->{model} failed mid-transfer: {type(e).__name__}: {e}"
                self._fail_all(RuntimeError(self.failure))
                raise
            # graphs the exec pool released are captured again, now that
            # the engine's state is mapped and back
            metrics["graphs_kept"] = kept
            try:
                metrics["recapture_s"] = rt.engine.recapture() if not kept else 0.0
            except Exception as capture_exc:
                # the incoming model cannot serve: the outgoing one goes
                # back, as a failed transfer rolls back
                try:
                    swap_states(
                        rt.sleeper, outgoing.sleeper, bucket_bytes=self._swap_bucket_bytes,
                        out_digests=self._digests(rt) if digests else None,
                        in_digests=out_digests if digests else None,
                        quant=self._sleep_quant,
                    )
                except Exception as e:
                    self.failure = (
                        f"hot-swap {previous}->{model}: the re-capture failed ({type(capture_exc).__name__}: "
                        f"{capture_exc}) and swapping back failed ({type(e).__name__}: {e})"
                    )
                    self._fail_all(RuntimeError(self.failure))
                    raise RuntimeError(self.failure) from capture_exc
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                self.degraded = (f"hot-swap {previous}->{model} rolled back: its graphs' re-capture failed: "
                                 f"{type(capture_exc).__name__}: {capture_exc}")
                raise SwapRolledBack(self.degraded) from capture_exc
            if metrics["recapture_s"]:
                self.exec_pool.note_compile(metrics["recapture_s"])
        else:
            staged = staged_digests = staged_quant = None
            if prefetched:
                tier = "prefetched"
                pw = entry.runtime
                staged, staged_digests, staged_quant = pw.params_host, pw.digests, pw.quant_metas
            elif self._content_hash:
                got = self.model_pool.take_staged_match(model)
                if got is not None:
                    staged, staged_digests, _key, tier = got
            self.sleeper.sleep(1)
            try:
                rt = self._build_runtime(
                    model, staged_params=staged, staged_digests=staged_digests, staged_quant=staged_quant
                )
            except Exception as build_exc:
                # a failed build must not leave the card serving nothing
                try:
                    self.sleeper.wake_up()
                except Exception as wake_exc:
                    self.failure = (
                        f"hot-swap {previous}->{model} build failed ({type(build_exc).__name__}: {build_exc}) "
                        f"and the rollback wake failed ({type(wake_exc).__name__}: {wake_exc})"
                    )
                    self._fail_all(RuntimeError(self.failure))
                    raise RuntimeError(self.failure) from build_exc
                if prefetched:
                    # the staged host weights are untouched by a failed build
                    self._free_pooled(self._pool_park(entry.model_id, entry.runtime, entry.nbytes))
                elif staged is not None:
                    # weights rebuilt from the tiers are untouched too: they
                    # go back as prefetched host weights, so the retry
                    # reads no checkpoint
                    nb = sum(t.numel() * t.element_size() for t in flatten_state(staged))
                    pw = PrefetchedWeights(model_id=model, params_host=staged, nbytes=nb,
                                           digests=staged_digests)
                    self._free_pooled(self._pool_park(model, pw, nb))
                self.degraded = f"hot-swap {previous}->{model} build failed; rolled back to {previous}: {type(build_exc).__name__}: {build_exc}"
                try:
                    build_exc.fma_swap_actuated = True  # the flight recorder's mark
                except AttributeError:
                    pass
                raise
            b = self._last_build_stats
            warm_stats = b["warmup"]
            out_stats = outgoing.sleeper.stats
            # the build streams the whole incoming model; under
            # --sleep-quant the outgoing offload moved payloads only
            moved = out_stats.bytes_offloaded + b["bytes_in"]
            full = out_stats.bytes_offloaded_full + b["bytes_in"]
            metrics = {
                "swap_total_s": 0.0,  # below
                "d2h_s": out_stats.last_sleep_seconds,
                "h2d_s": b["h2d_s"],
                "d2h_transfer_s": out_stats.last_sleep_transfer_s,
                "h2d_transfer_s": b["h2d_s"],
                "overlap_s": 0.0,
                "overlap_frac": 0.0,
                "bytes_out": out_stats.bytes_offloaded,
                "bytes_in": b["bytes_in"],
                "bytes_moved": moved,
                "bytes_deduped": 0,
                "deduped_leaves": 0,
                "quant": out_stats.last_quant,
                "quant_leaves": 0,
                "bytes_full": full,
                "bytes_saved_quant": max(0, full - moved),
                "buckets_out": 0,
                "buckets_in": 0,
                "bucket_bytes": self._swap_bucket_bytes,
                "peak_bytes_in_flight": 0,
                "pin_s": out_stats.last_pin_seconds,
                "build_s": b["build_s"],
                "load_s": b["load_s"],
                "read_s": b["read_s"],
                "workers": b["workers"],
                "capture_s": b["capture_s"],
            }
        # the pool key is the model's name: the reference qualifies it with
        # an Orbax checkpoint_dir (name@dir), which the port refuses
        evicted = self._pool_park(previous, outgoing, outgoing.sleeper.stats.bytes_offloaded)
        self._runtime = rt
        self._free_pooled(evicted)
        metrics["swap_total_s"] = time.monotonic() - t0
        self._bump_actuation("swap")
        self.degraded = None  # a committed swap heals the failure domain
        self.last_swap = {
            "model": model,
            "previous_model": previous,
            "request_id": request_id,
            "checkpoint_dir": "",
            "swapped": True,
            "pool_hit": pool_hit,
            "prefetched": prefetched,
            "tier": tier,
            **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()},
            "warmup": warm_stats,
            "builds_total": self.builds_total,
            "pool": self.model_pool.describe(),
            "exec_pool": self.exec_pool.describe(),
        }
        return dict(self.last_swap)

    def _observe_swap(self, model: str, out: Dict[str, Any]) -> None:
        """A committed swap's metrics."""
        fm.ENGINE_SWAP_SECONDS.labels(model=model).observe(out.get("swap_total_s", 0.0))
        fm.ENGINE_SWAPS.labels(model=model, source="pool" if out.get("pool_hit") else "cold").inc()
        if out.get("pool_hit"):
            fm.ENGINE_POOL_HITS.inc()
        fm.ENGINE_SWAP_OVERLAP_FRAC.labels(model=model).set(out.get("overlap_frac", 0.0))
        fm.ENGINE_SWAP_INFLIGHT_BYTES.labels(model=model).set(out.get("peak_bytes_in_flight", 0))
        fm.ENGINE_SWAP_DELTA_BYTES.labels(model=model, kind="moved").set(out.get("bytes_moved", 0))
        fm.ENGINE_SWAP_DELTA_BYTES.labels(model=model, kind="deduped").set(out.get("bytes_deduped", 0))
        mode = out.get("quant", "off") or "off"
        fm.ENGINE_ACTUATION_BYTES.labels(mode=mode, dir="d2h").inc(out.get("bytes_out", 0))
        fm.ENGINE_ACTUATION_BYTES.labels(mode=mode, dir="h2d").inc(out.get("bytes_in", 0))
        for phase, key in (("d2h", "d2h_transfer_s"), ("h2d", "h2d_transfer_s"), ("total", "swap_total_s")):
            fm.ENGINE_ACTUATION_SECONDS.labels(kind="swap", phase=phase).observe(max(0.0, out.get(key, 0.0)))

    def _exec_key(self, key: str, runtime: _ModelRuntime) -> str:
        """The exec pool's key for the graphs of the runtime pooled under
        ``key``."""
        return exec_key(key, "chunk", runtime.engine.cfg.decode_chunk)

    def _pool_park(self, key: str, runtime: "_ModelRuntime | PrefetchedWeights", nbytes: int) -> list:
        """Pool a slept runtime, or a prefetch's staged weights, under
        ``key``, interning its digested weight copies into the chunk store
        first (a sibling already pooled shares its common tensors instead
        of holding them twice); a runtime's captured graphs go to the exec
        pool, which may release the least recently pooled ones. Returns the
        evicted entries, for :meth:`_free_pooled`.

        Quantized payloads (a runtime slept under --sleep-quant, a
        quantized prefetch) intern under their transfer digests, a digest
        space of their own: a quantized sibling dedupes against another
        quantized sibling, never against the full-precision tensor it
        approximates; such an entry leaves no eviction manifest. A slept
        runtime's full-precision leaves (the hot head, the norms) keep
        their content digests."""
        chunk_digests: List[str] = []
        interned = 0
        interning = self._content_hash and self.model_pool.budget_bytes > 0
        if isinstance(runtime, PrefetchedWeights):
            digests = runtime.digests
            if interning and runtime.params_host is not None:
                if runtime.quant_metas is not None:
                    qmap = transfer_quant.transfer_digest_map(runtime.params_host, runtime.quant_metas, prefix="")
                    runtime.params_host, chunk_digests, interned = self.model_pool.intern_tree(
                        runtime.params_host, qmap, prefix=""
                    )
                    digests = None
                elif digests:
                    runtime.params_host, chunk_digests, interned = self.model_pool.intern_tree(
                        runtime.params_host, digests, prefix=""
                    )
        else:
            digests = self._digests(runtime)
            host = runtime.sleeper._host_state
            metas = runtime.sleeper._quant_meta
            if interning and host is not None and metas is not None:
                merged = transfer_quant.transfer_digest_map(host, metas, prefix="params")
                for k, d in (digests or {}).items():
                    merged.setdefault(k, d)
                runtime.sleeper._host_state, chunk_digests, interned = self.model_pool.intern_tree(
                    host, merged, prefix="params"
                )
                digests = None
            elif interning and host is not None and digests:
                runtime.sleeper._host_state, chunk_digests, interned = self.model_pool.intern_tree(
                    host, digests, prefix="params"
                )
            graphs = runtime.engine.graphs
            if graphs is not None and graphs.captured:
                self.exec_pool.put(self._exec_key(key, runtime), graphs, graphs.pool_bytes())
        return self.model_pool.put(
            key, runtime, nbytes=nbytes, chunk_digests=chunk_digests,
            weight_digests=digests if chunk_digests else None, interned_bytes=interned,
        )

    def _free_pooled(self, victims: list) -> None:
        """Destroy evicted runtimes: an evicted model is built cold at its
        next swap-in anyway, so its host copies, its engine, its graphs and
        its arenas' address ranges all go, and the card's and the pinned
        host allocator's caches with them. An evicted prefetch's weights
        are dropped."""
        if not victims:
            return
        devices = set()
        for victim in victims:
            rt = victim.runtime
            if isinstance(rt, PrefetchedWeights):
                rt.params_host = None
            else:
                self.exec_pool.discard(self._exec_key(victim.model_id, rt))
                devices.add(rt.engine.device)
                rt.sleeper.sleep(2)  # drop the host copies
                rt.engine = rt.sleeper = None
            victim.runtime = None
        gc.collect()  # the engine and its graphs hold each other
        for dev in devices:
            if dev.type == "cuda":
                release_cached_memory(dev)
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()

    def pooled_engines(self) -> List[Dict[str, Any]]:
        """Each pooled engine's share of the card that is known here: its
        arenas' mapped bytes (0 while it sleeps), its captured graphs'
        kernel nodes and their memory pool's bytes (0 once the exec pool
        released them). Prefetched weights have no engine."""
        out = []
        for e in self.model_pool.entries():
            if isinstance(e.runtime, PrefetchedWeights):
                continue
            eng = e.runtime.engine
            programs = eng.graphs.programs.values() if eng.graphs else ()
            out.append({
                "model": e.model_id,
                "mapped_bytes": sum(a.mapped_bytes for a in eng.arenas.values()),
                "graph_captures": eng.graph_captures,
                "graph_kernel_nodes": sum(n for p in programs for n in p.kernels.values()),
                "graph_pool_bytes": eng.graphs.pool_bytes() if eng.graphs else 0,
            })
        return out

    # -- background checkpoint prefetch ------------------------------------------

    def prefetch(self, model: str, checkpoint_dir: str = "") -> Dict[str, Any]:
        """POST /v1/prefetch: stage ``model``'s weights on the host into
        the model pool (:meth:`_prefetch_worker`, on a thread of its own),
        never touching the card, while the current model keeps serving,
        so the first swap to it takes the ``prefetched`` tier. Raises
        ValueError for a request the service refuses (a 400)."""
        if self.args.tensor_parallel_size > 1:
            raise ValueError("prefetch on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)")
        if not model.startswith("hf:"):
            raise ValueError(
                "prefetch requires an hf:<model-dir> model (named configs are random-init, and Orbax "
                "checkpoints restore straight into device placement on swap)"
            )
        if checkpoint_dir:
            raise ValueError(
                "prefetch cannot stage an Orbax checkpoint_dir (it reads the hf: directory only); "
                "swap to the checkpoint directly"
            )
        hf_dir = model[3:]
        if not hf_dir:
            raise ValueError("prefetch model hf: needs a directory path")
        if model == self.model:
            raise ValueError(f"{model} is already the serving model")
        if self.model_pool.contains_match(model):
            return {"state": "already_pooled", "model": model, "checkpoint_dir": "", "started": False}
        if self._content_hash:
            # the tiers' fast path: an evicted model whose chunks still
            # resolve stages with no checkpoint read
            got = self.model_pool.take_staged(model)
            if got is not None:
                tree, digests, tier = got
                nbytes = sum(t.numel() * t.element_size() for t in flatten_state(tree))
                pw = PrefetchedWeights(model_id=model, params_host=tree, nbytes=nbytes,
                                       digests=digests)
                if not self._on_loop(lambda: self._register_prefetch(pw)):
                    fm.ENGINE_PREFETCHES.labels(outcome="completed").inc()
                    fm.ENGINE_PREFETCH_BYTES.set(nbytes)
                    self.last_prefetch = {"state": "completed", "model": model, "checkpoint_dir": "",
                                          "bytes": nbytes, "source": "tier", "tier": tier,
                                          "pool": self.model_pool.describe()}
                    return dict(self.last_prefetch, started=False)
        model_cfg = hf_models.config_from_hf(hf_dir)
        # a quantized staging holds its payload bytes: admit it as such
        est = hf_models.estimate_param_bytes(
            model_cfg, transfer_quant=self._sleep_quant, hot_head=self._sleep_quant_hot_head
        )
        if est > self.model_pool.budget_bytes:
            raise ValueError(
                f"prefetch of {model} (~{est >> 20} MiB staged) exceeds the model pool budget "
                f"({self.model_pool.budget_bytes >> 20} MiB); raise --model-pool-mib"
            )
        with self._prefetch_mu:
            if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
                raise ValueError("a prefetch is already in progress (DELETE /v1/prefetch aborts it)")
            self._prefetch_abort = threading.Event()
            self.last_prefetch = {"state": "running", "model": model, "checkpoint_dir": "", "bytes": 0}
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_worker,
                args=(model, hf_dir, model_cfg, self._prefetch_abort, tracing.current_context()),
                daemon=True, name="prefetch",
            )
            self._prefetch_thread.start()
        return dict(self.last_prefetch, started=True)

    def _register_prefetch(self, pw: PrefetchedWeights) -> bool:
        """Pool a prefetch's weights (on the engine thread: the pool may
        destroy an evicted engine); True when the pool bounced them."""
        evicted = self._pool_park(pw.model_id, pw, pw.nbytes)
        bounced = any(v.runtime is pw for v in evicted)
        self._free_pooled(evicted)
        if self._pin_host and hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()  # the duplicates interning dropped
        return bounced

    def _prefetch_worker(self, model: str, hf_dir: str, model_cfg, abort: threading.Event,
                         trace_ctx: "tracing.SpanContext | None" = None) -> None:
        """:meth:`_prefetch_body` under an ``engine.prefetch`` span, a child
        of the caller's (handed over: the thread has no context of its
        own)."""
        with tracing.span("engine.prefetch", parent=trace_ctx, model=model) as sp:
            self._prefetch_body(model, hf_dir, model_cfg, abort)
            sp.set(state=self.last_prefetch.get("state", ""), bytes=self.last_prefetch.get("bytes", 0))
        state = self.last_prefetch.get("state")
        if state in ("completed", "aborted", "failed", "rejected"):
            fm.ENGINE_PREFETCHES.labels(outcome=state).inc()
        if state == "completed":
            fm.ENGINE_PREFETCH_BYTES.set(self.last_prefetch.get("bytes", 0))

    def _prefetch_body(self, model: str, hf_dir: str, model_cfg, abort: threading.Event) -> None:
        """The prefetch's thread: the checkpoint staged on the host only
        (``load_params(place=False)``: readers, throttle, abort; no CUDA
        tensor), its digests hashed from the host leaves, then pooled.
        Under --sleep-quant the eligible leaves are quantized on the host
        (the host twin, leaf by leaf) and the pool holds their payloads,
        interned under transfer digests; the swap to it dequantizes them
        on the card."""
        t0 = time.monotonic()
        lstats = hf_models.LoadStats()
        try:
            faults.fire("prefetch.stage")
            if self._pin_host and hasattr(torch._C, "_host_emptyCache"):
                # the staging pins the whole model: the pinned blocks that
                # earlier sleeps and swaps freed go back to the host first
                self._on_loop(torch._C._host_emptyCache)
            quant = self._sleep_quant != "off"
            staged = hf_models.load_params(
                hf_dir, model_cfg, place=False, workers=self.args.load_workers or None, abort_event=abort,
                throttle_bytes_per_s=float(max(0, self.args.prefetch_mib_s) << 20), stats=lstats,
                want_digests=self._content_hash and not quant,
            )
            metas = None
            t_quant = time.monotonic()
            if quant:
                staged, metas = self._quantize_staged(staged, abort)
            quant_s = time.monotonic() - t_quant
            nbytes = sum(t.numel() * t.element_size() for t in flatten_state(staged)) + sum(
                m.scale_nbytes for m in metas or () if m is not None
            )
            pw = PrefetchedWeights(model_id=model, params_host=staged, nbytes=nbytes,
                                   digests=None if metas is not None else dict(lstats.digests) or None,
                                   quant_metas=metas, quant_mode=self._sleep_quant if metas is not None else "off")
            del staged
            for figure in lstats.transfer_figures():
                self.costs.observe_transfer(*figure)
            bounced = self._on_loop(lambda: self._register_prefetch(pw))
        except hf_models.LoadAborted:
            self.last_prefetch = {"state": "aborted", "model": model, "checkpoint_dir": "", "bytes": lstats.bytes_read}
            return
        except Exception as e:  # noqa: BLE001 — reported by GET /v1/prefetch
            traceback.print_exc()
            self.last_prefetch = {"state": "failed", "model": model, "checkpoint_dir": "",
                                  "error": f"{type(e).__name__}: {e}"}
            return
        if bounced:
            self.last_prefetch = {"state": "rejected", "model": model, "checkpoint_dir": "", "bytes": nbytes,
                                  "error": "staged bytes exceed the model pool budget"}
            return
        self.last_prefetch = {
            "state": "completed", "model": model, "checkpoint_dir": "", "bytes": nbytes,
            # the staged representation: "off" = full precision
            "quant": pw.quant_mode, "quant_s": round(quant_s, 6),
            "read_s": round(lstats.read_s, 6), "digest_s": round(lstats.digest_s, 6),
            "total_s": round(time.monotonic() - t0, 6), "shards": lstats.shards, "workers": lstats.workers,
            "pool": self.model_pool.describe(),
            # graphs belong to an engine: a prefetch has none to warm
            "warmup": None, "exec_pool": self.exec_pool.describe(),
        }

    def _quantize_staged(self, staged: Dict[str, Any], abort: threading.Event) -> Tuple[Dict[str, Any], Optional[list]]:
        """A prefetch's host tree with its eligible leaves quantized on the
        host (pinned payloads beside the card), each full-precision leaf
        dropped once its payload exists; and the aligned metas, or None
        when nothing was eligible."""
        plan = transfer_quant.transfer_quant_plan(staged, hot_head=self._sleep_quant_hot_head, prefix="")
        if not any(plan):
            return staged, None
        leaves = flatten_state(staged)
        metas: List[Any] = [None] * len(leaves)
        for i, flag in enumerate(plan):
            if abort.is_set():
                raise hf_models.LoadAborted("prefetch aborted while quantizing")
            if flag:
                leaves[i], metas[i] = transfer_quant.quantize_leaf_host(leaves[i], self._sleep_quant, pin=self._pin_host)
        return map_leaves(staged, leaves), metas

    def prefetch_status(self) -> Dict[str, Any]:
        return dict(self.last_prefetch)

    def abort_prefetch(self) -> Dict[str, Any]:
        """DELETE /v1/prefetch: the readers see the abort between tensors
        and unwind without pooling anything."""
        with self._prefetch_mu:
            t = self._prefetch_thread
            if t is None or not t.is_alive():
                return {"aborted": False, "state": self.last_prefetch.get("state", "idle")}
            self._prefetch_abort.set()
        t.join(timeout=60)
        return {"aborted": True, **self.last_prefetch}

    def _bump_actuation(self, kind: str) -> None:
        with self._mu:
            self._actuations[kind] = self._actuations.get(kind, 0) + 1

    # -- the actuation cost oracle (GET /v1/costs, /v1/actuations) -------------

    @staticmethod
    def _priced(price: Callable[[], Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """A prediction, or None: pricing never blocks the verb."""
        try:
            return price()
        except Exception:  # noqa: BLE001 — the verb runs unpriced
            return None

    def _model_cfg_cheap(self, model_id: str):
        """``model_id``'s config without loading its tokenizer: a
        ``config.json`` read for ``hf:``, the factory for a named one."""
        if model_id.startswith("hf:"):
            return hf_models.config_from_hf(model_id[3:])
        if model_id not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {model_id!r}")
        return MODEL_CONFIGS[model_id]()

    def _kv_pool_nbytes(self, model_cfg) -> int:
        """The page pool a build for ``model_cfg`` creates (part of a cold
        build's ``bytes_in``)."""
        return PagePool.estimate_nbytes(
            model_cfg.num_layers, self.args.num_pages, self.args.page_size, model_cfg.num_kv_heads,
            model_cfg.head_dim, dtype=model_cfg.dtype,
        )

    def price_swap(self, model: str, _offload_wire: Optional[int] = None, wait: bool = True) -> Dict[str, Any]:
        """The reference's pricing of a hot-swap to ``model``, before a
        byte moves: predicted wire bytes (for a pool-tier candidate from
        :func:`plan_swap`, the planner :func:`swap_states` runs, so they
        equal the swap's ``bytes_moved``, delta and quantization
        included; from the shapes and the manifests for the cold tiers)
        and predicted seconds (bytes over the measured bandwidths). Reads
        only: nothing is taken from the pool, nothing moves. With
        ``wait`` False (a read route on the engine thread) a digest job
        that still runs is not joined: the row is priced without the
        delta, as the reference prices it before its digests exist, and
        carries ``digest_pending: true``."""
        if model.startswith("hf:"):
            if not model[3:]:
                raise ValueError("swap model hf: needs a directory path")
        elif model not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {model!r}; known: {sorted(MODEL_CONFIGS)} or hf:<model-dir>")
        book = self.costs.bandwidths
        out: Dict[str, Any] = {"kind": "swap", "model": model, "checkpoint_dir": ""}
        if model == self.model:
            return {**out, "tier": "resident", "predicted_bytes": 0, "predicted_bytes_out": 0,
                    "predicted_bytes_in": 0, "predicted_s": 0.0, "measured": True}
        entry = self.model_pool.peek_match(model)
        prefetched = entry is not None and isinstance(entry.runtime, PrefetchedWeights)
        if entry is not None and not prefetched:
            pending = not wait and any(
                rt.digest_job is not None and not rt.digest_job.done() for rt in (self._runtime, entry.runtime))
            digests = self._content_hash and not pending
            p = plan_swap(
                self.sleeper, entry.runtime.sleeper, bucket_bytes=self._swap_bucket_bytes,
                out_digests=self._digests(self._runtime) if digests else None,
                in_digests=self._digests(entry.runtime) if digests else None,
                quant=self._sleep_quant,
            )
            out_s, m1 = book.seconds_for("swap.d2h", p["wire_out"])
            in_s, m2 = book.seconds_for("swap.h2d", p["wire_in"])
            if book.has("swap.total"):
                # the whole verb's effective rate from earlier pool-tier
                # swaps predicts the wall, its fixed overhead included
                predicted_s, m_tot = book.seconds_for("swap.total", p["bytes_moved"])
                m1 = m2 = m_tot
            else:
                # one outgoing bucket runs the two directions in turn
                predicted_s = max(out_s, in_s) if p["buckets_out"] > 1 else out_s + in_s
            return {
                **out, "tier": "pool",
                "predicted_bytes": p["bytes_moved"],
                "predicted_bytes_out": p["wire_out"],
                "predicted_bytes_in": p["wire_in"],
                "predicted_kv_pageout_bytes": 0,
                "predicted_kv_pagein_bytes": 0,
                "predicted_bytes_deduped": p["bytes_deduped"],
                "predicted_deduped_leaves": p["deduped_leaves"],
                "predicted_bytes_full": p["bytes_full"],
                "quant": p["quant"],
                "predicted_s": round(predicted_s, 6),
                "predicted_d2h_s": round(out_s, 6),
                "predicted_h2d_s": round(in_s, 6),
                "measured": bool(m1 and m2),
                "compile_estimate_s": 0.0,  # a pooled engine keeps its graphs
                **({"digest_pending": True} if pending else {}),
            }
        # the cold tiers: a level-1 offload of the serving model, then a
        # build that streams a host tree (staged, rebuilt from the tiers,
        # or read) and creates the page pool, as its bytes_in counts them
        offload_wire = _offload_wire if _offload_wire is not None else self.sleeper.offload_wire_bytes()
        d2h_s, m_out = book.seconds_for("sleep.d2h", offload_wire)
        model_cfg = self._model_cfg_cheap(model)
        kv_bytes = self._kv_pool_nbytes(model_cfg)
        read_bytes = 0
        if prefetched:
            tier = "prefetched"
            stream_bytes = params_full = int(entry.nbytes)
            if entry.runtime.quant_metas is not None:
                # payloads stream; the built engine holds full precision
                params_full = hf_models.estimate_param_bytes(model_cfg)
        else:
            params_full = hf_models.estimate_param_bytes(model_cfg)
            staged = self.model_pool.peek_staged_match(model) if self._content_hash else None
            if staged is not None:
                _key, stream_bytes, tier = staged
                read_bytes = stream_bytes if tier == "disk" else 0
            else:
                tier = "cold"
                stream_bytes = read_bytes = params_full
        h2d_s, m_in = book.seconds_for("coldload.h2d", stream_bytes)
        read_s, m_read = (0.0, True)
        if read_bytes:
            read_s, m_read = book.seconds_for("coldload.read", read_bytes)
        return {
            **out, "tier": tier,
            "predicted_bytes": offload_wire + params_full + kv_bytes,
            "predicted_bytes_out": offload_wire,
            "predicted_bytes_in": params_full + kv_bytes,
            "predicted_kv_pageout_bytes": 0,
            "predicted_stream_bytes": stream_bytes,
            # the loaders overlap the read with the copies; the offload
            # runs first (sleep, then build)
            "predicted_s": round(d2h_s + max(h2d_s, read_s), 6),
            "predicted_d2h_s": round(d2h_s, 6),
            "predicted_h2d_s": round(h2d_s, 6),
            "predicted_read_s": round(read_s, 6),
            "measured": bool(m_out and m_in and m_read),
            "compile_estimate_s": round(self.exec_pool.describe().get("mean_compile_s", 0.0), 6),
        }

    def price_sleep(self) -> Dict[str, Any]:
        """The predicted cost of a level-1 sleep of the serving model."""
        if self.sleeper.is_sleeping:
            return {"kind": "sleep", "model": self.model, "predicted_bytes": 0, "predicted_s": 0.0, "measured": True}
        wire = self.sleeper.offload_wire_bytes()
        sec, measured = self.costs.bandwidths.seconds_for("sleep.d2h", wire)
        return {"kind": "sleep", "model": self.model, "predicted_bytes": wire, "predicted_kv_pageout_bytes": 0,
                "predicted_s": round(sec, 6), "measured": measured}

    def price_wake(self) -> Dict[str, Any]:
        """The predicted cost of waking the serving model: its host
        payload's copy back for level 1, a checkpoint load for level 2."""
        sl = self.sleeper
        if not sl.is_sleeping:
            return {"kind": "wake", "model": self.model, "predicted_bytes": 0, "predicted_s": 0.0, "measured": True}
        if int(sl.level) == 1:
            wire = sl.stats.bytes_offloaded
            sec, measured = self.costs.bandwidths.seconds_for("wake.h2d", wire)
            return {"kind": "wake", "model": self.model, "predicted_bytes": wire, "predicted_kv_pagein_bytes": 0,
                    "predicted_s": round(sec, 6), "measured": measured}
        est = hf_models.estimate_param_bytes(self.engine.cfg.model)
        h2d_s, m1 = self.costs.bandwidths.seconds_for("coldload.h2d", est)
        read_s, m2 = self.costs.bandwidths.seconds_for("coldload.read", est)
        return {"kind": "wake", "model": self.model, "predicted_bytes": est,
                "predicted_s": round(max(h2d_s, read_s), 6), "measured": bool(m1 and m2)}

    def costs_view(self, extra: "tuple | list" = ()) -> Dict[str, Any]:
        """GET /v1/costs: every candidate actuation priced in one call (the
        serving model, each pooled or prefetched model, each evicted model
        whose chunks the tiers hold, and the ``extra`` names), with the
        bandwidths behind the predictions. The reference's rows of the
        verbs the port does not have (migration, the co-resident attach
        and detach) are an error row and an empty list."""
        candidates: List[Dict[str, Any]] = []
        seen = set()
        exec_desc = self.exec_pool.describe()
        try:
            offload_wire: Optional[int] = self.sleeper.offload_wire_bytes()
        except Exception:  # noqa: BLE001 — each row prices its own, or says why not
            offload_wire = None

        def add(model: str) -> None:
            if model in seen:
                return
            seen.add(model)
            try:
                candidates.append(self.price_swap(model, _offload_wire=offload_wire, wait=False))
            except Exception as e:  # noqa: BLE001 — one bad row never fails the view
                candidates.append({"model": model, "checkpoint_dir": "", "error": f"{type(e).__name__}: {e}"})

        add(self.model)
        for key in self.model_pool.models() + self.model_pool.staged_keys():
            add(key.partition("@")[0])
        for model in extra:
            add(model)
        return {
            "model": self.model,
            "is_sleeping": self.sleeper.is_sleeping,
            "quant": self._sleep_quant,
            "content_hash": self._content_hash,
            "bandwidth_gibps": self.costs.bandwidths.describe(),
            "sleep": self._priced_row("sleep", self.price_sleep),
            "wake": self._priced_row("wake", self.price_wake),
            "migrate": {"kind": "migrate", "error": "live migration is not ported yet (ROADMAP queue 1 item 11)"},
            "compile": {"mean_compile_s": exec_desc.get("mean_compile_s", 0.0),
                        "compiles_total": exec_desc.get("compiles_total", 0)},
            "candidates": candidates,
            "coresident": [],
        }

    @staticmethod
    def _priced_row(kind: str, price: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
        try:
            return price()
        except Exception as e:  # noqa: BLE001 — one bad row never fails the view
            return {"kind": kind, "error": f"{type(e).__name__}: {e}"}

    def costs_report(self, extra: "tuple | list" = ()) -> Dict[str, Any]:
        """:meth:`costs_view` on the engine thread, between steps: nothing
        moves while the candidates are priced. The digests of the serving
        and the pooled models are joined here first, on the caller's
        thread, so the engine loop never waits on hashing (a job that
        starts in between is priced as pending)."""
        if self._content_hash:
            for rt in [self._runtime] + [e.runtime for e in self.model_pool.entries()]:
                if isinstance(rt, _ModelRuntime):
                    self._digests(rt)
        return self._on_loop(lambda: self.costs_view(extra))

    def actuations_view(self, n: int = 0, kind: Optional[str] = None) -> Dict[str, Any]:
        """GET /v1/actuations: the flight recorder, oldest first, and the
        oracle's accuracy summary."""
        return {"records": self.costs.recorder.records(n=n, kind=kind), "summary": self.costs.recorder.summary()}

    def _record_actuation(
        self, kind: str, model: str, trigger: str, tier: str, pred: Optional[Dict[str, Any]],
        actual_bytes: int, actual_s: float, outcome: str = "committed",
    ):
        """One flight-recorder row per actuation edge, with the prediction
        made before it when there was one; the prediction and its error
        go on the oracle's gauges too."""
        rec = self.costs.record(
            kind=kind, model=model, trigger=trigger, tier=tier, outcome=outcome,
            actual_bytes=actual_bytes, actual_s=actual_s,
            predicted_bytes=None if pred is None else pred.get("predicted_bytes"),
            predicted_s=None if pred is None else pred.get("predicted_s"),
            measured=bool(pred and pred.get("measured")),
        )
        if rec.predicted_bytes is not None:
            fm.ENGINE_PREDICTED_BYTES.labels(kind=kind).set(rec.predicted_bytes)
        if rec.seconds_error_ratio is not None and rec.measured:
            fm.ENGINE_COST_ERROR.labels(kind=kind).set(rec.seconds_error_ratio)
        return rec

    def stats(self) -> Dict[str, Any]:
        """GET /v1/stats: the reference's fields for the blocks the port
        has (``slo`` with ``--slo-ttft-ms``/``--slo-tpot-ms``, goodput and
        ``slo_exemplars``), and blocks of the port's own: ``engine``, the
        serving engine's step counters (its serving chunks' decode steps,
        replayed or eager, its cold prefills, packed steps, chunks and
        graph replays; a swap's incoming engine starts at 0), and
        ``load``, the checkpoint's last load (``models/hf.py:LoadStats``)
        for an ``hf:`` model, else None (``digest_pending`` while the
        load's digests are still being hashed: ``digest_s`` is then 0);
        ``pool``, the slept-model pool (``HostModelPool.describe``); and
        ``quant`` (:meth:`_quant_block`). ``costs`` is the reference's. It
        never waits for the digests."""
        now = time.monotonic()
        depth = self.queue_depth()
        rt = self._runtime
        job = rt.digest_job
        if job is not None and job.done():
            self._digests(rt)  # joins at once: digest_s is the load's
        load = None if rt.load_stats is None else dict(
            rt.load_stats.summary(), loads=rt.loads, digest_pending=rt.digest_job is not None)
        eng = self.engine
        with self._mu:
            judged = self._slo_met + self._slo_violated
            return {
                "model": self.model,
                "queue_depth": depth,
                "arrival_rate_rps": round(self._arrival.rate(now), 6),
                "slo": {
                    "ttft_ms": self._slo_ttft_s * 1e3,
                    "tpot_ms": self._slo_tpot_s * 1e3,
                    "met": self._slo_met,
                    "violated": self._slo_violated,
                    "attainment": round(self._slo_met / judged, 6) if judged else None,
                },
                "finished_requests": self._finished_requests,
                "generated_tokens": self._generated_tokens,
                "goodput_tokens": self._goodput_tokens,
                # the last SLO violations, each with its kept trace and legs
                "slo_exemplars": list(self._slo_exemplars),
                "engine": {
                    "decode_steps": eng.chunk_steps,
                    "decode_chunks": eng.decode_chunks,
                    "graph_replays": eng.graph_replays,
                    "cold_prefills": eng.cold_prefills,
                    "packed_steps": eng.packed_steps,
                },
                "aborted": dict(self._aborted),
                "actuations": dict(self._actuations),
                "uptime_s": round(now - self.started_at, 3),
                "is_sleeping": self.sleeper.is_sleeping,
                "load": load,
                "pool": self.model_pool.describe(),
                # the oracle's bandwidths and its accuracy over the last
                # records (a launcher lifts it into ledger.costs)
                "costs": self.costs.summary(),
                "quant": self._quant_block(),
            }

    def _quant_block(self) -> Dict[str, Any]:
        """The port's own ``quant`` block of /v1/stats: the mode, what the
        serving model's last sleep held against its full precision, and
        the last committed swap's quantization."""
        st = self.sleeper.stats
        last = self.last_swap
        return {
            "mode": self._sleep_quant,
            "hot_head": self._sleep_quant_hot_head,
            "slept": self.sleeper.quant_state(),
            "bytes_offloaded": st.bytes_offloaded,
            "bytes_offloaded_full": st.bytes_offloaded_full,
            "last_swap": {k: last.get(k) for k in ("quant", "quant_leaves", "bytes_full", "bytes_saved_quant")}
            if last else None,
        }

    # -- observability: /metrics and /v1/profile ---------------------------------

    def metrics_text(self) -> str:
        """GET /metrics: the gauges a scrape refreshes (queue depth, the
        arrival rate decayed to now, prefix-cache hits, the pools), the
        pools' cumulative counters mirrored into theirs, then the whole
        registry in the Prometheus text format. Host-side counters only:
        nothing here reads the device."""
        m = self.model
        fm.ENGINE_QUEUE_DEPTH.labels(model=m).set(self.queue_depth())
        with self._mu:
            fm.ENGINE_ARRIVAL_RATE.labels(model=m).set(self._arrival.rate(time.monotonic()))
        pc = self.engine.prefix_cache
        if pc is not None:
            fm.ENGINE_PREFIX_HIT_TOKENS.labels(model=m).set(pc.hit_tokens)
        pool = self.model_pool
        fm.ENGINE_POOL_BYTES.set(pool.bytes_used)
        fm.ENGINE_POOL_MODELS.set(len(pool))
        self._mirror(fm.ENGINE_POOL_EVICTIONS, "pool_evictions", pool.evictions)
        if pool.chunks is not None:
            cd = pool.chunks.describe()
            for tier in ("host", "disk"):
                fm.ENGINE_POOL_TIER_BYTES.labels(tier=tier).set(cd[f"{tier}_bytes"])
                fm.ENGINE_POOL_TIER_CHUNKS.labels(tier=tier).set(cd[f"{tier}_chunks"])
            fm.ENGINE_POOL_DEDUP_SAVED.set(cd["dedup_saved_bytes"])
            for event, key in (("dedup_hit", "dedup_hits"), ("disk_spill", "disk_spills"), ("disk_hit", "disk_hits"),
                               ("disk_eviction", "disk_evictions"), ("verify_failure", "verify_failures")):
                self._mirror(fm.ENGINE_POOL_TIER_EVENTS.labels(event=event), f"tier/{event}", cd[key])
        ex = self.exec_pool
        fm.ENGINE_EXEC_POOL_BYTES.set(ex.bytes_used)
        fm.ENGINE_EXEC_POOL_ENTRIES.set(len(ex))
        self._mirror(fm.ENGINE_EXEC_POOL_HITS, "exec_hits", ex.hits)
        self._mirror(fm.ENGINE_EXEC_POOL_MISSES, "exec_misses", ex.misses)
        self._mirror(fm.ENGINE_EXEC_POOL_EVICTIONS, "exec_evictions", ex.evictions)
        return exposition()

    def start_profile(self, log_dir: str = "") -> Dict[str, Any]:
        """POST /v1/profile: start a ``torch.profiler`` capture of CPU and
        CUDA activity. The profiler is process global, so one capture at a
        time (:class:`ProfileConflict`). It is started and stopped on the
        engine thread, between steps: the operators it records are that
        thread's (the serving ones); the card's kernels, replays of CUDA
        graphs included, come from CUPTI, whichever thread launched them."""
        with self._profile_mu:
            if self._profile_dir is not None:
                raise ProfileConflict(
                    f"a profile capture is already running (log_dir={self._profile_dir}); DELETE /v1/profile stops it"
                )
            log_dir = log_dir or os.path.join(
                os.environ.get("TMPDIR") or "/tmp", f"fma-profile-{os.getpid()}-{int(time.time())}")
            os.makedirs(log_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            self._on_loop(prof.start)
            self._profile, self._profile_dir = prof, log_dir
        return {"profiling": True, "log_dir": log_dir}

    def stop_profile(self) -> Dict[str, Any]:
        """DELETE /v1/profile: stop the capture and write its Chrome trace
        (``trace.json``) under its ``log_dir``. The state clears only once
        the stop succeeded, so a failed stop can be sent again."""
        with self._profile_mu:
            if self._profile_dir is None:
                raise ProfileConflict("no profile capture is running")
            prof = self._profile
            self._on_loop(prof.stop)
            prof.export_chrome_trace(os.path.join(self._profile_dir, "trace.json"))
            log_dir, self._profile, self._profile_dir = self._profile_dir, None, None
        return {"profiling": False, "log_dir": log_dir}

    def profile_status(self) -> Dict[str, Any]:
        with self._profile_mu:
            return {"profiling": self._profile_dir is not None, "log_dir": self._profile_dir or ""}

    def device_info(self) -> Dict[str, Any]:
        """GET /v1/device: the engine's device, with the card's name and
        UUID as the CUDA runtime gives them (the UUID spelled as NVML and
        a launcher's ``gpu_uuids`` spell it, ``GPU-...``); this process's
        kernel launches: each wrapper's eager ones
        (``ops/cuda:kernel_launches``) and, by kernel name, those the
        replays of the captured chunk graphs ran; and its share of the
        card that is known here: the caching allocator's reserved and
        allocated bytes, the arenas' mapped bytes, and the captured
        graphs' kernel nodes (the rest of its share, the CUDA context,
        only the card reports); and how many chunk graphs it has captured
        (a wake must not capture again)."""
        eng = self.engine
        dev = eng.device
        name = uuid = None
        memory = {"reserved_bytes": 0, "allocated_bytes": 0}
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            name, uuid = props.name, f"GPU-{props.uuid}"
            memory = {"reserved_bytes": torch.cuda.memory_reserved(dev),
                      "allocated_bytes": torch.cuda.memory_allocated(dev)}
        memory["mapped_bytes"] = sum(a.mapped_bytes for a in eng.arenas.values())
        programs = eng.graphs.programs.values() if eng.graphs else ()
        memory["graph_kernel_nodes"] = sum(n for p in programs for n in p.kernels.values())
        return {
            "device": str(dev), "name": name, "uuid": uuid,
            "launches": kernel_launches(),
            "replayed": eng.graphs.replayed_launches() if eng.graphs else {},
            "memory": memory,
            "graph_captures": eng.graph_captures,
        }

    def shutdown(self) -> None:
        with self._prefetch_mu:
            t = self._prefetch_thread
            self._prefetch_abort.set()
        if t is not None:
            t.join(timeout=60)
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=30)


def _finish_reason(service: EngineService, req) -> str:
    if req.finish_reason:
        return req.finish_reason
    eos = service.engine.cfg.eos_token_id
    return "stop" if req.out_tokens and req.out_tokens[-1] == eos else "length"


def _lifecycle_usage(req) -> Dict[str, Any]:
    """The reference's per-request usage extras: queue wait, decode TPOT
    and, when the request's trace was kept, its ``trace_id`` (what
    ``GET /v1/traces?trace_id=`` takes)."""
    qw = None
    if req.first_sched_time is not None:
        qw = max(0.0, req.first_sched_time - req.submit_time)
    tpot = None
    n = len(req.out_tokens)
    if req.first_token_time is not None and req.done_time is not None and n > 1:
        tpot = max(0.0, (req.done_time - req.first_token_time) / (n - 1))
    out = {"queue_wait_s": qw, "decode_tpot_s": tpot}
    if req.trace_id:
        out["trace_id"] = req.trace_id
    return out


def _request_legs(req, now: float) -> Dict[str, float]:
    """Submit to done split into the legs an SLO exemplar reports: queue
    (to the first slot), prefill (to the first token) and decode; the
    reference's preempt and migrate legs are 0 (no parking is ported)."""
    if req.first_sched_time is None:
        queue, prefill, decode = max(0.0, now - req.submit_time), 0.0, 0.0
    else:
        queue = max(0.0, req.first_sched_time - req.submit_time)
        if req.first_token_time is not None:
            prefill = max(0.0, req.first_token_time - req.first_sched_time)
            decode = max(0.0, now - req.first_token_time)
        else:
            prefill, decode = max(0.0, now - req.first_sched_time), 0.0
    return {"queue": queue, "prefill": prefill, "decode": decode, "preempt": 0.0, "migrate": 0.0}


def _usage(req, completion_tokens: int, ttft: bool = True) -> Dict[str, Any]:
    out = {"prompt_tokens": len(req.prompt), "completion_tokens": completion_tokens}
    if ttft:
        out["time_to_first_token_s"] = (req.first_token_time - req.submit_time) if req.first_token_time else None
    out.update(_lifecycle_usage(req))
    return out


class BadRequest(ValueError):
    """A client error: answered with HTTP 400 and this message."""


def validate_messages(messages: Any) -> List[Dict[str, Any]]:
    """The reference's chat ``messages`` check."""
    if not isinstance(messages, list) or not messages:
        raise BadRequest("messages must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise BadRequest("each message needs role and content")
        if not isinstance(m["content"], str):
            # content-parts arrays (multimodal) would also crash a chat template
            raise BadRequest("message content must be a string")
    return messages


@dataclasses.dataclass
class Generation:
    """A parsed request: ``add_request`` keywords, the stop strings that
    the response layer matches on decoded text, and ``n``."""

    kw: Dict[str, Any]
    stop_texts: Tuple[str, ...]
    n: int


def parse_stop(stop: Any, vocab: int) -> Tuple[tuple, tuple]:
    """OpenAI ``stop``: a string, a list of strings, or token ids and
    token-id lists -> (token sequences, stop strings). Token-id stops
    match in the engine; strings match on decoded text in the response
    layer (BPE does not round-trip, and a stop can start mid-token)."""
    if stop is None:
        return (), ()
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list):
        raise BadRequest("stop must be a string or a list")
    seqs, texts = [], []
    for s in stop:
        if isinstance(s, str):
            texts.append(s)
        elif isinstance(s, int) and not isinstance(s, bool):
            seqs.append((s % vocab,))
        elif isinstance(s, list) and all(isinstance(t, int) and not isinstance(t, bool) for t in s):
            seqs.append(tuple(t % vocab for t in s))
        else:
            raise BadRequest(f"invalid stop entry {s!r}")
    return tuple(s for s in seqs if s), tuple(t for t in texts if t)


def encode_prompt(service: EngineService, prompt: Any) -> List[int]:
    if isinstance(prompt, str):
        return service.tokenizer.encode(prompt)
    if isinstance(prompt, list) and all(isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        return list(prompt)
    raise BadRequest("prompt must be a string or a list of token ids")


def chat_tokens(service: EngineService, messages: Any) -> List[int]:
    msgs = validate_messages(messages)
    try:
        return service.tokenizer.chat_tokens(msgs)
    except Exception as e:  # noqa: BLE001 — a template's refusal is the request's fault
        raise BadRequest(f"chat template failed: {e}")


def parse_generation(service: EngineService, body: Dict[str, Any], tokens: List[int]) -> Generation:
    """Validate a completion or chat body into add_request keywords;
    everything add_request would reject is a BadRequest here, so a
    streamed request fails with a 400 before its headers go out."""
    vocab = service.cfg.model.vocab_size
    tokens = [t % vocab for t in tokens]
    if not tokens:
        raise BadRequest("empty prompt")
    try:
        mt = body.get("max_tokens")
        max_tokens = 16 if mt is None else int(mt)
        tv = body.get("temperature")
        temperature = 0.0 if tv is None else float(tv)
        top_p = float(1.0 if body.get("top_p") is None else body.get("top_p"))
        pp, fp = body.get("presence_penalty"), body.get("frequency_penalty")
        presence = 0.0 if pp is None else float(pp)
        frequency = 0.0 if fp is None else float(fp)
        n = 1 if body.get("n") is None else int(body.get("n"))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid generation parameter: {e}")
    if max_tokens < 1:
        raise BadRequest(f"max_tokens must be >= 1, got {max_tokens}")
    if not (0.0 < top_p <= 1.0):
        raise BadRequest(f"top_p must be in (0, 1], got {top_p}")
    for name, v in (("presence_penalty", presence), ("frequency_penalty", frequency)):
        if not (-2.0 <= v <= 2.0):
            raise BadRequest(f"{name} must be in [-2, 2], got {v}")
    if not (1 <= n <= service.cfg.max_batch):
        raise BadRequest(f"n must be in 1..{service.cfg.max_batch}")
    if body.get("stream") and n != 1:
        raise BadRequest("n > 1 is not supported with stream")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int) or not (-(2**63) <= seed < 2**63)):
        raise BadRequest("seed must be an integer that fits in a signed 64-bit integer")
    iev = body.get("ignore_eos")
    if iev is not None and not isinstance(iev, bool):
        raise BadRequest(f"ignore_eos must be a bool, got {iev!r}")
    try:
        logit_bias = validate_logit_bias(body.get("logit_bias"), vocab)
    except ValueError as e:
        raise BadRequest(str(e))
    stop_seqs, stop_texts = parse_stop(body.get("stop"), vocab)
    sti = body.get("stop_token_ids")
    if sti is not None:
        # vLLM's name; single-id stops, stripped from the output like
        # every other stop here
        if not isinstance(sti, list):
            raise BadRequest("stop_token_ids must be a list of ints")
        for t in sti:
            if isinstance(t, bool) or not isinstance(t, int):
                raise BadRequest(f"stop_token_ids entries must be ints, got {t!r}")
            if not (0 <= t < vocab):
                raise BadRequest(f"stop_token_ids entry {t} outside vocab [0, {vocab})")
        stop_seqs = stop_seqs + tuple((t,) for t in sti)
    cfg = service.cfg
    if len(tokens) + max_tokens > cfg.seq_len:
        raise BadRequest(f"prompt+generation {len(tokens)}+{max_tokens} exceeds max_seq_len {cfg.seq_len}")
    need = PageAllocator.pages_needed(len(tokens) + max_tokens, cfg.page_size)
    if need > cfg.num_pages - 1:
        raise BadRequest(f"request needs {need} pages but the pool only has {cfg.num_pages - 1}")
    kw = dict(
        prompt=tokens, max_new_tokens=max_tokens, temperature=temperature,
        top_p=top_p, stop_seqs=stop_seqs, presence_penalty=presence,
        frequency_penalty=frequency, seed=seed, ignore_eos=bool(iev),
        logit_bias=logit_bias,
    )
    return Generation(kw, stop_texts, n)


def parse_logprobs_n(service: EngineService, v: Any, field: str = "logprobs") -> int:
    """OpenAI completions ``logprobs`` / chat ``top_logprobs``: a bool
    (the sampled tokens' logprobs only) or how many alternatives per
    position, bounded by the engine's top-k."""
    if v is None or isinstance(v, bool):
        return 0
    try:
        n = int(v)
    except (TypeError, ValueError):
        raise BadRequest(f"{field} must be a bool or int, got {v!r}")
    limit = service.cfg.logprobs_topk
    if n < 0 or n > limit:
        raise BadRequest(f"{field} must be in [0, {limit}] (engine --logprobs-topk)")
    return n


def _text_stop_watcher(service: EngineService, stop_texts: tuple):
    """An engine-thread hook that asks the engine to finish a request
    once its decoded text holds a stop string (the response layer then
    cuts the text), so the slot is freed early."""
    filt = tokenizer_mod.TextStopStream(service.tokenizer, stop_texts)

    def on_token(req, t: int) -> None:
        if filt.push(t)[2]:
            req.stop_requested = True

    return on_token


def gather_n(service: EngineService, gen: Generation, want_alts: bool, want_plp: bool = False,
             trace_ctx: "tracing.SpanContext | None" = None) -> list:
    """``n`` submissions of one request (choice ``i`` seeded ``seed + i``,
    as the reference does); a failure aborts the siblings. Prompt logprobs
    and the client's trace go to choice 0 only: the prompt's scores are
    the same for every choice, and its usage is the response's."""
    seed = gen.kw["seed"]
    futs = [
        service.submit(**dict(
            gen.kw,
            seed=None if seed is None else ((seed + i + 2**63) % 2**64) - 2**63,
            on_token=_text_stop_watcher(service, gen.stop_texts) if gen.stop_texts else None,
            want_top_logprobs=want_alts,
            want_prompt_logprobs=want_plp and i == 0,
            trace_ctx=trace_ctx if i == 0 else None,
        ))
        for i in range(gen.n)
    ]
    try:
        return [f.result() for f in futs]
    except BaseException:
        for f in futs:
            if not f.done():
                service.abort(f)
        raise


def _top_dict(service: EngineService, alts, n: int) -> Dict[str, float]:
    """A completions top_logprobs entry: decoded token -> logprob; the
    best logprob wins where two ids decode alike."""
    out: Dict[str, float] = {}
    for tid, lp in alts[:n]:
        key = service.tokenizer.decode([tid], skip_special=False)
        if key not in out or lp > out[key]:
            out[key] = lp
    return out


def completion_response(service: EngineService, body: Dict[str, Any], gen: Generation, reqs,
                        logprobs_n: int) -> Dict[str, Any]:
    tok = service.tokenizer
    raw_prompt = body.get("prompt")
    echo = bool(body.get("echo"))
    choices = []
    total = 0
    for i, r in enumerate(reqs):
        kept, kept_lps, text, matched = tokenizer_mod.truncate_at_text_stop(
            tok, r.out_tokens, r.out_logprobs, gen.stop_texts
        )
        total += len(kept)
        if echo:
            # the prompt as the client sent it: a text prompt verbatim, a
            # token-id prompt as its literal decode, specials included
            text = (raw_prompt if isinstance(raw_prompt, str)
                    else tok.decode(gen.kw["prompt"], skip_special=False)) + text
        choice = {
            "index": i,
            "token_ids": kept,
            "text": text,
            "finish_reason": "stop" if matched else _finish_reason(service, r),
        }
        if body.get("logprobs"):
            # echo + logprobs: the arrays cover the prompt too, its first
            # entry None (nothing precedes it)
            prompt = gen.kw["prompt"]
            choice["logprobs"] = {
                "tokens": (prompt + kept) if echo else kept,
                "token_logprobs": (reqs[0].prompt_logprobs + kept_lps) if echo else kept_lps,
            }
            if logprobs_n > 0:
                tops = [_top_dict(service, alts, logprobs_n) for alts in r.out_top_logprobs[: len(kept)]]
                choice["logprobs"]["top_logprobs"] = ([{} for _ in prompt] + tops) if echo else tops
        choices.append(choice)
    return {
        "object": "text_completion",
        "model": body.get("model") or service.model,
        "choices": choices,
        "usage": _usage(reqs[0], total),
    }


def chat_response(service: EngineService, body: Dict[str, Any], gen: Generation, reqs, top_n: int) -> Dict[str, Any]:
    tok = service.tokenizer
    choices = []
    total = 0
    for i, r in enumerate(reqs):
        kept, kept_lps, text, matched = tokenizer_mod.truncate_at_text_stop(
            tok, r.out_tokens, r.out_logprobs, gen.stop_texts
        )
        total += len(kept)
        choice = {
            "index": i,
            "message": {"role": "assistant", "content": text, "token_ids": kept},
            "finish_reason": "stop" if matched else _finish_reason(service, r),
        }
        if body.get("logprobs"):
            choice["logprobs"] = {
                "content": [
                    {
                        "token": tok.decode([tid], skip_special=False),
                        "logprob": lp,
                        "top_logprobs": [
                            {"token": tok.decode([aid], skip_special=False), "logprob": alp}
                            for aid, alp in alts[:top_n]
                        ],
                    }
                    for tid, lp, alts in zip(kept, kept_lps, r.out_top_logprobs[: len(kept)])
                ]
            }
        choices.append(choice)
    return {
        "object": "chat.completion",
        "model": body.get("model") or service.model,
        "choices": choices,
        "usage": _usage(reqs[0], total, ttft=False),
    }


def stream_events(service: EngineService, gen: Generation, make_chunk: Callable, usage_chunk: Callable,
                  trace_ctx: "tracing.SpanContext | None" = None):
    """The reference's SSE stream as a generator of event payloads (JSON
    objects, then the ``[DONE]`` terminator): one event per emitted token
    with its text from an incremental detokenizer, stop strings matched
    on the decoded text (held back until disambiguated; a match ends the
    stream and aborts the generation), a final usage event when the
    request completes, and an error event when it fails. Closing the
    generator early (the client went away) aborts the request."""
    tok = service.tokenizer
    filt = tokenizer_mod.TextStopStream(tok, gen.stop_texts) if gen.stop_texts else None
    dec = tokenizer_mod.IncrementalDecoder(tok)
    q: "queue.Queue" = queue.Queue()

    def on_token(req, t: int) -> None:
        q.put((t, req.done))

    fut = service.submit(trace_ctx=trace_ctx, **dict(gen.kw, on_token=on_token))
    fut.add_done_callback(lambda f: q.put(None))
    index = 0
    completed = False
    try:
        while True:
            item = q.get()
            if item is None:
                # the future resolved; the engine thread delivered every
                # token before it resolved it
                exc = fut.exception()
                if exc is not None:
                    yield {"error": str(exc)}
                completed = exc is None
                break
            t, done = item
            if filt is not None:
                text, ids, matched = filt.push(t)
                if not matched and done:
                    tail, tids, matched = filt.flush()
                    text += tail
                    ids = ids + tids
                if matched:
                    if text:
                        yield make_chunk(text, ids, index)
                        index += 1
                    if not done:
                        service.abort(fut)
                    completed = done
                    break
                if not text and not done:
                    continue  # held back: the ids stay in the filter
            else:
                text = dec.push(t)
                if done:
                    text += dec.flush()
                ids = [t]
            yield make_chunk(text, ids, index)
            index += 1
            if done:
                completed = True
                break
        if completed:
            try:
                req = fut.result(timeout=5.0)
            except (RuntimeError, concurrent.futures.TimeoutError):  # no usage event then
                req = None
            if req is not None:
                yield usage_chunk(_usage(req, len(req.out_tokens)))
        yield "[DONE]"
    finally:
        if not fut.done():
            service.abort(fut)


def completions(service: EngineService, body: Any, trace_ctx: "tracing.SpanContext | None" = None):
    """POST /v1/completions: a response object, or an event generator for
    ``stream``. ``trace_ctx``: the client's ``traceparent``."""
    if not isinstance(body, dict):
        raise BadRequest("request body must be a JSON object")
    gen = parse_generation(service, body, encode_prompt(service, body.get("prompt")))
    logprobs_n = parse_logprobs_n(service, body.get("logprobs"))
    echo = bool(body.get("echo"))
    model = body.get("model") or service.model
    if body.get("stream"):
        if logprobs_n > 0:
            raise BadRequest("integer logprobs is not supported with stream")
        if echo:
            raise BadRequest("echo is not supported with stream")
        return stream_events(
            service, gen,
            lambda text, ids, index: {"object": "text_completion", "model": model,
                                      "choices": [{"index": 0, "text": text, "token_ids": ids}]},
            lambda usage: {"object": "text_completion", "model": model, "choices": [], "usage": usage},
            trace_ctx,
        )
    reqs = gather_n(service, gen, logprobs_n > 0, want_plp=echo and bool(body.get("logprobs")), trace_ctx=trace_ctx)
    return completion_response(service, body, gen, reqs, logprobs_n)


def chat_completions(service: EngineService, body: Any, trace_ctx: "tracing.SpanContext | None" = None):
    """POST /v1/chat/completions: a response object, or an event
    generator for ``stream``; the first streamed delta carries the role."""
    if not isinstance(body, dict):
        raise BadRequest("request body must be a JSON object")
    gen = parse_generation(service, body, chat_tokens(service, body.get("messages")))
    top_n = parse_logprobs_n(service, body.get("top_logprobs"), "top_logprobs") if body.get("logprobs") else 0
    model = body.get("model") or service.model
    if body.get("stream"):
        if top_n > 0:
            raise BadRequest("top_logprobs is not supported with stream")

        def chunk(text, ids, index):
            delta: Dict[str, Any] = {"content": text}
            if index == 0:
                delta["role"] = "assistant"
            return {"object": "chat.completion.chunk", "model": model, "choices": [{"index": 0, "delta": delta}]}

        return stream_events(
            service, gen, chunk,
            lambda usage: {"object": "chat.completion.chunk", "model": model, "choices": [], "usage": usage},
            trace_ctx,
        )
    reqs = gather_n(service, gen, top_n > 0, trace_ctx=trace_ctx)
    return chat_response(service, body, gen, reqs, top_n)


def make_handler(service: EngineService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # keep stdout for the caller
            pass

        def _send(self, status: int, obj: Any) -> None:
            self._send_bytes(status, json.dumps(obj).encode(), "application/json")

        def _send_bytes(self, status: int, data: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _stream(self, events) -> None:
            """Server-sent events as a chunked response, one chunk per
            event; a write that fails (the client went away) closes the
            generator, which aborts the request."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for ev in events:
                    data = f"data: {ev if isinstance(ev, str) else json.dumps(ev)}\n\n".encode()
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                self.close_connection = True
            finally:
                events.close()

        def _body(self) -> Any:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            try:
                return json.loads(raw or b"{}")
            except ValueError:
                raise BadRequest("invalid JSON body")

        def _route(self, method: str) -> None:
            # every route runs under the caller's traceparent, if it sent
            # one: an admin verb's spans join the caller's trace
            with tracing.use_context(tracing.context_from_headers(self.headers)):
                self._dispatch(method)

        def _dispatch(self, method: str) -> None:
            url = urlparse(self.path)
            path = url.path.rstrip("/") or "/"
            try:
                if method == "POST":
                    # always read the body, so the connection stays usable
                    body = self._body()
                if unported_route(path):
                    raise BadRequest(f"{path} is not supported by this server yet")
                if method == "GET" and path == "/health":
                    if service.failure is not None:
                        return self._send(503, {"status": "FAILED", "error": service.failure})
                    if service.degraded is not None:
                        # healed in-process (a rolled-back swap): still serving
                        return self._send(200, {"status": "DEGRADED", "reason": service.degraded})
                    return self._send(200, {"status": "OK"})
                if path == "/v1/swap":
                    if method == "GET":  # a launcher's recovery read of a timed-out swap
                        return self._send(200, {**service.last_swap, "degraded": service.degraded})
                    if method == "POST":
                        return self._swap(body)
                if path == "/v1/prefetch":
                    if method == "POST":
                        return self._prefetch(body)
                    if method == "GET":
                        return self._send(200, service.prefetch_status())
                    if method == "DELETE":
                        return self._send(200, service.abort_prefetch())
                if path == "/v1/faults":
                    if method == "POST":
                        spec = body.get("spec") if isinstance(body, dict) else None
                        if not isinstance(spec, str) or not spec:
                            raise BadRequest("faults requires a 'spec' string")
                        try:
                            faults.arm_spec(spec)
                        except ValueError as e:
                            raise BadRequest(str(e))
                    elif method == "DELETE":
                        faults.reset()
                    return self._send(200, faults.describe())
                if method == "GET" and path == "/is_sleeping":
                    return self._send(200, {
                        "is_sleeping": service.sleeper.is_sleeping,
                        "devices_released": service.sleeper.devices_released,
                    })
                if method == "GET" and path == "/v1/models":
                    return self._send(200, {"object": "list", "data": [{"id": service.model, "object": "model"}]})
                if method == "GET" and path == "/v1/stats":
                    return self._send(200, service.stats())
                if method == "GET" and path == "/v1/costs":
                    # ?model= adds a candidate; priced on the engine thread
                    extra = [m for m in parse_qs(url.query).get("model", []) if m]
                    try:
                        return self._send(200, service.costs_report(extra))
                    except ValueError as e:
                        raise BadRequest(str(e))
                if method == "GET" and path == "/v1/actuations":
                    q = parse_qs(url.query)
                    try:
                        n = int(q.get("n", ["0"])[0] or 0)
                    except ValueError:
                        raise BadRequest("n must be an integer")
                    return self._send(200, service.actuations_view(n=n, kind=q.get("kind", [""])[0] or None))
                if method == "GET" and path == "/v1/device":
                    return self._send(200, service.device_info())
                if method == "GET" and path == "/metrics":
                    return self._send_bytes(200, service.metrics_text().encode(),
                                            "text/plain; version=0.0.4; charset=utf-8")
                if method == "GET" and path == "/v1/traces":
                    q = parse_qs(url.query)
                    status, text, ctype = tracing.export_http(
                        q.get("format", ["chrome"])[0], trace_id=q.get("trace_id", [""])[0] or None,
                        clear=q.get("clear", [""])[0] in ("1", "true"),
                    )
                    return self._send_bytes(status, text.encode(), ctype)
                if path == "/v1/profile":
                    if method == "GET":
                        return self._send(200, service.profile_status())
                    try:
                        if method == "POST":
                            log_dir = (body.get("log_dir") or "") if isinstance(body, dict) else ""
                            if not isinstance(log_dir, str):
                                raise BadRequest("log_dir must be a string")
                            return self._send(200, service.start_profile(log_dir))
                        if method == "DELETE":
                            return self._send(200, service.stop_profile())
                    except ProfileConflict as e:
                        return self._send(409, {"error": str(e)})
                if method == "POST" and path == "/sleep":
                    try:
                        level = int(parse_qs(url.query).get("level", ["1"])[0])
                        return self._send(200, service.sleep(level))
                    except ValueError as e:
                        raise BadRequest(str(e))
                if method == "POST" and path == "/wake_up":
                    return self._send(200, service.wake_up())
                if method == "POST" and path in ("/v1/completions", "/v1/chat/completions"):
                    run = completions if path == "/v1/completions" else chat_completions
                    try:
                        out = run(service, body, tracing.current_context())
                    except BadRequest:
                        raise
                    except ValueError as e:  # refused at admission
                        raise BadRequest(str(e))
                    except RuntimeError as e:
                        return self._send(500, {"error": str(e)})
                    if isinstance(out, dict):
                        return self._send(200, out)
                    return self._stream(out)
                return self._send(404, {"error": f"no route {method} {path}"})
            except BadRequest as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the request's boundary
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _swap(self, body: Any) -> None:
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            model = body.get("model")
            if not isinstance(model, str) or not model:
                raise BadRequest("swap requires a 'model' string")
            ckpt = body.get("checkpoint_dir") or ""
            if not isinstance(ckpt, str):
                raise BadRequest("checkpoint_dir must be a string")
            rid = body.get("request_id") or ""
            if not isinstance(rid, str):
                raise BadRequest("request_id must be a string")
            try:
                return self._send(200, service.swap(model, ckpt, request_id=rid))
            except ValueError as e:
                raise BadRequest(str(e))
            except SwapRolledBack as e:
                # the previous model serves again and the target is still
                # pooled: retryable, so 503
                return self._send(503, {"error": str(e), "rolled_back": True, "model": service.model})

        def _prefetch(self, body: Any) -> None:
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            model = body.get("model")
            if not isinstance(model, str) or not model:
                raise BadRequest("prefetch requires a 'model' string")
            ckpt = body.get("checkpoint_dir") or ""
            if not isinstance(ckpt, str):
                raise BadRequest("checkpoint_dir must be a string")
            try:
                return self._send(200, service.prefetch(model, ckpt))
            except (ValueError, FileNotFoundError) as e:
                raise BadRequest(str(e))

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_DELETE(self):
            self._route("DELETE")

    return Handler


def serve(service: EngineService, host: str, port: int) -> ThreadingHTTPServer:
    """Start the HTTP server on a background thread; ``port`` 0 picks a
    free port (``server.server_address`` has it). Stop with
    ``server.shutdown()``."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="http", daemon=True).start()
    return server


def run_server(args: argparse.Namespace) -> None:
    """The server's main, and the launcher's child body: check the
    options, build the service, serve until SIGTERM or SIGINT, then stop
    the server and the engine thread. Call it from the main thread (it
    installs the signal handlers)."""
    try:
        check_engine_options(args)
    except ValueError as e:
        raise SystemExit(str(e))
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    service = EngineService(args)  # loads the weights and captures the chunk graphs
    server = serve(service, args.host, args.port)
    eng = service.engine
    load = "" if service.load_stats is None else f" load={json.dumps(service.load_stats.summary())}"
    print(
        f"serving {args.model} on http://{args.host}:{server.server_address[1]} "
        f"(capture_s={eng.capture_s:.3f} graph_captures={eng.graph_captures} "
        f"mapped_bytes={sum(a.mapped_bytes for a in eng.arenas.values())}){load}",
        flush=True,
    )
    try:
        while not stop.wait(0.5):
            pass
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    run_server(make_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
