"""The port's engine HTTP server, on the standard library.

Port of ``llm_d_fast_model_actuation_tpu/engine/server.py``: one engine
thread fed by a submit queue, and the routes

  GET  /health, /is_sleeping, /v1/models, /v1/stats, /v1/swap, /v1/faults,
       /v1/prefetch, /v1/costs, /v1/actuations, /metrics, /v1/traces,
       /v1/profile, /v1/parked/{model}, /v1/parked/claims/{id}, /v1/residents
  POST /sleep?level=1|2, /wake_up, /v1/completions, /v1/chat/completions,
       /v1/swap, /v1/faults, /v1/prefetch, /v1/profile, /v1/parked,
       /v1/parked/release, /v1/parked/abort, /v1/residents
  DELETE /v1/faults, /v1/prefetch, /v1/profile, /v1/parked/claims/{id},
       /v1/residents

and one of the port's own, ``GET /v1/device``: the card the engine runs
on as the CUDA runtime names it, the kernel launches of this process and
its memory (:meth:`EngineService.device_info`), for a caller that did not start the
process itself, such as a launcher's client.

with the reference's flag names for the flags it keeps, among them
``--packed-serving on|off``, ``--token-budget``, ``--attention-impl``,
``--prefix-caching``, ``--decode-chunk``, ``--drain-tail`` (``single``:
``chunk`` is refused), ``--max-prefill-tokens``, ``--logprobs-topk``,
``--arrival-ewma-tau-s``,
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
``stop_token_ids``; their JSON and SSE shapes are the reference's. A
request's ``model`` routes it: the serving model (or none) is the base, an
attached co-resident variant is that variant, and any other name is a 400
that names the live set. Not ported yet and absent from the options: the
reference's other engine flags (``--pipeline-decode``,
``--speculative-ngram``, ``--quantization``, ``--checkpoint-dir``,
``--sleep-release-devices``, multi-host gangs:
``tests/test_torch_flags.py`` lists them), also where the reference
combines them with tensor parallelism.

**Co-resident sibling variants** (``--resident-variants N`` with
``--packed-serving on`` and ``--content-hash on``; ``--variant-hbm-mib``
budgets their bytes): ``POST /v1/residents {"model": ...}`` attaches a
sibling of the serving model, whose weights the pool, a prefetch or the
disk tier holds, as a variant beside it: only the leaves whose digests
differ from the base's go to the card (into the engine's arena), and a
completion whose ``model`` names it is routed to it inside the packed step
(``InferenceEngine.attach_variant``). ``DELETE /v1/residents`` detaches one
(409 while a request of it is live), ``GET`` lists the set with its
``ResidentSetLedger`` (``engine/model_pool.py``). The cap and the budget
refuse an attach with a 409; a sleep, a swap and a migration are refused
while a variant is attached. Refused with ``--tensor-parallel-size`` above
1 (ROADMAP queue 1 item 14).

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
tensor-parallel mesh and an Orbax ``checkpoint_dir`` (400s that say so).

**Zero-drain actuation** (``--zero-drain on``, ``engine/parked.py``): a
swap or a level-1 sleep parks the running and queued requests instead of
aborting them (their live KV pages to the host, the pool's memory back to
the card, the bundle pooled beside the slept weights and counted against
``--model-pool-mib``), and the wake or the swap back seats them again:
each stream goes on bit-exact, and ``reason="swap"`` aborts stay at zero.
A park that would overrun the pool budget, or whose page-out fails, falls
back to the abort path; a page-in that fails aborts the parked requests
with ``state_loss``, as does a level-2 sleep or the eviction of a parked
model. The swap response carries a ``zero_drain`` block and
``kv_pageout_bytes``/``kv_pagein_bytes``; ``/v1/stats.zero_drain`` counts
preempted, resumed, aborted and migrated requests. Refused with
``--tensor-parallel-size`` above 1 (ROADMAP queue 1 item 14).

**Live migration** (the reference's verbs, driven by the launcher's
``migrate`` and ``drain``): ``GET /v1/parked/{model}`` parks every stream
and exports the bundle as the reference's wire document under a
single-use fence (the engine serves new arrivals again at once), ``POST
/v1/parked`` checks and seats one on a sibling of the same weights (its
digests' fingerprint, or the same checkpoint directory, and the page
size) and answers with a claim per stream, ``POST /v1/parked/release``
commits (the source's proxy threads then carry each claim's tokens into
the original response, every token exactly once), ``POST
/v1/parked/abort`` resumes the bundle at home; ``GET
/v1/parked/claims/{id}`` is the destination's view of one stream, and
``DELETE`` aborts it. A bundle of the reference's seats here and one of
the port's there; a sampled stream whose generator key is the other
package's is refused (409), since neither can continue the other's.

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
so it equals the swap's ``bytes_moved``; under zero-drain a park's
page-out and a resume's page-in are priced from the pages themselves
(``parked_page_ids`` x page bytes) and added to the swap's and the
sleep's. ``GET /v1/actuations`` (``?n=&kind=``) serves the recorder, and
``/v1/stats`` its summary (``costs``). The ``migrate`` row prices an
export of the live work (``price_migrate``); the ``coresident`` rows price
an attach of each candidate (its delta's bytes from the digest diff, at
the ``coresident.h2d`` bandwidth) and a detach of each resident.

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
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
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
from .model_pool import HostModelPool, PrefetchedWeights, ResidentSetLedger
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
#: with everything under them: none is left
UNPORTED_ROUTES: Tuple[str, ...] = ()


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
        "--prefix-caching", default="on", choices=["on", "off"],
        help="automatic prefix caching: page-aligned KV reuse across requests "
        "sharing a prompt prefix",
    )
    p.add_argument(
        "--decode-chunk", type=int, default=0,
        help="decode steps per chunk, one host read each (0 = auto: 8 on the card "
        "and the CPU)",
    )
    p.add_argument(
        "--drain-tail", default="auto", choices=["auto", "single", "chunk"],
        help="accepted so that the reference's flag set parses: the port's drain "
        "tail is single T=1 steps (auto and single are the same); chunk, one full "
        "chunk with its surplus steps frozen, is refused",
    )
    p.add_argument(
        "--max-prefill-tokens", type=int, default=0,
        help="chunked prefill: segment prompts longer than this; 0 = off",
    )
    p.add_argument(
        "--logprobs-topk", type=int, default=5,
        help="top-k alternative logprobs computed per token on the device (OpenAI "
        "logprobs/top_logprobs; 0 disables)",
    )
    p.add_argument(
        "--arrival-ewma-tau-s", type=float, default=30.0,
        help="time constant (seconds) of the request arrival-rate EWMA "
        "(fma_engine_request_arrival_rate)",
    )
    p.add_argument(
        "--resident-variants", type=int, default=1,
        help="co-resident sibling variants: the most model variants on the card at "
        "once, the base included. N > 1 enables POST /v1/residents (a sibling's "
        "changed leaves beside the shared base tensors) and per-request routing "
        "by the completion's model inside the packed step. 1 (default) keeps the "
        "one-resident engine. Needs --packed-serving on and --content-hash on",
    )
    p.add_argument(
        "--variant-hbm-mib", type=int, default=0,
        help="card byte budget (MiB) for co-resident variant deltas: an attach over "
        "it is refused (409), the caller takes the swap path; 0 = no budget",
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
        "--zero-drain", default="off", choices=["on", "off"],
        help="zero-drain actuation: a swap or a level-1 sleep preempts the live "
        "requests (their KV pages paged out beside the slept weights, the "
        "scheduler rows and generator state kept) instead of aborting them, and "
        "resumes them bit-exact after the wake or the swap back; also what live "
        "migration (/v1/parked) needs. off (default) keeps the abort path",
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
    if args.decode_chunk < 0:
        raise ValueError("--decode-chunk must be >= 1, or 0 for auto")
    if args.max_prefill_tokens < 0:
        raise ValueError("--max-prefill-tokens must be >= 0")
    if args.drain_tail == "chunk":
        raise ValueError("--drain-tail chunk (one full chunk with its surplus steps frozen) is not ported; "
                         "the port's drain tail is single")
    if args.arrival_ewma_tau_s <= 0:
        raise ValueError("--arrival-ewma-tau-s must be > 0")
    if args.resident_variants < 1:
        raise ValueError("--resident-variants must be >= 1")
    if args.variant_hbm_mib < 0:
        raise ValueError("--variant-hbm-mib must be >= 0")
    if args.resident_variants > 1:
        if args.packed_serving != "on":
            raise ValueError(
                "--resident-variants > 1 requires --packed-serving on: per-request variant routing lives "
                "inside the packed mixed-batch step (the bucketed path always runs the base)")
        if args.content_hash != "on":
            raise ValueError("--resident-variants > 1 requires --content-hash on: the shared-base/delta "
                             "split is the digest diff")
        if args.tensor_parallel_size > 1:
            raise ValueError("--resident-variants > 1 on a tensor-parallel mesh is not ported yet "
                             "(ROADMAP queue 1 item 14)")
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
    if args.zero_drain == "on" and args.tensor_parallel_size > 1:
        raise ValueError("--zero-drain on a tensor-parallel mesh is not ported yet (ROADMAP queue 1 item 14)")
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


class MigrationRejected(Exception):
    """A migration verb refused before anything moved (weights that are not
    the same, no room, a spent fence, a sleeping engine, zero-drain off,
    the other package's generator key): a 409."""


class MigrationFailed(Exception):
    """A migration leg failed after its checks, and was recovered: the
    source resumed the streams at home, or the destination rolled back
    clean (a lost ack: the import is seated, and a retry replays its ack):
    a 500."""


class ResidentRejected(Exception):
    """POST /v1/residents refused by the cap, the ``--variant-hbm-mib``
    budget or an unresolvable sibling, or a detach refused while the
    variant has live work: a 409, and the caller takes the swap path."""


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
    #: the requests a zero-drain park took off this runtime's engine
    #: (``engine/parked.py:ParkedRequests``): pooled with its slept weights,
    #: seated again when it serves again
    parked: Any = None


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
        #: zero-drain actuation (--zero-drain): parks instead of aborts
        self._zero_drain = getattr(args, "zero_drain", "off") == "on"
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
        self._arrival = _RateEWMA(args.arrival_ewma_tau_s)
        self._finished_requests = 0
        self._generated_tokens = 0
        self._aborted: Dict[str, int] = {}
        self._actuations: Dict[str, int] = {}
        # zero-drain accounting (under _mu): every preempted request ends
        # one way, preempted == resumed + aborted + migrated
        self._zd = {"preempted": 0, "resumed": 0, "aborted": 0, "migrated": 0}
        self._zd_parked_bytes = 0
        # live migration: the exported bundle held under its fence until a
        # release or an abort spends it; the acks stored by fence (a retried
        # import replays its ack instead of seating twice); the claims of
        # streams migrated in; the proxies of streams migrated out, by
        # id(future), so a client that hangs up is one abort on each side
        self._migration: Optional[Dict[str, Any]] = None
        self._migration_gen = 0
        self._spent_fences: set = set()
        self._import_acks: Dict[str, Dict[str, Any]] = {}
        self._imported_claims: Dict[str, Dict[str, Any]] = {}
        self._mig = {
            "exported": 0, "imported": 0, "committed": 0, "resumed_local": 0, "rolled_back": 0, "state_loss": 0,
            "requests_out": 0, "requests_in": 0, "bytes_out": 0, "bytes_in": 0,
        }
        self._proxied: Dict[int, Dict[str, Any]] = {}
        #: the port's own: the last export's and import's seconds by leg
        #: (park, encode, serialize and send; read, identity, decode, seat)
        #: and wire bytes, in /v1/stats.migration_legs
        self._mig_last: Dict[str, Dict[str, Any]] = {"export": {}, "import": {}}
        # co-resident sibling variants: resident id -> {handle, nbytes,
        # source tier, ...} for every variant attached through
        # /v1/residents (the base is handle 0 and never an entry), each
        # handle's id, the cap (the base included), the card byte budget,
        # and the shared-base accounting
        self._residents: Dict[str, Dict[str, Any]] = {}
        self._variant_models: Dict[int, str] = {}
        self._resident_variants_cap = max(1, args.resident_variants)
        self._variant_hbm_budget = max(0, args.variant_hbm_mib) << 20
        self.resident_ledger = ResidentSetLedger()
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
            # 0 = auto: 8 off the TPU, the reference's choice there
            decode_chunk=args.decode_chunk or 8,
            prefix_caching=args.prefix_caching == "on",
            max_prefill_tokens=args.max_prefill_tokens,
            logprobs_topk=max(0, args.logprobs_topk),
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
        rt.engine.zero_drain_park = self._zero_drain
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
        and, when it violated a target, an exemplar. A routed request
        counts under its variant's name."""
        m = self.model
        if req.variant:
            m = self._variant_models.get(req.variant, m)
            fm.ENGINE_ROUTED_REQUESTS.labels(model=m).inc()
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

    def _finish_request_trace(self, req, now: float, violated: bool = False, aborted: bool = False,
                              migrated: bool = False, outcome: str = "") -> str:
        """Close a request's lifecycle trace: keep it when it was
        head-sampled or violated an SLO or was aborted or migrated (with
        ``--trace-requests 0`` a violated or aborted request gets a trace
        made here from its stamps), with one span for the whole decode
        window, never one per step (none for a stream migrated out: its
        decode goes on at the destination, which records it); stamp
        ``req.trace_id``. ``outcome``: the root's, by default "aborted" or
        "finished". Returns the trace id when the spans were kept, else
        ""."""
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
        if req.first_token_time is not None and now > req.first_token_time and not migrated:
            tr.add("request.decode", req.first_token_time, now, tokens=len(req.out_tokens),
                   finish_reason=req.finish_reason or "")
        keep = tr.sampled or violated or aborted or migrated
        tid = tr.finish(req.submit_time, now, keep, outcome=outcome or ("aborted" if aborted else "finished"),
                        violated=bool(violated), prompt_tokens=len(req.prompt), tokens=len(req.out_tokens),
                        preempt_s=round(req.preempt_s, 6))
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
            rec = self._proxied.pop(id(fut), None)
            if rec is not None:
                # a stream migrated out: its one client abort is counted
                # here, and the destination is told to abort its claim (it
                # counts its own); a parked one is dropped at its resume
                gone += 1
                self._abort_claims_async(rec["dest"], [rec["claim"]])
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
            # the slept state has no variant dimension; a detach is the
            # delta's offload (nothing moves: the tiers hold every chunk)
            self._refuse_with_residents("sleeping")
            rt = self._runtime
            self._digests(rt)  # the digest job reads the card
            was_sleeping, prev_level = self.sleeper.is_sleeping, self.sleeper.level
            # a level-1 offload is priced; a level-2 sleep discards
            pred = self._priced(self.price_sleep) if level == 1 and not was_sleeping else None
            t0 = time.monotonic()
            parked = None
            #: a park that fell back: the offload then moves the whole pool
            #: the prediction left out, so the record goes unpriced
            fallback = False
            with tracing.span("engine.sleep", level=level, model=self.model) as sp:
                if pred is not None:
                    sp.set(predicted_bytes=pred.get("predicted_bytes"), predicted_s=pred.get("predicted_s"))
                if level == 1 and not was_sleeping and self._zero_drain:
                    # page the live requests' KV out compactly first: the
                    # offload then moves the weights alone, and the wake
                    # seats the bundle again; a failed park keeps the whole
                    # pool's offload, which keeps the requests across the
                    # sleep as well
                    parked = self._park_current(park_pending=False)
                    if parked is not None:
                        rt.parked = parked
                    fallback = parked is None
                try:
                    out = self.sleeper.sleep(level)
                except Exception as e:
                    if parked is not None and rt.parked is parked:
                        # an offload has no rollback: the parked requests end
                        # cleanly (state_loss), and the engine gets its pool
                        # back in case it can still serve
                        rt.parked = None
                        try:
                            if rt.engine.kv_detached:
                                rt.engine.rebuild_kv_pool()
                        except Exception:  # noqa: BLE001 — the abort below stands either way
                            traceback.print_exc()
                        self._abort_parked_bundle(
                            parked, self.model, f"preempted requests lost: level-1 offload failed ({type(e).__name__}: {e})")
                    raise
                if int(self.sleeper.level) == 2 and rt.parked is not None:
                    # a level-2 edge drops the host state a parked bundle
                    # would resume against
                    b, rt.parked = rt.parked, None
                    self._abort_parked_bundle(b, self.model, "preempted requests lost: level-2 sleep discarded the parked state")
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
                priced = pred is not None and int(self.sleeper.level) == 1 and not fallback
                self._record_actuation(
                    "sleep", self.model,
                    # an L1 -> L2 change while asleep drops the host copy
                    trigger="escalation" if was_sleeping else "client",
                    tier="host" if int(self.sleeper.level) == 1 else "discard",
                    pred=pred if priced else None,
                    # a park's page-out is part of what this sleep moved,
                    # in its bytes and in its transfer window
                    actual_bytes=out.get("bytes_offloaded", 0) + (parked.kv_nbytes if parked else 0),
                    actual_s=(self.sleeper.stats.last_sleep_transfer_s + (parked.pageout_s if parked else 0.0))
                    if priced else (0.0 if was_sleeping else sleep_s),
                    extra={"preempted": parked.preempted} if parked else None,
                )
            if parked is not None:
                # the port's own: what the park moved, its pinning apart
                out = dict(out, zero_drain={"parked": parked.preempted, "kv_pageout_bytes": parked.kv_nbytes,
                                            "kv_pageout_s": round(parked.pageout_s, 6),
                                            "kv_pin_s": round(parked.pin_s, 6)})
            elif fallback:
                out = dict(out, zero_drain={"parked": 0, "fallback": "park failed (kv page-out)"})
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
                # zero-drain: the parked KV pages back into the rebuilt pool
                # and the streams go on mid-decode (a failed page-in ends
                # them with state_loss inside; the engine serves either way)
                resumed, pagein, resume_s, _dropped, short = self._resume_parked(self._runtime)
            self._bump_actuation("wake")
            st = self.sleeper.stats
            if was_l1 and st.last_wake_bytes:
                fm.ENGINE_ACTUATION_BYTES.labels(mode=st.last_quant or "off", dir="h2d").inc(st.last_wake_bytes)
            if was_l1 and st.last_wake_transfer_s > 0:
                fm.ENGINE_ACTUATION_SECONDS.labels(kind="wake", phase="h2d").observe(st.last_wake_transfer_s)
            fm.ENGINE_ACTUATION_SECONDS.labels(kind="wake", phase="total").observe(max(0.0, st.last_wake_seconds))
            priced = was_l1 and not short
            self._record_actuation(
                "wake", self.model, trigger="client", tier="host" if was_l1 else "cold",
                # a level-2 wake writes fresh weights, and a page-in that
                # fell short of the bundle moved less than priced: outside
                # the pricing
                pred=pred if priced else None,
                actual_bytes=st.last_wake_bytes + pagein if was_l1 else 0,
                actual_s=st.last_wake_transfer_s + resume_s if priced else (
                    st.last_wake_transfer_s if was_l1 else st.last_wake_seconds),
                extra={"resumed": resumed} if resumed else None,
            )
            if resumed or short:
                out = dict(out, zero_drain={"resumed": resumed, "kv_pagein_bytes": pagein,
                                            "kv_pagein_s": round(resume_s, 6),
                                            **({"restore_shortfall": True} if short else {})})
            return out

        return self._on_loop(wake)

    # -- zero-drain actuation: preempt, park, resume (engine/parked.py) ---------

    def _park_pageout_bytes(self) -> int:
        """The bytes a park of the serving engine would page out now: one
        page's bytes (``PagePool.page_nbytes``) times the live pages
        (``parked_page_ids``), the park's own arithmetic, so the predicted
        and the moved bytes agree exactly. 0 with zero-drain off."""
        if not self._zero_drain:
            return 0
        eng = self.engine
        m = eng.cfg.model
        per_page = PagePool.page_nbytes(m.num_layers, eng.cfg.page_size, m.num_kv_heads, m.head_dim, dtype=m.dtype)
        return per_page * len(eng.parked_page_ids())

    def _park_current(self, park_pending: bool):
        """Park the serving engine's live work into a bundle (on the
        engine thread, between steps): page the live KV out (fault point
        ``kvsave.d2h``), detach the scheduler, and move the displaced
        futures (and with ``park_pending`` the submissions still queued
        here) into the bundle. Returns None, the engine untouched, when the
        page-out failed: the caller takes the abort path."""
        eng = self.engine
        t0 = time.monotonic()
        try:
            bundle, _ = eng.park_requests(bucket_bytes=self._swap_bucket_bytes)
        except Exception:  # noqa: BLE001 — the abort path takes over
            traceback.print_exc()
            return None
        t1 = time.monotonic()
        for r in [pr.req for pr in bundle.live] + list(bundle.waiting):
            fut = self._futures.pop(r.seq_id, None)
            if fut is not None:
                bundle.futures[r.seq_id] = fut
            # the parked window [t0, resume] goes to the request's preempt leg
            r._park_t0, r._park_t1, r._park_pre_token = t0, t1, r.first_token_time is None
            if r.trace is not None:
                r.trace.add("request.preempt", t0, t1, kv_bytes=bundle.kv_nbytes)
        if park_pending:
            # queued submissions target the outgoing model: they park too
            with self._mu:
                bundle.pending, self._pending = self._pending, []
        if bundle.kv_nbytes:
            fm.ENGINE_KV_PAGEOUT.labels(dir="d2h").inc(bundle.kv_nbytes)
            # the gather's copy window alone (its pinning excluded)
            self.costs.observe_transfer("kvsave.d2h", bundle.kv_nbytes, bundle.pageout_s)
        with self._mu:
            self._zd["preempted"] += bundle.preempted
            self._zd_parked_bytes += bundle.kv_nbytes
        return bundle

    def _abort_parked_bundle(self, bundle, model: str, why: str) -> int:
        """A bundle that can never resume (its KV restore failed, its model
        was evicted, a level-2 sleep dropped its state): every displaced
        future fails with the ``state_loss`` cause, never a wedged slot."""
        exc = RuntimeError(why)
        now = time.monotonic()
        n = 0
        for r in [pr.req for pr in bundle.live] + list(bundle.waiting):
            fut = bundle.futures.get(r.seq_id)
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            self._finish_request_trace(r, now, aborted=True, outcome="state_loss")
            n += 1
        for kw, fut in bundle.pending:
            if not fut.done():
                fut.set_exception(exc)
            if kw.get("trace") is not None:
                kw["trace"].finish(kw.get("submit_time", now), now, keep=True, outcome="state_loss")
            n += 1
        if n:
            self._count_abort("state_loss", n)
            fm.ENGINE_PREEMPTED.labels(model=model, outcome="aborted").inc(n)
        with self._mu:
            self._zd["aborted"] += n
            self._zd_parked_bytes -= bundle.kv_nbytes
        return n

    def _abort_parked(self, rt: _ModelRuntime, model: str, why: str) -> None:
        """:meth:`_abort_parked_bundle` of ``rt``'s bundle, if it has one."""
        if rt is not None and rt.parked is not None:
            b, rt.parked = rt.parked, None
            self._abort_parked_bundle(b, model, why)

    def _resume_parked(self, rt: _ModelRuntime) -> tuple:
        """Seat a runtime's parked bundle into its engine (awake, its pool
        rebuilt): page the KV in (fault point ``kvrestore.h2d``), give the
        futures and the queued submissions back, and let the loop go on.
        Returns ``(resumed, pagein_bytes, seconds, dropped, shortfall)``:
        ``dropped`` counts parked requests whose clients left meanwhile;
        ``shortfall`` is set whenever the page-in moved fewer bytes than
        the bundle holds (dropped clients, or a failed restore), so the
        caller records the actuation unpriced. A failed restore ends the
        live requests with ``state_loss`` and leaves the engine serving;
        the re-queued waiting and pending ones, which carried no KV, count
        as resumed, so preempted == resumed + aborted + migrated holds."""
        from .parked import ParkedResumeFailed

        bundle = rt.parked
        if bundle is None:
            return 0, 0, 0.0, 0, False
        rt.parked = None
        with self._mu:
            self._zd_parked_bytes -= bundle.kv_nbytes
        model = rt.model_id

        def dead(seq_id: int) -> bool:
            fut = bundle.futures.get(seq_id)
            return fut is not None and fut.done()

        # clients that went away while parked: dropped before seating
        gone = [pr.req for pr in bundle.live if dead(pr.req.seq_id)] + [r for r in bundle.waiting if dead(r.seq_id)]
        bundle.live = [pr for pr in bundle.live if not dead(pr.req.seq_id)]
        bundle.waiting = [r for r in bundle.waiting if not dead(r.seq_id)]
        if gone:
            self._count_abort("client", len(gone))
            fm.ENGINE_PREEMPTED.labels(model=model, outcome="aborted").inc(len(gone))
            with self._mu:
                self._zd["aborted"] += len(gone)
            now = time.monotonic()
            for r in gone:
                self._finish_request_trace(r, now, aborted=True)
        t0 = time.monotonic()
        try:
            n_live, moved = rt.engine.resume_parked(bundle, bucket_bytes=self._swap_bucket_bytes)
        except ParkedResumeFailed as e:
            # unwound inside the engine; the live requests' KV is gone
            exc = RuntimeError(f"preempted request aborted: zero-drain KV restore failed ({e})")
            tloss = time.monotonic()
            for pr in bundle.live:
                fut = bundle.futures.get(pr.req.seq_id)
                if fut is not None and not fut.done():
                    fut.set_exception(exc)
                self._finish_request_trace(pr.req, tloss, aborted=True, outcome="state_loss")
            for r in bundle.waiting:
                fut = bundle.futures.get(r.seq_id)
                if fut is not None and not fut.done():
                    self._futures[r.seq_id] = fut
            with self._mu:
                self._pending.extend(bundle.pending)
            nlost, requeued = len(bundle.live), len(bundle.waiting) + len(bundle.pending)
            if nlost:
                self._count_abort("state_loss", nlost)
                fm.ENGINE_PREEMPTED.labels(model=model, outcome="aborted").inc(nlost)
            if requeued:
                fm.ENGINE_PREEMPTED.labels(model=model, outcome="resumed").inc(requeued)
            with self._mu:
                self._zd["aborted"] += nlost
                self._zd["resumed"] += requeued
            fm.ENGINE_RECOVERIES.labels(path="kvrestore", outcome="rolled_back").inc()
            self.degraded = f"zero-drain resume aborted {nlost} preempted request(s) with state_loss: {e}"
            self._work.set()
            return 0, 0, time.monotonic() - t0, len(gone), True
        t3 = time.monotonic()
        resume_s = t3 - t0
        if moved:
            fm.ENGINE_KV_PAGEOUT.labels(dir="h2d").inc(moved)
            self.costs.observe_transfer("kvrestore.h2d", moved, resume_s)
        for r in [pr.req for pr in bundle.live] + list(bundle.waiting):
            pt0 = getattr(r, "_park_t0", None)
            if pt0 is not None:
                r.preempt_s += max(0.0, t3 - pt0)
                if r._park_pre_token:
                    r.preempt_pre_token_s += max(0.0, t3 - pt0)
                if r.trace is not None:
                    r.trace.add("request.park", r._park_t1, t0)
                    r.trace.add("request.resume", t0, t3, kv_bytes=moved)
                r._park_t0 = None
        for seq_id, fut in bundle.futures.items():
            if not fut.done():
                self._futures[seq_id] = fut
        with self._mu:
            self._pending.extend(bundle.pending)
        resumed = n_live + len(bundle.waiting) + len(bundle.pending)
        if resumed:
            fm.ENGINE_PREEMPTED.labels(model=model, outcome="resumed").inc(resumed)
        with self._mu:
            self._zd["resumed"] += resumed
        self._work.set()
        return resumed, moved, resume_s, len(gone), bool(gone)

    def _unpark_current(self, rt: _ModelRuntime) -> None:
        """The rollback leg of a failed actuation that had parked: the
        requests go back to serving (the pool rebuilt first if the park's
        release still holds)."""
        if rt.parked is None:
            return
        try:
            if rt.engine.kv_detached:
                rt.engine.rebuild_kv_pool()
        except Exception as e:  # noqa: BLE001 — the requests end cleanly instead
            self._abort_parked(rt, rt.model_id, f"preempted requests lost: the KV pool could not be rebuilt ({e})")
            return
        self._resume_parked(rt)

    # -- live request migration: the fenced handoff of a parked bundle to a
    # sibling (the launcher's migrate and drain verbs drive it) ---------------
    #
    #   source GET  /v1/parked/{model}   export_parked:   park, encode
    #   dest   POST /v1/parked           import_parked:   check, seat
    #   source POST /v1/parked/release   release_parked:  commit, proxy
    #   source POST /v1/parked/abort     abort_migration: resume at home
    #
    # The export mints a single-use fence; the import stores its ack under
    # it (a retried import replays the ack, never seats twice), and release
    # or abort spend it once (a second is a 409). Clients only ever resolve
    # through the source's own futures: after the release a watcher thread
    # per stream carries the destination's claim into them.

    def _migration_identity(self) -> Dict[str, Any]:
        """What both ends of a handoff compare: the model, its checkpoint
        directory and a fingerprint over its weight digests. Random weights
        (no digests, no directory) have no identity to prove and are
        refused."""
        from . import parked as parked_mod

        rt = self._runtime
        digests = self._digests(rt) if self._content_hash else None
        if not digests and not rt.hf_dir:
            raise MigrationRejected(
                "no provable weight identity (no content digests and no checkpoint): migration between "
                "random-init engines is refused")
        return {
            "model": self.model,
            "checkpoint_dir": rt.hf_dir,
            "weight_fingerprint": parked_mod.weight_fingerprint(digests) if digests else "",
            "page_size": int(self.args.page_size),
            "vocab_size": int(self.engine.cfg.model.vocab_size),
            "max_model_len": int(self.args.max_model_len or 0),
        }

    def _check_identity(self, theirs: Dict[str, Any]) -> None:
        """The import's identity gate: the fingerprints decide when both
        sides have one, else the checkpoint directory must be the same."""
        mine = self._migration_identity()
        if theirs.get("model") != mine["model"]:
            raise MigrationRejected(f"model identity mismatch: bundle is {theirs.get('model')!r}, "
                                    f"serving {mine['model']!r}")
        fp_t, fp_m = theirs.get("weight_fingerprint") or "", mine["weight_fingerprint"]
        if fp_t and fp_m:
            if fp_t != fp_m:
                raise MigrationRejected("weight fingerprint mismatch: same model name, different weights "
                                        "(refusing to seat KV onto foreign weights)")
        elif not mine["checkpoint_dir"] or (theirs.get("checkpoint_dir") or "") != mine["checkpoint_dir"]:
            raise MigrationRejected("no comparable weight identity (enable --content-hash or serve both "
                                    "instances from the same checkpoint)")
        if int(theirs.get("page_size", -1)) != mine["page_size"]:
            raise MigrationRejected(f"page_size mismatch ({theirs.get('page_size')} != {mine['page_size']}): "
                                    "KV pages are not portable")

    @staticmethod
    def _encode_pending(kw: Dict[str, Any]) -> Dict[str, Any]:
        """A queued submission as the reference's wire spec. Its future and
        streaming hook stay at the source (the proxy resolves them), and its
        submit time too: the importer stamps its own."""
        spec = {
            "prompt": [int(t) for t in kw["prompt"]],
            "max_tokens": int(kw.get("max_new_tokens", 16)),
            "temperature": float(kw.get("temperature", 0.0)),
            "top_p": float(kw.get("top_p", 1.0)),
            "stop_seqs": [list(s) for s in kw.get("stop_seqs") or ()],
            "presence_penalty": float(kw.get("presence_penalty", 0.0)),
            "frequency_penalty": float(kw.get("frequency_penalty", 0.0)),
            "want_top_logprobs": bool(kw.get("want_top_logprobs", False)),
            "want_prompt_logprobs": bool(kw.get("want_prompt_logprobs", False)),
            "seed": None if kw.get("seed") is None else int(kw["seed"]),
            "ignore_eos": bool(kw.get("ignore_eos", False)),
            "logit_bias": {str(t): float(v) for t, v in (kw.get("logit_bias") or {}).items()},
            "variant": int(kw.get("variant", 0) or 0),
        }
        if kw.get("trace") is not None:
            ctx = kw["trace"].context()
            spec["trace"] = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
        return spec

    @staticmethod
    def _decode_pending(spec: Dict[str, Any]) -> Dict[str, Any]:
        """A wire spec as a queued submission's ``add_request`` keywords;
        its trace joins the origin's."""
        kw = {
            "prompt": [int(t) for t in spec["prompt"]],
            "max_new_tokens": int(spec["max_tokens"]),
            "temperature": float(spec["temperature"]),
            "top_p": float(spec["top_p"]),
            "stop_seqs": tuple(tuple(int(t) for t in s) for s in spec.get("stop_seqs", ())),
            "presence_penalty": float(spec["presence_penalty"]),
            "frequency_penalty": float(spec["frequency_penalty"]),
            "want_top_logprobs": bool(spec["want_top_logprobs"]),
            "want_prompt_logprobs": bool(spec["want_prompt_logprobs"]),
            "seed": None if spec["seed"] is None else int(spec["seed"]),
            "ignore_eos": bool(spec["ignore_eos"]),
            "logit_bias": {int(t): float(v) for t, v in spec.get("logit_bias", {}).items()} or None,
            "submit_time": time.monotonic(),
            "variant": int(spec.get("variant", 0) or 0),
        }
        tr = spec.get("trace")
        if isinstance(tr, dict) and tr.get("trace_id") and tracing.enabled():
            # migrated-in work is always kept (the handoff's forensics)
            kw["trace"] = tracing.RequestTrace(
                sampled=True, parent=tracing.SpanContext(str(tr["trace_id"]), str(tr.get("span_id", ""))))
        return kw

    def _key_nbytes(self, req) -> int:
        eng = self.engine
        if req.temperature > 0 and req.slot >= 0 and eng._gens[req.slot] is not None:
            return eng._gens[req.slot].get_state().numel()
        return 8  # parked.greedy_key: two uint32 words

    def price_migrate(self) -> Dict[str, Any]:
        """The predicted cost of exporting the serving engine's live work:
        its live KV pages (the park's own arithmetic) plus each live
        request's scheduler rows (a ``[vocab]`` int32 counts row and its
        key), at the ``migrate.export`` bandwidth. What ``/v1/costs``
        shows, so a launcher can pick a cheap moment to drain."""
        eng = self.engine
        park = self._park_pageout_bytes()
        live = [r for r in eng._slots if r is not None and not r.done and not r.prefilling]
        meta = sum(int(eng.cfg.model.vocab_size) * 4 + self._key_nbytes(r) for r in live)
        predicted = park + meta
        s, measured = self.costs.bandwidths.seconds_for("migrate.export", predicted)
        with self._mu:
            pending = len(self._pending)
        return {
            "kind": "migrate", "model": self.model, "enabled": self._zero_drain,
            "predicted_bytes": predicted, "predicted_kv_bytes": park, "predicted_s": round(s, 6),
            "measured": measured, "requests": len(live) + len(eng._waiting) + pending,
        }

    def _export_failed(self, bundle, model: str, t0: float, e: BaseException) -> None:
        """An export leg failed after the park: the bundle never left, so it
        resumes here (on the engine thread)."""
        rt = self._runtime
        rt.parked = bundle
        self._unpark_current(rt)
        with self._mu:
            self._mig["resumed_local"] += 1
        fm.ENGINE_MIGRATIONS.labels(role="source", outcome="resumed_local").inc()
        self._record_actuation("migrate", model, trigger="export", tier="wire", pred=None, actual_bytes=0,
                               actual_s=time.monotonic() - t0, outcome="resumed_local",
                               extra={"error": f"{type(e).__name__}: {e}"})

    def export_parked(self, model: str) -> Dict[str, Any]:
        """GET /v1/parked/{model}: park every stream and encode the bundle
        for a sibling. The pool is rebuilt at once, so new arrivals are
        served during the handoff, and the bundle is held under a fence
        until a release or an abort. Fault point ``migrate.export`` fires
        after the park; its recovery is a resume at home (nothing left the
        process). The encoding runs off the engine thread."""
        from . import parked as parked_mod

        if model != self.model:
            raise MigrationRejected(f"model {model!r} is not the serving model (serving {self.model!r})")
        self._refuse_with_residents("migrating the base", MigrationRejected)
        if not self._zero_drain:
            raise MigrationRejected("zero-drain parking is off (--zero-drain off): nothing can be parked for migration")
        identity = self._migration_identity()
        t0 = time.monotonic()
        with tracing.span("migrate.export", model=model) as sp:

            def park():
                t_park = time.monotonic()
                if self.sleeper.is_sleeping:
                    raise MigrationRejected("instance is sleeping; wake it before migrating")
                if self._migration is not None:
                    raise MigrationRejected(f"a migration is already in flight (fence {self._migration['token']})")
                pred = self._priced(self.price_migrate)
                bundle = self._park_current(park_pending=True)
                if bundle is None:
                    raise MigrationFailed("zero-drain park failed; nothing was displaced (streams still live)")
                try:
                    faults.fire("migrate.export")
                    # the pool again now: new arrivals serve during the
                    # handoff, and an abort resumes into it
                    self.engine.rebuild_kv_pool()
                except Exception as e:  # noqa: BLE001 — resumed at home
                    self._export_failed(bundle, model, t0, e)
                    raise MigrationFailed(f"export failed ({e}); streams resumed locally") from e
                import uuid

                self._migration_gen += 1
                token = f"mig-{self._migration_gen}-{uuid.uuid4().hex[:12]}"
                self._migration = {"token": token, "gen": self._migration_gen, "bundle": bundle, "model": model,
                                   "pred": pred, "t0": t0, "requests": bundle.preempted, "nbytes": 0}
                self._mig_last["export"] = {"park_s": round(time.monotonic() - t_park, 6),
                                            "kv_pageout_s": round(bundle.pageout_s, 6),
                                            "kv_pin_s": round(bundle.pin_s, 6), "kv_bytes": bundle.kv_nbytes}
                self._work.set()
                return bundle, self._migration

            bundle, mig = self._on_loop(park)
            token = mig["token"]
            t_enc = time.monotonic()
            try:
                doc = parked_mod.encode_wire(bundle, identity, chunk_bytes=self._swap_bucket_bytes)
                eng = self.engine
                for r, spec in zip(bundle.waiting, doc["requests"]["waiting"]):
                    if r.seed is None:
                        # the stream this engine would have drawn from (its
                        # seed, the request's id): the importer's ids differ
                        spec["rng_key_data"] = parked_mod.pack_array(np.array([eng.stream_seed(r)], dtype=np.uint64))
                doc["requests"]["pending"] = [self._encode_pending(kw) for kw, _ in bundle.pending]
            except Exception as e:  # noqa: BLE001 — resumed at home

                def home():
                    self._migration = None
                    self._spent_fences.add(token)
                    self._export_failed(bundle, model, t0, e)

                self._on_loop(home)
                raise MigrationFailed(f"export failed ({e}); streams resumed locally") from e
            doc["fence"] = {"token": token, "gen": mig["gen"], "source_model": model}
            self._mig_last["export"]["encode_s"] = round(time.monotonic() - t_enc, 6)
            nbytes = mig["nbytes"] = int(doc["nbytes"])
            encode_s = time.monotonic() - t0
            if nbytes:
                self.costs.observe_transfer("migrate.export", nbytes, encode_s)
            fm.ENGINE_MIGRATE_BYTES.labels(dir="export").inc(nbytes)
            with self._mu:
                self._mig["exported"] += 1
                self._mig["bytes_out"] += nbytes
            sp.set(nbytes=nbytes, requests=bundle.preempted, fence=token, encode_s=round(encode_s, 6))
            return doc

    def import_parked(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """POST /v1/parked: check and seat a sibling's bundle. Everything
        is checked before the engine changes (the wire version and every
        KV chunk's digest, off the engine thread; the weights' identity;
        the generator keys; the slots and pages), so a refusal leaves the
        destination untouched, and a seat that fails takes the foreign
        requests out again. The ack is stored under the fence before the
        ``migrate.ack`` fault point fires, so a retry after a lost ack
        replays it instead of seating twice."""
        from . import parked as parked_mod
        from .engine import Request

        fence = doc.get("fence") or {}
        token = str(fence.get("token") or "")
        if not token:
            raise ValueError("parked import without a fence token")
        with self._mu:
            replay = self._import_acks.get(token)
        if replay is not None:
            return dict(replay)
        if token in self._spent_fences:
            raise MigrationRejected(f"fence token {token!r} already spent (double-resume refused)")
        if self.sleeper.is_sleeping:
            raise MigrationRejected("instance is sleeping; wake it before importing")
        self._refuse_with_residents("importing a parked bundle", MigrationRejected)
        # a variant handle names a resident of the engine that attached it,
        # and none is attached here: only base requests may be seated
        specs = doc.get("requests") or {}
        routed = sorted({int(s.get("variant", 0) or 0) for part in ("live", "waiting", "pending")
                         for s in specs.get(part) or ()} - {0})
        if routed:
            raise ValueError(f"parked requests route to co-resident variant handles {routed}: a handle belongs "
                             "to the engine that attached it, and only base requests migrate")
        t0 = time.monotonic()
        self._check_identity(doc.get("identity") or {})
        last = {"identity_s": round(time.monotonic() - t0, 6)}
        with tracing.span("migrate.import", model=self.model, fence=token) as sp:
            # every chunk's digest (a ValueError: a 400)
            t_dec = time.monotonic()
            bundle, pending_specs = parked_mod.decode_wire(doc, Request, pin=self._pin_host)
            last["decode_s"] = round(time.monotonic() - t_dec, 6)
            pending_kws = [self._decode_pending(spec) for spec in pending_specs]
            self._check_keys(bundle)
            try:
                faults.fire("migrate.import")
            except faults.FaultError as e:
                with self._mu:
                    self._mig["rolled_back"] += 1
                fm.ENGINE_MIGRATIONS.labels(role="destination", outcome="rolled_back").inc()
                raise MigrationFailed(f"import failed before seating ({e}); destination clean") from e

            def seat():
                import uuid

                with self._mu:
                    if token in self._import_acks:
                        return dict(self._import_acks[token]), 0
                eng = self.engine
                if self.sleeper.is_sleeping or eng.kv_detached:
                    raise MigrationRejected("the engine is sleeping or mid-actuation; retry after it settles")
                free_slots = sum(1 for s in eng._slots if s is None)
                if len(bundle.live) > free_slots:
                    raise MigrationRejected(f"no capacity: {len(bundle.live)} live streams need slots, "
                                            f"{free_slots} free")
                # sharing-blind: a resume allocates each stream's whole budget
                need = sum(PageAllocator.pages_needed(len(pr.req.prompt) + pr.req.max_new_tokens, eng.cfg.page_size)
                           for pr in bundle.live)
                if need > eng.allocator.available:
                    raise MigrationRejected(f"no capacity: bundle needs up to {need} KV pages, "
                                            f"{eng.allocator.available} free")
                # this engine's ids; the claims map (source seq_id -> claim
                # id) lets the source proxy each stream to its client
                claims: Dict[str, str] = {}
                recs: List[tuple] = []
                for r in [pr.req for pr in bundle.live] + list(bundle.waiting):
                    old = int(r.seq_id)
                    r.seq_id = eng.new_seq_id()
                    cid = uuid.uuid4().hex
                    claims[str(old)] = cid
                    recs.append((cid, r))
                waiting = list(bundle.waiting)
                try:
                    n_live, moved = eng.resume_parked(bundle, bucket_bytes=self._swap_bucket_bytes)
                except parked_mod.ParkedResumeFailed as e:
                    # the engine queued the waiting ones again: right at
                    # home, wrong here (the source still owns them)
                    drop = {id(r) for r in waiting}
                    eng._waiting = [r for r in eng._waiting if id(r) not in drop]
                    with self._mu:
                        self._mig["rolled_back"] += 1
                    fm.ENGINE_MIGRATIONS.labels(role="destination", outcome="rolled_back").inc()
                    raise MigrationFailed(f"import seat failed ({e}); destination rolled back clean") from e
                t_seat = time.monotonic()
                for cid, r in recs:
                    fut: concurrent.futures.Future = concurrent.futures.Future()
                    self._futures[r.seq_id] = fut
                    self._imported_claims[cid] = {"req": r, "fut": fut}
                    if r.trace_parent and tracing.enabled():
                        # the origin's trace: same trace id, parented on the
                        # source's lifecycle root, always kept
                        r.trace = tracing.RequestTrace(sampled=True, parent=tracing.SpanContext(
                            str(r.trace_parent["trace_id"]), str(r.trace_parent.get("span_id", ""))))
                        r.trace.add("request.resume", t0, t_seat, migrated=True, fence=token)
                for i, kw in enumerate(pending_kws):
                    fut = concurrent.futures.Future()
                    cid = uuid.uuid4().hex
                    claims[f"p{i}"] = cid
                    self._imported_claims[cid] = {"req": None, "fut": fut}
                    with self._mu:
                        self._pending.append((kw, fut))
                ack = {
                    "ok": True, "fence_token": token, "model": self.model, "seated": n_live,
                    "waiting": len(waiting), "pending": len(pending_kws), "requests": len(recs) + len(pending_kws),
                    "kv_bytes": moved, "claims": claims,
                }
                with self._mu:
                    self._import_acks[token] = dict(ack)
                self._work.set()
                return ack, moved

            t_seat = time.monotonic()
            ack, moved = self._on_loop(seat)
            self._mig_last["import"] = dict(last, seat_s=round(time.monotonic() - t_seat, 6), kv_pagein_bytes=moved)
            if moved:
                # this window holds the decode and the digests too: the
                # kvrestore.h2d bandwidth sees transfer windows only
                fm.ENGINE_KV_PAGEOUT.labels(dir="h2d").inc(moved)
            import_s = time.monotonic() - t0
            nbytes = int(doc.get("nbytes", 0))
            if nbytes:
                self.costs.observe_transfer("migrate.import", nbytes, import_s)
            fm.ENGINE_MIGRATE_BYTES.labels(dir="import").inc(nbytes)
            n_req = ack["requests"]
            with self._mu:
                self._mig["imported"] += 1
                self._mig["bytes_in"] += nbytes
                self._mig["requests_in"] += n_req
            fm.ENGINE_MIGRATIONS.labels(role="destination", outcome="imported").inc()
            self._record_actuation("migrate", self.model, trigger="import", tier="wire", pred=None,
                                   actual_bytes=nbytes, actual_s=import_s, outcome="imported",
                                   extra={"requests": n_req, "fence": token})
            sp.set(nbytes=nbytes, requests=n_req, seated=ack["seated"])
            try:
                faults.fire("migrate.ack")
            except faults.FaultError as e:
                # the seat stands and its ack replays on the retry: only the
                # answer is lost
                raise MigrationFailed(f"import ack lost ({e}); retry the import (fenced, idempotent)") from e
            return ack

    def _check_keys(self, bundle) -> None:
        """Refuse (409) a sampled stream whose generator key this engine
        cannot continue: the reference's threefry key, or the generator
        state of another kind of device. A greedy stream draws nothing."""
        from .parked import key_kind

        own = torch.Generator(device=self.engine.device).get_state().numel()
        for pr in bundle.live:
            if pr.req.temperature <= 0:
                continue
            if key_kind(pr.key_data) != "torch":
                raise MigrationRejected("a sampled stream carries the reference package's generator key, which "
                                        "this engine cannot continue (refusing rather than resampling it)")
            if pr.key_data.size != own:
                raise MigrationRejected(f"a sampled stream's generator state has {pr.key_data.size} bytes, this "
                                        f"device's {own}: it was parked on another kind of device")
        for r in bundle.waiting:
            if r.temperature > 0 and key_kind(r.rng_key_data) == "jax":
                raise MigrationRejected("a sampled waiting request carries the reference package's generator "
                                        "key, which this engine cannot continue")

    def release_parked(self, token: str, dest: str = "", claims: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """POST /v1/parked/release: the destination acked the import:
        commit. Spends the fence (a second release, or an abort after it,
        is a 409) and hands every displaced stream to a watcher thread that
        carries the destination's claim into the original future and
        streaming hook: the client never reconnects, and each token arrives
        once because only this side resolves these futures."""

        def spend():
            mig = self._migration
            if mig is None or mig["token"] != token:
                raise MigrationRejected(f"fence token {token!r} is not the in-flight migration (spent or unknown)")
            self._migration = None
            self._spent_fences.add(token)
            return mig

        mig = self._on_loop(spend)
        bundle, model = mig["bundle"], mig["model"]
        claims = dict(claims or {})
        with tracing.span("migrate.release", model=model, fence=token):
            watchers = lost = gone = 0
            gone_claims: List[str] = []
            now = time.monotonic()
            # (Request or None, the pending submission's keywords or None,
            # future, claim id)
            streams = [(r, None, bundle.futures.get(r.seq_id), claims.get(str(int(r.seq_id))))
                       for r in [pr.req for pr in bundle.live] + list(bundle.waiting)]
            streams += [(None, kw, fut, claims.get(f"p{i}")) for i, (kw, fut) in enumerate(bundle.pending)]
            for r, kw, fut, cid in streams:
                if fut is None or fut.done():
                    # the client left while the bundle was away: one client
                    # abort here, and the destination is told to abort its
                    # claim (it counts its own)
                    gone += 1
                    if cid:
                        gone_claims.append(cid)
                    self._finish_migrated(r, kw, mig["t0"], now, dest, "aborted")
                    continue
                if not cid:
                    fut.set_exception(RuntimeError("migrated stream lost: destination acked no claim for it"))
                    self._count_abort("state_loss")
                    lost += 1
                    self._finish_migrated(r, kw, mig["t0"], now, dest, "state_loss")
                    continue
                self._finish_migrated(r, kw, mig["t0"], now, dest, "migrated")
                self._start_claim_watcher(dest, cid, r if r is not None else self._pending_proxy_req(kw), fut)
                watchers += 1
            n = bundle.preempted
            migrated = n - lost - gone
            if gone:
                self._count_abort("client", gone)
            if lost or gone:
                fm.ENGINE_PREEMPTED.labels(model=model, outcome="aborted").inc(lost + gone)
            if migrated:
                fm.ENGINE_PREEMPTED.labels(model=model, outcome="migrated").inc(migrated)
            with self._mu:
                self._zd["migrated"] += migrated
                self._zd["aborted"] += lost + gone
                self._zd_parked_bytes -= bundle.kv_nbytes
                self._mig["committed"] += 1
                self._mig["requests_out"] += migrated
            if gone_claims:
                self._abort_claims_async(dest, gone_claims)
            fm.ENGINE_MIGRATIONS.labels(role="source", outcome="committed").inc()
            self._record_actuation("migrate", model, trigger="migrate", tier="wire", pred=mig["pred"],
                                   actual_bytes=mig["nbytes"], actual_s=time.monotonic() - mig["t0"],
                                   outcome="committed",
                                   extra={"requests": n, "proxied": watchers, "fence": token, "dest": dest or None})
            return {"ok": True, "fence_token": token, "model": model, "migrated": migrated, "proxied": watchers}

    def _finish_migrated(self, req, kw, t0: float, now: float, dest: str, outcome: str) -> None:
        """The source's close of a stream handed away: a ``request.migrate``
        span over the handoff, then its lifecycle root with ``outcome``,
        always kept (the destination's spans carry the same trace id)."""
        tr = req.trace if req is not None else kw.get("trace")
        if tr is None:
            return
        tr.add("request.migrate", t0, now, dest=dest or "", outcome=outcome)
        if req is not None:
            tr.sampled = True
            self._finish_request_trace(req, now, migrated=True, outcome=outcome)
        else:
            tr.finish(kw.get("submit_time", now), now, keep=True, outcome=outcome)

    def abort_migration(self, token: str) -> Dict[str, Any]:
        """POST /v1/parked/abort: the handoff failed after the export (the
        import failed twice, or the destination is gone): spend the fence
        and resume the bundle at home, the recovery of every single fault.
        Only a second fault (the page-in failing too) ends in
        ``state_loss``."""

        def go():
            mig = self._migration
            if mig is None or mig["token"] != token:
                raise MigrationRejected(f"fence token {token!r} is not the in-flight migration (spent or unknown)")
            self._migration = None
            self._spent_fences.add(token)
            model = mig["model"]
            resumed = moved = dropped = 0
            seconds, shortfall = 0.0, True
            with tracing.span("migrate.abort", model=model, fence=token):
                rt = self._runtime
                rt.parked = mig["bundle"]
                try:
                    if rt.engine.kv_detached:
                        rt.engine.rebuild_kv_pool()
                except Exception:  # noqa: BLE001 — a double fault: aborted below
                    traceback.print_exc()
                if not rt.engine.kv_detached:
                    resumed, moved, seconds, dropped, shortfall = self._resume_parked(rt)
                self._abort_parked(rt, model, "preempted request aborted: migration aborted and the KV pool could "
                                              "not be rebuilt (state_loss)")
                outcome = "resumed_local"
                if shortfall and resumed == 0 and mig["requests"] > dropped:
                    outcome = "state_loss"
                with self._mu:
                    self._mig[outcome] += 1
                fm.ENGINE_MIGRATIONS.labels(role="source", outcome=outcome).inc()
                self._record_actuation("migrate", model, trigger="abort", tier="wire", pred=None,
                                       actual_bytes=moved, actual_s=seconds, outcome=outcome,
                                       extra={"resumed": resumed, "dropped": dropped, "fence": token})
            return {"ok": outcome == "resumed_local", "outcome": outcome, "fence_token": token, "model": model,
                    "resumed": resumed}

        return self._on_loop(go)

    def _find_live_request(self, fut):
        """The engine's Request of ``fut``, once it is admitted."""
        seq = next((sid for sid, f in list(self._futures.items()) if f is fut), None)
        if seq is None:
            return None
        eng = self.engine
        return next((r for r in list(eng._slots) + list(eng._waiting) if r is not None and r.seq_id == seq), None)

    def claim_view(self, claim_id: str, wait_s: float = 0.0, have: int = -1) -> Dict[str, Any]:
        """GET /v1/parked/claims/{id}: the destination's view of one stream
        migrated in, long-polled: waits up to ``wait_s`` until it finishes
        or holds more than ``have`` tokens a stop sequence can no longer
        strip (the engine's own hold-back rule), so the source's proxy
        never streams what the engine would have held back."""
        from . import parked as parked_mod
        from .engine import _stop_holdback

        rec = self._imported_claims.get(claim_id)
        if rec is None:
            raise ValueError(f"unknown claim {claim_id!r}")
        deadline = time.monotonic() + max(0.0, min(float(wait_s), 30.0))
        while True:
            fut = rec["fut"]
            if fut.done():
                try:
                    req = fut.result()
                except Exception as e:  # noqa: BLE001 — the proxy reports it
                    return {"done": True, "error": f"{type(e).__name__}: {e}"}
                return {"done": True, "request": parked_mod.encode_request(req), "finish_reason": req.finish_reason}
            req = rec.get("req")
            if req is None:
                # a queued submission: a Request exists once it is admitted
                req = rec["req"] = self._find_live_request(fut)
            toks: List[int] = []
            if req is not None:
                out = list(req.out_tokens)
                hold = _stop_holdback(out, req.stop_seqs)
                toks = out[: len(out) - hold] if hold else out
            if len(toks) > have or time.monotonic() >= deadline:
                return {"done": False, "tokens": [int(t) for t in toks]}
            time.sleep(0.02)

    def abort_claim(self, claim_id: str) -> Dict[str, Any]:
        """DELETE /v1/parked/claims/{id}: the source's client left: stop
        generating for the stream here too, through the usual abort (this
        side counts its own one client abort)."""
        rec = self._imported_claims.pop(claim_id, None)
        if rec is None:
            raise ValueError(f"unknown claim {claim_id!r}")
        fut = rec["fut"]
        aborted = not fut.done()
        if aborted:
            self.abort(fut)
        return {"ok": True, "claim_id": claim_id, "aborted": aborted}

    @staticmethod
    def _pending_proxy_req(kw: Dict[str, Any]):
        """A host Request standing in for a queued submission handed away:
        the watcher streams into it and resolves the original future with
        it, as the serving loop would have."""
        from .engine import Request

        req = Request(seq_id=-1, prompt=list(kw["prompt"]), max_new_tokens=int(kw.get("max_new_tokens", 16)),
                      temperature=float(kw.get("temperature", 0.0)))
        req.top_p = float(kw.get("top_p", 1.0))
        req.stop_seqs = tuple(tuple(int(t) for t in s) for s in kw.get("stop_seqs") or ())
        req.seed = kw.get("seed")
        req.ignore_eos = bool(kw.get("ignore_eos", False))
        req.want_top_logprobs = bool(kw.get("want_top_logprobs", False))
        req.on_token = kw.get("on_token")
        req.submit_time = kw.get("submit_time", req.submit_time)
        return req

    def _claim_fetch(self, dest: str, claim_id: str, have: int, wait_s: float) -> Dict[str, Any]:
        """One claim view from the destination engine over HTTP (a seam:
        tests put an in-process call here)."""
        import urllib.request

        url = f"{dest.rstrip('/')}/v1/parked/claims/{claim_id}?have={int(have)}&wait_s={wait_s:g}"
        with urllib.request.urlopen(url, timeout=wait_s + 10.0) as resp:
            return json.loads(resp.read().decode())

    def _claim_abort(self, dest: str, claim_id: str) -> None:
        """Tell the destination a stream's client left (DELETE its claim; a
        seam like :meth:`_claim_fetch`)."""
        import urllib.request

        url = f"{dest.rstrip('/')}/v1/parked/claims/{claim_id}"
        urllib.request.urlopen(urllib.request.Request(url, method="DELETE"), timeout=10.0).close()

    def _abort_claims_async(self, dest: str, claim_ids: List[str]) -> None:
        """Claim aborts off the caller's thread, best effort: a destination
        that is gone then only decodes a dead stream to its end."""
        if not dest or not claim_ids:
            return

        def run() -> None:
            for cid in claim_ids:
                try:
                    self._claim_abort(dest, cid)
                except Exception:  # noqa: BLE001 — best effort
                    pass

        threading.Thread(target=run, name="migrate-claim-abort", daemon=True).start()

    def _start_claim_watcher(self, dest: str, claim_id: str, req, fut) -> None:
        # registered before the thread starts: a client leaving meanwhile
        # finds the proxy in abort()
        self._proxied[id(fut)] = {"dest": dest, "claim": claim_id}
        threading.Thread(target=self._watch_claim, args=(dest, claim_id, req, fut),
                         name=f"migrate-claim-{claim_id[:8]}", daemon=True).start()

    @staticmethod
    def _proxy_stream(req, done: bool) -> None:
        """Deliver the proxied tokens through the original hook, as the
        engine does: ``req.done`` is True on the last one only (the SSE
        writer ends on it); the claim's tokens are safe already."""
        if req.on_token is None:
            req.streamed = len(req.out_tokens)
            req.done = done
            return
        tail = req.out_tokens[req.streamed:]
        try:
            for i, t in enumerate(tail):
                req.done = done and i == len(tail) - 1
                req.on_token(req, t)
                req.streamed += 1
        finally:
            req.done = done

    def _watch_claim(self, dest: str, claim_id: str, req, fut) -> None:
        """The source's proxy of one stream handed away: poll the
        destination's claim, forward the new tokens through the original
        hook, and resolve the original future with the finished request. A
        destination that aborts the stream, or stays unreachable for a
        minute, ends it with ``state_loss``, never a silent hang."""
        from . import parked as parked_mod

        try:
            backoff, first_fail = 0.1, None
            while not self._stop.is_set():
                if fut.done():
                    return  # the client left; abort() counted it
                try:
                    view = self._claim_fetch(dest, claim_id, len(req.out_tokens), 5.0)
                except Exception as e:  # noqa: BLE001 — retried, then state_loss
                    now = time.monotonic()
                    first_fail = first_fail or now
                    if now - first_fail > 60.0:
                        if not fut.done():
                            fut.set_exception(RuntimeError(f"migrated stream lost: destination unreachable ({e})"))
                            self._count_abort("state_loss")
                        return
                    time.sleep(backoff)
                    backoff = min(2.0, backoff * 2)
                    continue
                first_fail, backoff = None, 0.1
                if view.get("done"):
                    if view.get("error"):
                        if not fut.done():
                            fut.set_exception(RuntimeError(f"migrated stream aborted on the destination: "
                                                           f"{view['error']}"))
                            self._count_abort("state_loss")
                        return
                    final = parked_mod.decode_request(view["request"], type(req))
                    for k in ("out_tokens", "out_logprobs", "out_top_logprobs", "prompt_logprobs", "pos",
                              "cached_tokens", "stop_requested"):
                        setattr(req, k, getattr(final, k))
                    req.finish_reason = view.get("finish_reason", "")
                    req.done_time = time.monotonic()
                    self._proxy_stream(req, done=True)
                    if not fut.done():
                        fut.set_result(req)
                    return
                toks = view.get("tokens") or []
                if len(toks) > len(req.out_tokens):
                    req.out_tokens = [int(t) for t in toks]
                    self._proxy_stream(req, done=False)
        finally:
            self._proxied.pop(id(fut), None)

    # -- model hot-swap ----------------------------------------------------------

    # -- co-resident sibling variants (/v1/residents) ---------------------------

    def _resident_id(self, model: str, checkpoint_dir: str = "") -> str:
        """A resident's routing identity: the pool key ``model@checkpoint``
        when a checkpoint qualifies it, else the model name (what a
        completion's ``model`` names)."""
        return f"{model}@{checkpoint_dir}" if checkpoint_dir else model

    def _base_resident_id(self) -> str:
        """The serving base's identity in the same namespace (variant 0)."""
        return self._resident_id(self.model)

    @staticmethod
    def _no_checkpoint_dir(checkpoint_dir: str) -> None:
        if checkpoint_dir:
            raise ValueError("checkpoint_dir (an Orbax checkpoint) is not ported (ROADMAP queue 1 item 2); "
                             "name an hf: directory")

    def _resident_source(self, model: str) -> Tuple[Optional[Dict[str, str]], str]:
        """A candidate's flat digest map, read without taking anything from
        the tiers: ``(digests, tier)``, the tier ``pool`` (a slept pooled
        runtime), ``prefetched`` (a prefetch's staged weights) or ``disk``
        (an evicted model's manifest, whose chunks the tiers may serve), or
        ``(None, "cold")``: an attach never reads a checkpoint."""
        entry = self.model_pool.peek_match(model)
        if entry is not None:
            rt = entry.runtime
            digests = self._digests(rt) if isinstance(rt, _ModelRuntime) else rt.digests
            if digests:
                return dict(digests), "prefetched" if isinstance(rt, PrefetchedWeights) else "pool"
        got = self.model_pool.staged_manifest_match(model)
        if got is not None and got[1]:
            return got[1], "disk"
        return None, "cold"

    def _variant_delta_keys(self, digests: Dict[str, str]) -> Tuple[List[str], int, int]:
        """The digest diff of a candidate against the serving base:
        ``(delta_keys, delta_bytes, shared_bytes)``, the bytes those of the
        base's own leaves (an attach holds each delta leaf to the base
        leaf's shape and type, so the figure is exact). A key only one side
        has is a structural mismatch: not a sibling."""
        base = self._digests(self._runtime)
        if not base:
            raise ValueError("the serving model carries no content digests (random weights, or "
                             "--content-hash off): co-residency needs the digest diff")
        drift = set(base).symmetric_difference(digests)
        if drift:
            raise ValueError(f"variant is not a sibling of {self.model}: {len(drift)} weight keys differ "
                             f"structurally (e.g. {sorted(drift)[:4]})")
        delta_keys: List[str] = []
        delta_bytes = shared_bytes = 0
        for k, d in digests.items():
            t = self.engine._base_leaf(k)
            n = t.numel() * t.element_size()
            if base.get(k) != d:
                delta_keys.append(k)
                delta_bytes += n
            else:
                shared_bytes += n
        return delta_keys, delta_bytes, shared_bytes

    def price_attach(self, model: str, checkpoint_dir: str = "") -> Dict[str, Any]:
        """The price of a co-resident attach before a byte moves: the
        delta's bytes from the digest diff and its seconds at the
        ``coresident.h2d`` bandwidth (the host-to-card family's before its
        first measurement). Reads only."""
        self._no_checkpoint_dir(checkpoint_dir)
        digests, tier = self._resident_source(model)
        rid = self._resident_id(model, checkpoint_dir)
        out: Dict[str, Any] = {"kind": "attach", "model": rid, "checkpoint_dir": checkpoint_dir,
                               "tier": "coresident", "source_tier": tier}
        if rid in self._residents:
            return {**out, "predicted_bytes": 0, "predicted_s": 0.0, "measured": True, "attached": True}
        if digests is None:
            raise ValueError(f"{model!r} is not resolvable from the pool or disk tiers; prefetch it first "
                             "(POST /v1/prefetch) or swap")
        delta_keys, delta_bytes, shared_bytes = self._variant_delta_keys(digests)
        sec, measured = self.costs.bandwidths.seconds_for("coresident.h2d", delta_bytes)
        return {**out, "predicted_bytes": delta_bytes, "predicted_s": round(sec, 6),
                "predicted_delta_leaves": len(delta_keys), "predicted_shared_bytes": shared_bytes,
                "measured": measured}

    def price_detach(self, model: str) -> Dict[str, Any]:
        """A detach moves nothing: the delta's host copy never left the
        tiers."""
        return {"kind": "detach", "model": model, "tier": "coresident", "predicted_bytes": 0,
                "predicted_s": 0.0, "measured": True}

    def residents_view(self) -> Dict[str, Any]:
        """GET /v1/residents: the resident set, its budget and the
        shared-base accounting (what a launcher's ledger carries)."""
        rows = {m: dict(info) for m, info in self._residents.items()}
        return {
            "base": self.model,
            "resident_variants": 1 + len(rows),
            "resident_variants_cap": self._resident_variants_cap,
            "variant_hbm_budget_bytes": self._variant_hbm_budget,
            "variant_hbm_bytes": self.engine.variant_hbm_bytes(),
            "residents": rows,
            "ledger": self.resident_ledger.describe(),
        }

    def attach_resident(self, model: str, checkpoint_dir: str = "") -> Dict[str, Any]:
        """POST /v1/residents: attach ``model`` as a sibling variant of the
        serving base, on the engine thread between steps: only its delta
        leaves go to the card, every other leaf is the base's own tensor,
        and completions naming it are routed to it from then on. Over the
        cap or the budget, or not resolvable from the tiers, it is refused
        with :class:`ResidentRejected` (a 409)."""
        pred = self._priced(lambda: self.price_attach(model, checkpoint_dir))
        with tracing.span("engine.attach_resident", model=model, base=self.model) as sp:
            if pred is not None:
                sp.set(predicted_bytes=pred.get("predicted_bytes"), predicted_s=pred.get("predicted_s"))
            try:
                out = self._on_loop(lambda: self._attach_resident_impl(model, checkpoint_dir, pred))
            except ResidentRejected as e:
                fm.ENGINE_RESIDENT_EVENTS.labels(event="reject").inc()
                self._record_actuation("attach", model, trigger="client", tier="coresident", pred=pred,
                                       actual_bytes=0, actual_s=0.0, outcome="rejected", extra={"reason": str(e)})
                raise
            sp.set(handle=out.get("handle"))
            return out

    def _attach_resident_impl(self, model: str, checkpoint_dir: str,
                              pred: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        if self._resident_variants_cap <= 1:
            raise ValueError("co-residency is off (--resident-variants 1); restart with --resident-variants N "
                             "and --packed-serving on")
        self._no_checkpoint_dir(checkpoint_dir)
        rid = self._resident_id(model, checkpoint_dir)
        if self.sleeper.is_sleeping:
            raise ValueError("engine is sleeping; wake_up before attaching residents")
        if rid == self._base_resident_id():
            raise ValueError(f"{rid!r} is the live base model (variant 0); nothing to attach")
        if rid in self._residents:
            # idempotent: the resident set is declarative state
            return {**self.residents_view(), "model": rid, "handle": self._residents[rid]["handle"],
                    "attached": False}
        if 1 + len(self._residents) >= self._resident_variants_cap:
            raise ResidentRejected(f"resident-set cap reached ({self._resident_variants_cap} including the base); "
                                   "detach a variant or use the swap path")
        digests, tier = self._resident_source(model)
        if digests is None:
            raise ResidentRejected(f"{rid!r} is not resolvable from the pool or disk tiers; prefetch it first "
                                   "(POST /v1/prefetch) or swap")
        delta_keys, delta_bytes, shared_bytes = self._variant_delta_keys(digests)
        if not delta_keys:
            raise ValueError(f"{rid!r} is byte-identical to the live base (empty digest diff); route to the base "
                             "instead")
        used = self.engine.variant_hbm_bytes()
        if self._variant_hbm_budget and used + delta_bytes > self._variant_hbm_budget:
            raise ResidentRejected(f"variant delta ~{delta_bytes >> 20} MiB would exceed --variant-hbm-mib "
                                   f"({self._variant_hbm_budget >> 20} MiB, {used >> 20} MiB in use); detach a "
                                   "variant or use the swap path")
        chunks = self.model_pool.chunks
        delta: Dict[str, Any] = {}
        for k in delta_keys:
            t = chunks.fetch(digests[k]) if chunks is not None else None
            if t is None:
                raise ResidentRejected(f"variant leaf {k!r} is not resolvable from the host/disk tiers (evicted "
                                       f"past the disk budget, or staged quantized); prefetch {rid!r} or use the "
                                       "swap path")
            delta[k] = t
        t0 = time.monotonic()
        handle = self.engine.attach_variant(delta, label=rid)
        dt = time.monotonic() - t0
        wire = sum(t.numel() * t.element_size() for t in delta.values())
        self.costs.observe_transfer("coresident.h2d", wire, dt)
        # shared leaves sized from the base's tensors, summed per digest:
        # two content-equal leaves are two tensors on the card
        shared_map: Dict[str, int] = {}
        for k, d in digests.items():
            if k not in delta:
                t = self.engine._base_leaf(k)
                shared_map[d] = shared_map.get(d, 0) + t.numel() * t.element_size()
        delta_map: Dict[str, int] = {}
        for k, t in delta.items():
            delta_map[digests[k]] = delta_map.get(digests[k], 0) + t.numel() * t.element_size()
        self.resident_ledger.attach(rid, shared=shared_map, deltas=delta_map)
        self._residents[rid] = {
            "handle": handle, "model": model, "checkpoint_dir": checkpoint_dir, "nbytes": wire,
            "delta_leaves": len(delta), "shared_bytes": shared_bytes, "source_tier": tier,
            "attached_at": time.time(),
        }
        self._variant_models[handle] = rid
        self._bump_actuation("attach")
        fm.ENGINE_RESIDENT_EVENTS.labels(event="attach").inc()
        self._observe_residents()
        rec = self._record_actuation(
            "attach", rid, trigger="client", tier="coresident", pred=pred, actual_bytes=wire, actual_s=dt,
            extra={"source_tier": tier, "handle": handle, "delta_leaves": len(delta), "shared_bytes": shared_bytes},
        )
        return {**self.residents_view(), "model": rid, "handle": handle, "attached": True, "wire_bytes": wire,
                "attach_s": round(dt, 6), "source_tier": tier, "costs": rec.as_dict()}

    def detach_resident(self, model: str, checkpoint_dir: str = "") -> Dict[str, Any]:
        """DELETE /v1/residents: drop a variant's delta leaves from the
        card. Moves nothing: the tiers still hold every chunk by content,
        so attaching it again is another delta-only upload. Refused (409)
        while a request of it is live or queued."""
        rid = self._resident_id(model, checkpoint_dir)
        pred = self.price_detach(rid)
        with tracing.span("engine.detach_resident", model=rid) as sp:

            def go():
                info = self._residents.get(rid)
                if info is None:
                    raise ValueError(f"{rid!r} is not an attached resident; attached: {sorted(self._residents)}")
                handle = info["handle"]
                t0 = time.monotonic()
                try:
                    freed = self.engine.detach_variant(handle)
                except ValueError as e:
                    raise ResidentRejected(str(e))
                dt = time.monotonic() - t0
                del self._residents[rid]
                self._variant_models.pop(handle, None)
                self.resident_ledger.detach(rid)
                return handle, freed, dt

            handle, freed, dt = self._on_loop(go)
            self._bump_actuation("detach")
            fm.ENGINE_RESIDENT_EVENTS.labels(event="detach").inc()
            self._observe_residents()
            rec = self._record_actuation("detach", rid, trigger="client", tier="coresident", pred=pred,
                                         actual_bytes=0, actual_s=dt, extra={"handle": handle, "freed_bytes": freed})
            sp.set(freed_bytes=freed)
            return {**self.residents_view(), "model": rid, "detached": True, "freed_bytes": freed,
                    "detach_s": round(dt, 6), "costs": rec.as_dict()}

    def _observe_residents(self) -> None:
        """Mirror the resident set into its gauges."""
        fm.ENGINE_RESIDENT_VARIANTS.set(1 + len(self._residents))
        fm.ENGINE_VARIANT_HBM_BYTES.set(self.engine.variant_hbm_bytes())
        fm.ENGINE_CORESIDENT_SAVED_BYTES.set(self.resident_ledger.bytes_saved())

    def _refuse_with_residents(self, what: str, exc=ValueError) -> None:
        """The reference's detach-first refusal of a verb that would tear
        the base down under its residents."""
        if self._residents:
            raise exc(f"co-resident variants attached ({sorted(self._residents)}); detach them "
                      f"(DELETE /v1/residents) before {what}")

    def resolve_request_model(self, model: Optional[str]) -> int:
        """A completion's ``model`` as a variant handle: the base (none,
        the serving model, 0), an attached resident, or a ValueError (a
        400) that names the live set."""
        if not model or model == self.model or model == self._base_resident_id():
            return 0
        info = self._residents.get(model)
        if info is not None:
            return info["handle"]
        raise ValueError(f"model {model!r} is not resident on this engine (base: {self._base_resident_id()!r}, "
                         f"residents: {sorted(self._residents)}); attach it via POST /v1/residents or swap")

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
            zd = out.get("zero_drain") or {}
            if zd.get("restore_shortfall") or zd.get("fallback"):
                # the swap did not park or resume as priced (a fallback moved
                # the whole pool the price left out; a page-in fell short):
                # recorded unpriced
                pred = None
            rec = self._record_actuation(
                "swap", model, trigger="client", tier=out.get("tier", ""), pred=pred,
                actual_bytes=out.get("bytes_moved", 0), actual_s=out.get("swap_total_s", 0.0),
                extra={"preempted": zd.get("parked", 0), "resumed": zd.get("resumed", 0)} if zd else None,
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
        # every resident's shared leaves are the base's tensors
        self._refuse_with_residents("swapping the base")
        t0 = time.monotonic()
        outgoing = self._runtime
        out_digests = self._digests(outgoing)
        # zero-drain: park the outgoing model's live work instead of aborting
        # it, unless the parked state would overrun the pool budget (it would
        # be evicted, and aborted, at once) or the page-out fails: those take
        # the abort path
        parked, fallback = None, ""
        if self._zero_drain:
            est = self._park_pageout_bytes() + self.sleeper.offload_wire_bytes()
            if est > self.model_pool.budget_bytes:
                fallback = (f"park rejected: ~{est >> 20} MiB parked state exceeds --model-pool-mib "
                            f"({self.model_pool.budget_bytes >> 20} MiB)")
            else:
                parked = self._park_current(park_pending=True)
                if parked is None:
                    fallback = "park failed (kv page-out)"
        if parked is None:
            self._abort_for_swap(previous, model)
        else:
            # rides with the slept runtime into the pool; every failure below
            # resumes it or aborts it (state_loss)
            outgoing.parked = parked
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
                # refused before any transfer: the entry goes back intact,
                # and a park's requests go back to serving
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                self._unpark_current(outgoing)
                raise
            except SwapRolledBack as e:
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                self._unpark_current(outgoing)
                self.degraded = f"hot-swap {previous}->{model} rolled back: {e}"
                raise
            except Exception as e:
                # the rollback failed: the state is partially moved (parked
                # futures are not the engine's: they end here)
                self.failure = f"hot-swap {previous}->{model} failed mid-transfer: {type(e).__name__}: {e}"
                self._abort_parked(outgoing, previous, self.failure)
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
                    self._abort_parked(outgoing, previous, self.failure)
                    self._fail_all(RuntimeError(self.failure))
                    raise RuntimeError(self.failure) from capture_exc
                self._free_pooled(self._pool_park(entry.model_id, rt, entry.nbytes))
                self._unpark_current(outgoing)
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
                    self._abort_parked(outgoing, previous, self.failure)
                    self._fail_all(RuntimeError(self.failure))
                    raise RuntimeError(self.failure) from build_exc
                # the rollback wake rebuilt the pool: the parked requests
                # go back to serving
                self._unpark_current(outgoing)
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
        # an Orbax checkpoint_dir (name@dir), which the port refuses. The
        # parked bundle is host state the pool counts with the weights
        evicted = self._pool_park(previous, outgoing,
                                  outgoing.sleeper.stats.bytes_offloaded + (parked.nbytes if parked else 0))
        self._runtime = rt
        self._free_pooled(evicted)
        # a swap back to a parked runtime pages its KV in and its streams go
        # on mid-decode (a failed page-in ends them with state_loss; the
        # swap commits either way)
        zd_resumed, zd_pagein, zd_pagein_s, zd_dropped, zd_short = self._resume_parked(rt)
        zero_drain = None
        if self._zero_drain:
            # the parked KV is actuation payload: in the byte totals the
            # oracle predicts and the record scores
            pageout = parked.kv_nbytes if parked else 0
            metrics["kv_pageout_bytes"], metrics["kv_pagein_bytes"] = pageout, zd_pagein
            metrics["bytes_out"] += pageout
            metrics["bytes_in"] += zd_pagein
            metrics["bytes_moved"] += pageout + zd_pagein
            metrics["bytes_full"] += pageout + zd_pagein
            zero_drain = {
                "parked": parked.preempted if parked else 0,
                "resumed": zd_resumed,
                "kv_pageout_bytes": pageout,
                "kv_pagein_bytes": zd_pagein,
                "kv_pageout_s": round(parked.pageout_s, 6) if parked else 0.0,
                "kv_pin_s": round(parked.pin_s, 6) if parked else 0.0,
                "kv_pagein_s": round(zd_pagein_s, 6),
                **({"dropped": zd_dropped} if zd_dropped else {}),
                **({"restore_shortfall": True} if zd_short else {}),
                **({"fallback": fallback} if fallback else {}),
            }
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
            **({"zero_drain": zero_drain} if zero_drain is not None else {}),
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
                # the parked requests' KV goes with the evicted entry
                self._abort_parked(rt, victim.model_id, f"preempted requests lost: parked model {victim.model_id} "
                                   "evicted from the pool")
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
            # zero-drain: the outgoing park's page-out, and a parked
            # candidate's page-in, ride the two directions
            park_out = self._park_pageout_bytes()
            park_in = entry.runtime.parked.kv_nbytes if entry.runtime.parked is not None else 0
            out_s, m1 = book.seconds_for("swap.d2h", p["wire_out"] + park_out)
            in_s, m2 = book.seconds_for("swap.h2d", p["wire_in"] + park_in)
            if book.has("swap.total"):
                # the whole verb's effective rate from earlier pool-tier
                # swaps predicts the wall, its fixed overhead included
                predicted_s, m_tot = book.seconds_for("swap.total", p["bytes_moved"] + park_out + park_in)
                m1 = m2 = m_tot
            else:
                # one outgoing bucket runs the two directions in turn
                predicted_s = max(out_s, in_s) if p["buckets_out"] > 1 else out_s + in_s
            return {
                **out, "tier": "pool",
                "predicted_bytes": p["bytes_moved"] + park_out + park_in,
                "predicted_bytes_out": p["wire_out"] + park_out,
                "predicted_bytes_in": p["wire_in"] + park_in,
                "predicted_kv_pageout_bytes": park_out,
                "predicted_kv_pagein_bytes": park_in,
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
        park_out = self._park_pageout_bytes()
        d2h_s, m_out = book.seconds_for("sleep.d2h", offload_wire + park_out)
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
            "predicted_bytes": offload_wire + park_out + params_full + kv_bytes,
            "predicted_bytes_out": offload_wire + park_out,
            "predicted_bytes_in": params_full + kv_bytes,
            "predicted_kv_pageout_bytes": park_out,
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
        # zero-drain: the offload leaves the pool out (the sleeper's peek)
        # and the park pages the live pages out instead
        wire = self.sleeper.offload_wire_bytes()
        park = self._park_pageout_bytes()
        sec, measured = self.costs.bandwidths.seconds_for("sleep.d2h", wire + park)
        return {"kind": "sleep", "model": self.model, "predicted_bytes": wire + park, "predicted_kv_pageout_bytes": park,
                "predicted_s": round(sec, 6), "measured": measured}

    def price_wake(self) -> Dict[str, Any]:
        """The predicted cost of waking the serving model: its host
        payload's copy back for level 1, a checkpoint load for level 2."""
        sl = self.sleeper
        if not sl.is_sleeping:
            return {"kind": "wake", "model": self.model, "predicted_bytes": 0, "predicted_s": 0.0, "measured": True}
        if int(sl.level) == 1:
            wire = sl.stats.bytes_offloaded
            # a parked bundle's KV pages back in with the wake
            park_in = self._runtime.parked.kv_nbytes if self._runtime.parked is not None else 0
            sec, measured = self.costs.bandwidths.seconds_for("wake.h2d", wire + park_in)
            return {"kind": "wake", "model": self.model, "predicted_bytes": wire + park_in,
                    "predicted_kv_pagein_bytes": park_in, "predicted_s": round(sec, 6), "measured": measured}
        est = hf_models.estimate_param_bytes(self.engine.cfg.model)
        h2d_s, m1 = self.costs.bandwidths.seconds_for("coldload.h2d", est)
        read_s, m2 = self.costs.bandwidths.seconds_for("coldload.read", est)
        return {"kind": "wake", "model": self.model, "predicted_bytes": est,
                "predicted_s": round(max(h2d_s, read_s), 6), "measured": bool(m1 and m2)}

    def costs_view(self, extra: "tuple | list" = ()) -> Dict[str, Any]:
        """GET /v1/costs: every candidate actuation priced in one call (the
        serving model, each pooled or prefetched model, each evicted model
        whose chunks the tiers hold, and the ``extra`` names), with the
        bandwidths behind the predictions, and the reference's ``coresident``
        rows (with ``--resident-variants`` above 1): each candidate priced
        as an attach, each resident as a detach."""
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
        coresident: List[Dict[str, Any]] = []
        if self._resident_variants_cap > 1:
            for model in sorted(seen - {self.model}):
                try:
                    coresident.append(self.price_attach(model))
                except Exception as e:  # noqa: BLE001 — one bad row never fails the view
                    coresident.append({"kind": "attach", "model": model, "checkpoint_dir": "",
                                       "error": f"{type(e).__name__}: {e}"})
            for model in sorted(self._residents):
                coresident.append(self.price_detach(model))
        return {
            "model": self.model,
            "is_sleeping": self.sleeper.is_sleeping,
            "quant": self._sleep_quant,
            "content_hash": self._content_hash,
            "bandwidth_gibps": self.costs.bandwidths.describe(),
            "sleep": self._priced_row("sleep", self.price_sleep),
            "wake": self._priced_row("wake", self.price_wake),
            "migrate": self._priced_row("migrate", self.price_migrate),
            "compile": {"mean_compile_s": exec_desc.get("mean_compile_s", 0.0),
                        "compiles_total": exec_desc.get("compiles_total", 0)},
            "candidates": candidates,
            "coresident": coresident,
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
        actual_bytes: int, actual_s: float, outcome: str = "committed", extra: Optional[Dict[str, Any]] = None,
    ):
        """One flight-recorder row per actuation edge, with the prediction
        made before it when there was one; the prediction and its error
        go on the oracle's gauges too."""
        rec = self.costs.record(
            kind=kind, model=model, trigger=trigger, tier=tier, outcome=outcome,
            actual_bytes=actual_bytes, actual_s=actual_s,
            predicted_bytes=None if pred is None else pred.get("predicted_bytes"),
            predicted_s=None if pred is None else pred.get("predicted_s"),
            measured=bool(pred and pred.get("measured")), extra=extra,
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
        ``quant`` (:meth:`_quant_block`); ``migration_legs``, the last
        export's and import's seconds by leg. ``costs``, ``zero_drain``
        and ``migration`` are the reference's. It never waits for the
        digests."""
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
                    # the port's own: packed forwards (one per pass of a
                    # multi-variant step), the steps and chunks run as
                    # multi-variant twins and the decode forwards of those
                    # chunks, and the graphs captured
                    "packed_passes": eng.packed_passes,
                    "variant_steps": eng.variant_steps,
                    "variant_chunks": eng.variant_chunks,
                    "variant_chunk_steps": eng.variant_chunk_steps,
                    "variant_decode_forwards": eng.variant_decode_forwards,
                    "graph_captures": eng.graph_captures,
                },
                "aborted": dict(self._aborted),
                "actuations": dict(self._actuations),
                "uptime_s": round(now - self.started_at, 3),
                "is_sleeping": self.sleeper.is_sleeping,
                "load": load,
                "pool": self.model_pool.describe(),
                # zero-drain: what actuations preempted and how each ended,
                # and the KV bytes parked now (a launcher sums them)
                "zero_drain": {"enabled": self._zero_drain, **self._zd,
                               "parked_kv_bytes": max(0, self._zd_parked_bytes)},
                # live migration, per role, and the fence in flight
                "migration": {**self._mig, "in_flight": self._migration is not None,
                              "imported_claims": len(self._imported_claims)},
                # the port's own: the last export's and import's legs
                "migration_legs": {k: dict(v) for k, v in self._mig_last.items()},
                # the oracle's bandwidths and its accuracy over the last
                # records (a launcher lifts it into ledger.costs)
                "costs": self.costs.summary(),
                "quant": self._quant_block(),
                # the co-resident set and what the shared base saves (a
                # launcher's ledger row)
                **({"residents": {
                    "cap": self._resident_variants_cap,
                    "attached": sorted(self._residents),
                    "variant_hbm_bytes": eng.variant_hbm_bytes(),
                    "variant_hbm_budget_bytes": self._variant_hbm_budget,
                    "saved_bytes": self.resident_ledger.bytes_saved(),
                }} if self._residents or self._resident_variants_cap > 1 else {}),
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
        only the card reports); how many chunk graphs it has captured (a
        wake must not capture again); and this process's peak resident
        host memory (``peak_rss_bytes``: a migration's wire is held
        whole)."""
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
            "peak_rss_bytes": peak_rss_bytes(),
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


def peak_rss_bytes() -> int:
    """This process's peak resident host memory (``getrusage``)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


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
    (to the first slot), prefill (to the first token), decode, and the
    seconds spent parked (``preempt``), carved out of the first three (the
    part before the first token from the queue, then the prefill; the rest
    from the decode), so the legs partition the wall time. The reference's
    ``migrate`` leg is 0 there too."""
    pre = max(0.0, req.preempt_pre_token_s)
    total_pre = max(0.0, req.preempt_s)
    if req.first_sched_time is None:
        queue, prefill, decode = max(0.0, now - req.submit_time), 0.0, 0.0
    else:
        queue = max(0.0, req.first_sched_time - req.submit_time)
        if req.first_token_time is not None:
            prefill = max(0.0, req.first_token_time - req.first_sched_time)
            decode = max(0.0, now - req.first_token_time)
        else:
            prefill, decode = max(0.0, now - req.first_sched_time), 0.0
    take = min(queue, pre)
    queue -= take
    prefill = max(0.0, prefill - (pre - take))
    decode = max(0.0, decode - (total_pre - pre))
    return {"queue": queue, "prefill": prefill, "decode": decode, "preempt": total_pre, "migrate": 0.0}


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


def route(service: EngineService, body: Dict[str, Any]) -> int:
    """The variant a completion's ``model`` routes to (0: the base); an
    unknown name is a 400 that names the live set, so a router never gets
    the wrong weights under the name it sent."""
    model = body.get("model")
    if model is not None and not isinstance(model, str):
        raise BadRequest("model must be a string")
    try:
        return service.resolve_request_model(model)
    except ValueError as e:
        raise BadRequest(str(e))


def completions(service: EngineService, body: Any, trace_ctx: "tracing.SpanContext | None" = None):
    """POST /v1/completions: a response object, or an event generator for
    ``stream``. ``trace_ctx``: the client's ``traceparent``."""
    if not isinstance(body, dict):
        raise BadRequest("request body must be a JSON object")
    gen = parse_generation(service, body, encode_prompt(service, body.get("prompt")))
    gen.kw["variant"] = route(service, body)
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
    gen.kw["variant"] = route(service, body)
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
            t0 = time.monotonic()
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            try:
                return json.loads(raw or b"{}")
            except ValueError:
                raise BadRequest("invalid JSON body")
            finally:
                # the read and the parse, for a migration's import figures
                self._read_s, self._read_bytes = round(time.monotonic() - t0, 6), n

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
                if path == "/v1/parked" or path.startswith("/v1/parked/"):
                    return self._parked(method, path, url.query, body if method == "POST" else None)
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
                    # the base and every attached co-resident: what a
                    # completion's model may name without an actuation
                    data = [{"id": service.model, "object": "model"}]
                    data += [{"id": m, "object": "model", "coresident": True} for m in sorted(service._residents)]
                    return self._send(200, {"object": "list", "data": data})
                if path == "/v1/residents":
                    return self._residents(method, url.query, body if method == "POST" else None)
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

        def _parked(self, method: str, path: str, query: str, body: Any) -> None:
            """The migration routes: 409 for a refusal with nothing
            displaced, 500 for a leg that failed and was recovered, 400 for
            a malformed request or a corrupt wire document."""
            try:
                if method == "POST" and path == "/v1/parked":
                    if not isinstance(body, dict):
                        raise BadRequest("request body must be a JSON object")
                    try:
                        ack = service.import_parked(body)
                    except ValueError as e:  # the wire version, a chunk's digest
                        raise BadRequest(str(e))
                    service._mig_last["import"].update(read_s=self._read_s, wire_bytes=self._read_bytes)
                    return self._send(200, ack)
                if method == "POST" and path in ("/v1/parked/release", "/v1/parked/abort"):
                    token = body.get("fence_token") if isinstance(body, dict) else None
                    if not isinstance(token, str) or not token:
                        raise BadRequest(f"{path.rsplit('/', 1)[1]} requires a 'fence_token' string")
                    if path.endswith("/abort"):
                        return self._send(200, service.abort_migration(token))
                    dest, claims = body.get("dest") or "", body.get("claims") or {}
                    if not isinstance(dest, str) or not isinstance(claims, dict):
                        raise BadRequest("'dest' must be a string and 'claims' an object")
                    return self._send(200, service.release_parked(token, dest=dest, claims=claims))
                if path.startswith("/v1/parked/claims/") and method in ("GET", "DELETE"):
                    cid = unquote(path[len("/v1/parked/claims/"):])
                    try:
                        if method == "DELETE":
                            return self._send(200, service.abort_claim(cid))
                        q = parse_qs(query)
                        try:
                            wait_s, have = float(q.get("wait_s", ["0"])[0]), int(q.get("have", ["-1"])[0])
                        except ValueError:
                            raise BadRequest("wait_s/have must be numeric")
                        return self._send(200, service.claim_view(cid, wait_s=wait_s, have=have))
                    except ValueError as e:  # an unknown claim
                        return self._send(404, {"error": str(e)})
                if method == "GET" and path.startswith("/v1/parked/"):
                    doc = service.export_parked(unquote(path[len("/v1/parked/"):]))
                    t0 = time.monotonic()
                    data = json.dumps(doc).encode()
                    t1 = time.monotonic()
                    self._send_bytes(200, data, "application/json")
                    service._mig_last["export"].update(serialize_s=round(t1 - t0, 6),
                                                       send_s=round(time.monotonic() - t1, 6), wire_bytes=len(data))
                    return None
            except MigrationRejected as e:
                return self._send(409, {"error": str(e)})
            except MigrationFailed as e:
                return self._send(500, {"error": str(e)})
            return self._send(404, {"error": f"no route {method} {path}"})

        def _residents(self, method: str, query: str, body: Any) -> None:
            """The co-resident verbs: a refusal by the cap, the budget, an
            unresolvable sibling or a live request is a 409 (the caller
            takes the swap path), a malformed or impossible one a 400."""
            if method == "GET":
                return self._send(200, service.residents_view())
            if method == "POST":
                if not isinstance(body, dict):
                    raise BadRequest("request body must be a JSON object")
                model, ckpt = body.get("model"), body.get("checkpoint_dir") or ""
                if not isinstance(model, str) or not model:
                    raise BadRequest("residents requires a 'model' string")
            elif method == "DELETE":
                q = parse_qs(query)
                model, ckpt = q.get("model", [""])[0], q.get("checkpoint_dir", [""])[0]
                if not model and int(self.headers.get("Content-Length") or 0):
                    got = self._body()
                    if not isinstance(got, dict):
                        raise BadRequest("request body must be a JSON object")
                    model, ckpt = got.get("model") or "", got.get("checkpoint_dir") or ""
                if not isinstance(model, str) or not model:
                    raise BadRequest("detach requires a 'model' (query or body)")
            else:
                return self._send(404, {"error": f"no route {method} /v1/residents"})
            if not isinstance(ckpt, str):
                raise BadRequest("checkpoint_dir must be a string")
            try:
                if method == "POST":
                    return self._send(200, service.attach_resident(model, ckpt))
                return self._send(200, service.detach_resident(model, ckpt))
            except ResidentRejected as e:
                return self._send(409, {"error": str(e)})
            except ValueError as e:
                raise BadRequest(str(e))

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
