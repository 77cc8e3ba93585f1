"""The engine's Prometheus metric families.

The port of the catalog at the top of the JAX package's
``engine/server.py``: the same names, help text, labels and buckets, on
the port's hand-written kinds (``utils/prom.py``). ``engine/server.py``
updates them and serves them at ``GET /metrics``. A family whose feature
the port does not have yet is not registered: ``fma_engine_spec_proposed_tokens``
and ``fma_engine_spec_accepted_tokens`` (speculative decoding, ROADMAP
queue 1 item 13).

Every update is host-side (counters the engine keeps, stamps on the
host), so a scrape never reads the device.
"""

from __future__ import annotations

from ..utils.prom import Counter, Gauge, Histogram

#: families left out until their feature is ported, by ROADMAP item
UNPORTED_FAMILIES = {
    "fma_engine_spec_proposed_tokens": 13,
    "fma_engine_spec_accepted_tokens": 13,
}

#: Scheduling pressure: waiting + in-flight requests. The HPA's per-pod
#: scaling signal (deploy/hpa/hpa.yaml); labeled by model because two
#: engine instances can share one process in tests.
ENGINE_QUEUE_DEPTH = Gauge(
    "fma_engine_queue_depth",
    "Requests waiting or in flight in this engine",
    ["model"],
)

# Serving observability (the vLLM-equivalent engine metrics an operator
# expects on the engine's /metrics; the reference serves vLLM's):
ENGINE_TTFT = Histogram(
    "fma_engine_time_to_first_token_seconds",
    "Submit to first emitted token",
    ["model"],
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
)
ENGINE_E2E_LATENCY = Histogram(
    "fma_engine_request_seconds",
    "Submit to request completion",
    ["model"],
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60, 120),
)
ENGINE_PROMPT_TOKENS = Counter(
    "fma_engine_prompt_tokens_total", "Prompt tokens processed", ["model"]
)
ENGINE_GENERATED_TOKENS = Counter(
    "fma_engine_generation_tokens_total", "Tokens generated", ["model"]
)
ENGINE_ABORTS = Counter(
    "fma_engine_aborted_requests_total",
    "Requests aborted, by cause: client (disconnect), swap (actuation "
    "preempted queued/in-flight work), state_loss (level-2 wake)",
    ["model", "reason"],
)
# Zero-drain actuation (engine/parked.py): instead of aborting, --zero-drain
# parks the victim model's live requests (KV pages paged out beside the
# slept weights) and resumes them bit-exact after the wake or the swap back.
# Every preempted request ends one way; the byte counter is the parked KV's.
ENGINE_PREEMPTED = Counter(
    "fma_engine_preempted_requests_total",
    "Requests preempted by a zero-drain actuation, by final outcome "
    "(resumed = re-seated and continued; aborted = parked state lost — "
    "KV restore failure, parked-model eviction, or client disconnect "
    "while parked; migrated = handed off to a sibling instance and "
    "continued there)",
    ["model", "outcome"],
)
ENGINE_KV_PAGEOUT = Counter(
    "fma_engine_kv_pageout_bytes_total",
    "Parked-KV bytes moved by zero-drain preempt/resume, by direction "
    "(d2h = page-out at park, h2d = page-in at resume)",
    ["dir"],
)
# Live request migration: a parked bundle handed to a sibling over the wire
# and resumed mid-decode there. Source outcomes: committed | resumed_local |
# state_loss; destination outcomes: imported | rolled_back.
ENGINE_MIGRATIONS = Counter(
    "fma_engine_migrations_total",
    "Live request migrations, by role (source|destination) and terminal "
    "outcome (committed | resumed_local | state_loss | imported | "
    "rolled_back)",
    ["role", "outcome"],
)
ENGINE_MIGRATE_BYTES = Counter(
    "fma_engine_migrate_bytes_total",
    "Parked-bundle KV bytes moved by live request migration, by "
    "direction (export = serialized to the wire on the source, import = "
    "paged into the destination pool)",
    ["dir"],
)
ENGINE_KV_USAGE = Gauge(
    "fma_engine_kv_cache_usage_ratio",
    "Fraction of KV pages in use",
    ["model"],
)
ENGINE_PREFIX_HIT_TOKENS = Gauge(
    "fma_engine_prefix_cache_hit_tokens",
    "Prompt tokens served from the prefix cache instead of prefill",
    ["model"],
)

# SLO / goodput telemetry (docs/perf.md "Fleet benchmarking and goodput"):
# the request-lifecycle observables the multi-model scheduler (ROADMAP
# item 1) optimizes and the fleet harness (`bench.py fleet`) reports.
# Queue wait separates "sat behind other work / an actuation" from "the
# prefill itself was slow" inside the existing TTFT histogram.
ENGINE_QUEUE_WAIT = Histogram(
    "fma_engine_queue_wait_seconds",
    "Submit to first scheduled (queue time; prefill excluded)",
    ["model"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
)
ENGINE_SLO_REQUESTS = Counter(
    "fma_engine_slo_requests_total",
    "Finished requests judged against a configured SLO target "
    "(--slo-ttft-ms / --slo-tpot-ms; one observation per enabled slo)",
    ["model", "slo", "outcome"],  # slo: ttft|tpot, outcome: met|violated
)
ENGINE_GOODPUT_TOKENS = Counter(
    "fma_engine_goodput_tokens_total",
    "Generated tokens from requests that met every configured SLO "
    "(equals generation_tokens_total when no SLO target is set)",
    ["model"],
)
ENGINE_ARRIVAL_RATE = Gauge(
    "fma_engine_request_arrival_rate",
    "EWMA of request arrivals (requests/s) for the resident model — the "
    "demand signal a multi-model scheduler consumes",
    ["model"],
)

# Model hot-swap observability (docs/engine.md "Model hot-swap"): the swap
# is the actuation hot path, so its latency, how much of it overlapped, and
# the transfer window it held are all first-class operator signals.
ENGINE_SWAP_SECONDS = Histogram(
    "fma_engine_swap_seconds",
    "Model hot-swap wall time (labeled by the incoming model)",
    ["model"],
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60),
)
ENGINE_SWAPS = Counter(
    "fma_engine_swaps_total",
    "Completed model hot-swaps by source of the incoming state",
    ["model", "source"],  # source: pool | cold
)
ENGINE_SWAP_OVERLAP_FRAC = Gauge(
    "fma_engine_swap_overlap_fraction",
    "Fraction of the last swap spent with both DMA directions in flight",
    ["model"],
)
ENGINE_SWAP_INFLIGHT_BYTES = Gauge(
    "fma_engine_swap_peak_bytes_in_flight",
    "Peak transfer bytes in flight during the last swap",
    ["model"],
)
ENGINE_POOL_BYTES = Gauge(
    "fma_engine_model_pool_bytes",
    "Pinned-host bytes held by pooled (slept) models",
)
ENGINE_POOL_MODELS = Gauge(
    "fma_engine_model_pool_models",
    "Models resident in the host model pool",
)
ENGINE_POOL_HITS = Counter(
    "fma_engine_model_pool_hits",
    "Swap-ins served from the host model pool (no checkpoint re-read)",
)
ENGINE_POOL_EVICTIONS = Counter(
    "fma_engine_model_pool_evictions",
    "Pooled models evicted (budget pressure or device release)",
)

# Tiered, content-addressed pool (docs/perf.md "Tiered weight cache and
# delta swap"): per-tier residency, how many host bytes dedup across
# sibling fine-tune variants is saving right now, tier traffic, and how
# much of the last swap crossed the device boundary vs was content-matched
# away.
ENGINE_POOL_TIER_BYTES = Gauge(
    "fma_engine_model_pool_tier_bytes",
    "Bytes resident per model-pool tier (host chunks / disk spill)",
    ["tier"],  # host | disk
)
ENGINE_POOL_TIER_CHUNKS = Gauge(
    "fma_engine_model_pool_tier_chunks",
    "Content-addressed chunks resident per model-pool tier",
    ["tier"],
)
ENGINE_POOL_DEDUP_SAVED = Gauge(
    "fma_engine_model_pool_dedup_saved_bytes",
    "Host bytes saved by content-addressed dedup across pooled models",
)
ENGINE_POOL_TIER_EVENTS = Counter(
    "fma_engine_model_pool_tier_events_total",
    "Chunk-store traffic by event",
    ["event"],  # dedup_hit | host_hit | disk_spill | disk_hit |
    #             disk_eviction | verify_failure | miss
)
ENGINE_SWAP_DELTA_BYTES = Gauge(
    "fma_engine_swap_delta_bytes",
    "Last swap's bytes over the device boundary by kind",
    ["model", "kind"],  # kind: moved | deduped
)

# Compressed actuation (docs/perf.md "Compressed actuation"): cumulative
# wire bytes per transfer mode and direction across every sleep / wake /
# swap edge — the signal for "what is --sleep-quant actually saving".
# A Gauge used as a monotonic accumulator so the exposition name matches
# the documented fma_engine_actuation_bytes{mode,dir} exactly.
ENGINE_ACTUATION_BYTES = Gauge(
    "fma_engine_actuation_bytes",
    "Cumulative actuation transfer bytes by mode and direction",
    ["mode", "dir"],  # mode: off | int8 | fp8; dir: d2h | h2d
)

# Actuation cost oracle + decision flight recorder (docs/operations.md
# "Pricing an actuation"; utils/costs.py): durations next to the byte
# counter above — bytes without seconds can't validate the oracle from
# Prometheus alone — plus the last prediction per kind and how wrong it
# was. The scheduler-brain's cost telemetry (ROADMAP item 1).
ENGINE_ACTUATION_SECONDS = Histogram(
    "fma_engine_actuation_seconds",
    "Actuation wall seconds by kind and phase (phase=d2h/h2d are the "
    "transfer windows; total is the whole verb incl. overlap/commit)",
    ["kind", "phase"],  # kind: swap | sleep | wake; phase: d2h | h2d | total
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60, 120),
)
ENGINE_PREDICTED_BYTES = Gauge(
    "fma_engine_actuation_predicted_bytes",
    "Last actuation's oracle-predicted wire bytes, by kind (compare "
    "against fma_engine_actuation_bytes increments: byte prediction is "
    "deterministic from digests/shapes, so any drift is a bug signal)",
    ["kind"],
)
ENGINE_COST_ERROR = Gauge(
    "fma_engine_cost_prediction_error_ratio",
    "Signed relative error (predicted-actual)/actual of the last "
    "actuation's predicted seconds, by kind — the oracle's live "
    "accuracy score (only set when the prediction used measured "
    "bandwidth)",
    ["kind"],
)

# Self-healing observability (docs/operations.md "Self-healing and fault
# drills"): every recovery edge — a swap failure rolled back in-process, or
# a rollback that itself failed and flipped /health — is counted, so an
# operator can tell "the failure path fired and healed" apart from silence.
ENGINE_RECOVERIES = Counter(
    "fma_engine_recoveries_total",
    "Recovery attempts by path and outcome",
    ["path", "outcome"],  # path: swap | swap_cold; outcome: rolled_back |
    #                       rollback_failed
)

# Cold-start observability (docs/perf.md "Cold-start tuning"): the pipelined
# loader's phase breakdown for the last cold build, and background-prefetch
# outcomes. `phase` is read (disk -> staged host buffers, wall window),
# convert (cumulative casted-copy time inside staging), h2d (first transfer
# issued -> last landed) or total.
ENGINE_COLDLOAD_PHASE_SECONDS = Gauge(
    "fma_engine_coldload_phase_seconds",
    "Last cold weight-load phase timing",
    ["model", "phase"],  # phase: read | convert | h2d | total
)
ENGINE_COLDLOAD_OVERLAP_FRAC = Gauge(
    "fma_engine_coldload_overlap_fraction",
    "Fraction of the last cold load spent with disk read and H2D in flight",
    ["model"],
)
ENGINE_PREFETCHES = Counter(
    "fma_engine_prefetch_total",
    "Background checkpoint prefetches by outcome",
    ["outcome"],  # completed | aborted | failed | rejected
)
ENGINE_PREFETCH_BYTES = Gauge(
    "fma_engine_prefetch_staged_bytes",
    "Host bytes staged by the last completed prefetch",
)

# AOT warmup + executable pool (docs/perf.md "Warmup and the executable
# pool"): first-touch compiles were the tail that wagged TTFT after the
# streaming loaders fixed weight movement — these say whether the compile
# work is riding under transfers (warmup seconds per program) and whether
# rebuilds are reusing executables instead of recompiling (pool traffic).
ENGINE_WARMUP_SECONDS = Gauge(
    "fma_engine_warmup_seconds",
    "AOT warmup compile seconds by program (last warmup)",
    ["program"],
)
ENGINE_EXEC_POOL_HITS = Counter(
    "fma_engine_exec_pool_hits_total",
    "Executable-pool lookups served without compiling",
)
ENGINE_EXEC_POOL_MISSES = Counter(
    "fma_engine_exec_pool_misses_total",
    "Executable-pool lookups that had to compile",
)
ENGINE_EXEC_POOL_EVICTIONS = Counter(
    "fma_engine_exec_pool_evictions_total",
    "Executables evicted from the pool (budget pressure or device release)",
)
ENGINE_EXEC_POOL_BYTES = Gauge(
    "fma_engine_exec_pool_bytes",
    "Estimated host bytes held by pooled executables",
)
ENGINE_EXEC_POOL_ENTRIES = Gauge(
    "fma_engine_exec_pool_entries",
    "Executables resident in the pool",
)

# Mixed-batch (token-packed) serving observability (docs/metrics.md): how
# full the decode batch runs, how densely the packed buffer is used, and
# how much activation padding each dispatch path burns — the occupancy/
# queue signals the multi-model scheduler (ROADMAP item 1) consumes.
ENGINE_SLOT_OCCUPANCY = Gauge(
    "fma_engine_decode_slot_occupancy",
    "Fraction of decode slots occupied by running requests",
    ["model"],
)
ENGINE_PACKED_TOKENS = Histogram(
    "fma_engine_packed_tokens_per_step",
    "Valid (non-padding) tokens packed into each mixed-batch step",
    ["model"],
    buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
ENGINE_PAD_WASTE_BYTES = Counter(
    "fma_engine_prefill_pad_waste_bytes_total",
    "Activation bytes computed for padding tokens, by dispatch path "
    "(bucketed = power-of-two prefill bucket padding; packed = invalid "
    "rows of the mixed [token_budget] buffer)",
    ["model", "path"],
)
ENGINE_STEP_H2D_BYTES = Counter(
    "fma_engine_step_h2d_bytes_total",
    "Host->device scheduler/dispatch bytes moved by engine steps, by "
    "serving path (packed = mixed-program row inputs + a packed "
    "engine's scheduler uploads, which are O(rows) per step at steady "
    "state — the [max_batch, vocab] mirrors re-upload only on dirty "
    "edges; bucketed = prefill/suffix/spec dispatch inputs + a "
    "bucketed engine's scheduler uploads)",
    ["model", "path"],
)

# Co-resident sibling variants: one shared base tensor set on the card plus
# per-variant deltas, routed per request inside the packed step (sibling
# traffic then actuates with zero swaps). The gauges expose the
# --variant-hbm-mib budget's accounting and what the shared base saves.
ENGINE_RESIDENT_VARIANTS = Gauge(
    "fma_engine_resident_variants",
    "Device-resident model variants (the base model counts as 1)",
)
ENGINE_VARIANT_HBM_BYTES = Gauge(
    "fma_engine_variant_hbm_bytes",
    "Device bytes held by co-resident variant deltas (the "
    "--variant-hbm-mib budget's numerator)",
)
ENGINE_CORESIDENT_SAVED_BYTES = Gauge(
    "fma_engine_coresident_saved_bytes",
    "Device bytes the shared base is saving vs full per-variant "
    "copies (sum over residents of base bytes minus their delta)",
)
ENGINE_RESIDENT_EVENTS = Counter(
    "fma_engine_resident_events_total",
    "Resident-set changes by event",
    ["event"],  # attach | detach | reject
)
ENGINE_ROUTED_REQUESTS = Counter(
    "fma_engine_routed_requests_total",
    "Requests routed per-request to a co-resident variant (label = the "
    "variant model; base-model requests are not counted here)",
    ["model"],
)
