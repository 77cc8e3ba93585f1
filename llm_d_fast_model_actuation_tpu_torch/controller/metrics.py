"""Prometheus metrics catalog — parity with the reference's docs/metrics.md.

The port of the JAX package's ``controller/metrics.py``, which builds on
``prometheus_client``; the card's machine has none, so the kinds come
from the port's own ``utils/prom.py`` (the same metric names, help
strings, labels and buckets, and the text exposition format 0.0.4).
Reference metric names are kept verbatim (fma_*) so dashboards/alerts
port unchanged; :func:`serve_metrics` exposes them with the ``/debug``
handlers beside them (``utils/observability.py``).
"""

from __future__ import annotations

from ..utils.observability import serve_observability
from ..utils.prom import (  # noqa: F401 — the kinds and the registry, importable from here as before
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    exposition,
)

# Actuation latency with path classification (controller.go:265-271):
# hot  = provider existed with the instance awake,
# warm = instance existed asleep (wake path),
# cold = launcher or instance had to be created.
ACTUATION_SECONDS = Histogram(
    "fma_actuation_seconds",
    "Time from requester creation to first readiness relay",
    ["path", "instancesDeleted", "isc_name"],
    buckets=(0, 1, 3, 5, 7.5, 10, 15, 30, 60, 120, 240, 480, 960, 1920),
)

LAUNCHER_CREATE_SECONDS = Histogram(
    "fma_launcher_create_seconds",
    "Latency of creating a launcher Pod",
    ["lcfg_name"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2, 5),
)

HTTP_LATENCY = Histogram(
    "fma_http_latency_seconds",
    "Latency of controller-originated HTTP calls",
    ["purpose", "method"],
)

DUALITY = Gauge(
    "fma_duality",
    "1 while a requester/provider pair is bound (join with per-chip metrics)",
    ["isc_name", "chip", "node"],
)

REQUESTER_COUNT = Gauge(
    "fma_requester_count",
    "Number of server-requesting Pods per InferenceServerConfig",
    ["isc_name"],
)

ISC_COUNT = Gauge(
    "fma_isc_count",
    "Number of InferenceServerConfigs per LauncherConfig",
    ["launcher_config_name"],
)

LAUNCHER_POD_COUNT = Gauge(
    "fma_launcher_pod_count",
    "Launcher Pods by lifecycle phase",
    ["lcfg_name", "phase"],
)

INNER_QUEUE_DEPTH = Gauge(
    "fma_dpc_innerqueue_depth",
    "Depth of the per-node serialized work queue",
    ["node"],
)

INNER_QUEUE_ADDS = Counter(
    "fma_dpc_innerqueue_adds_total",
    "Items added to the per-node work queue",
    ["node"],
)

INNER_QUEUE_RETRIES = Counter(
    "fma_dpc_innerqueue_retries_total",
    "Per-node queue item retries",
    ["node"],
)

WORK_DURATION = Histogram(
    "fma_dpc_innerqueue_work_duration_seconds",
    "Per-item processing time in the per-node queue",
    ["node"],
)

QUEUE_DURATION = Histogram(
    "fma_dpc_innerqueue_queue_duration_seconds",
    "Time an item waits in the per-node queue before processing",
    ["node"],
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
)


def serve_metrics(port: int = 8002, host: str = "0.0.0.0"):
    """``GET /metrics``, ``/debug/stacks``, ``/debug/vars`` and
    ``/debug/traces`` on a daemon thread (``utils/observability.py``), as
    the JAX package serves them on the observability port; returns the
    server (its ``server_address`` holds the port when ``port`` is 0)."""
    return serve_observability(port, host)
