"""Prometheus metrics catalog — parity with the reference's docs/metrics.md.

The port of the JAX package's ``controller/metrics.py``, which builds on
``prometheus_client``; the card's machine has none, so the three kinds
the controllers use are written here by hand, with the same metric names,
help strings, labels and buckets, and the text exposition format 0.0.4
(:func:`exposition`). Reference metric names are kept verbatim (fma_*) so
dashboards/alerts port unchanged; :func:`serve_metrics` exposes them.
"""

from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Sequence, Tuple

#: prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0)

REGISTRY: List["_Metric"] = []


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(names: Sequence[str], values: Sequence[str], extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._lock = threading.Lock()
        REGISTRY.append(self)

    def labels(self, **kw: str):
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
            return child

    def _child(self):
        raise NotImplementedError

    def samples(self) -> List[str]:
        with self._lock:
            children = sorted(self._children.items())
        return [line for key, child in children for line in child._lines(self.name, self.labelnames, key)]


class _Value:
    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def _lines(self, name: str, names, key) -> List[str]:
        return [f"{name}{_labels(names, key)} {_fmt(self.value)}"]


class _CounterValue(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount

    def _lines(self, name: str, names, key) -> List[str]:
        return [f"{name}_total{_labels(names, key)} {_fmt(self.value)}"]


class _GaugeValue(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _HistogramValue:
    def __init__(self, buckets: Sequence[float]) -> None:
        self.bounds = tuple(buckets) + (math.inf,)
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    self.counts[i] += 1
                    break

    def _lines(self, name: str, names, key) -> List[str]:
        out, total = [], 0
        for bound, n in zip(self.bounds, self.counts):
            total += n
            out.append(f"{name}_bucket{_labels(names, key, (('le', _fmt(bound)),))} {_fmt(total)}")
        out.append(f"{name}_count{_labels(names, key)} {_fmt(total)}")
        out.append(f"{name}_sum{_labels(names, key)} {_fmt(self.sum)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = ()) -> None:
        # prometheus_client drops a _total suffix from the family name
        super().__init__(name[: -len("_total")] if name.endswith("_total") else name, documentation, labelnames)

    def _child(self):
        return _CounterValue()


class Gauge(_Metric):
    kind = "gauge"

    def _child(self):
        return _GaugeValue()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, documentation, labelnames)
        self.buckets = tuple(float(b) for b in buckets if not math.isinf(b))

    def _child(self):
        return _HistogramValue(self.buckets)


def exposition() -> str:
    """Every registered metric in the Prometheus text format."""
    lines = []
    for m in REGISTRY:
        # a counter's family is named with its _total, as prometheus_client writes it
        family = m.name + "_total" if m.kind == "counter" else m.name
        lines.append(f"# HELP {family} {m.documentation}")
        lines.append(f"# TYPE {family} {m.kind}")
        lines.extend(m.samples())
    return "\n".join(lines) + "\n"


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


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path.split("?")[0] != "/metrics":
            self.send_error(404)
            return
        body = exposition().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve_metrics(port: int = 8002, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """``GET /metrics`` on a daemon thread; returns the server (its
    ``server_address`` holds the port when ``port`` is 0). The JAX
    package serves its ``/debug`` endpoints on the same port
    (``utils/observability.py``), which waits with the tracing port."""
    server = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=server.serve_forever, name="metrics", daemon=True).start()
    return server
