"""End-to-end actuation tracing: propagated spans across the control plane.

The port's own copy of the JAX package's ``utils/tracing.py``, whole: the
two share no import, and a trace may cross them. The wire format (W3C
``traceparent``) and the export format (Chrome trace events with
``args.trace_id/span_id/parent_id``) are byte for byte the JAX module's.

An actuation's latency envelope says how long one actuation took, not
*which hop* (SPI call, launcher RPC, child spawn, D2H/H2D copy, rollback)
took the time. This module turns it into attributable timelines:

  * **Spans**: trace_id / span_id / parent, name, attrs, monotonic
    start/end, recorded into a bounded per-process ring buffer (old spans
    fall off the back).
  * **Propagation**: ``traceparent`` headers through the instrumented HTTP
    paths (controller ``clients.py``, the launcher's ``_engine_request``,
    the engine's admin handlers) and ``FMA_TRACEPARENT`` into engine
    children (the launcher's fork server passes it to the child body,
    which sets it after :func:`reset_after_fork`), so one actuation
    (requester, controller bind, launcher spawn or wake, the engine's
    copies) is a single trace across processes.
  * **Export**: Chrome trace-event JSON (loads in Perfetto and
    chrome://tracing; timestamps anchored to the wall clock, so exports of
    several processes concatenate into one timeline) and a text ``tree``.
    Served by the engine's ``GET /v1/traces``, the launcher's
    ``/v2/vllm/traces`` and the controller observability port's
    ``/debug/traces``.

Overhead: tracing is ON by default (a span is two monotonic reads, one
small object and a bounded deque append); ``FMA_TRACING=off`` (or
:func:`disable`) turns every entry point into a shared no-op. Hot loops
(the bucket loops of ``engine/sleep.py`` and ``models/hf.py``) hoist
:func:`enabled` once and create no span object when it is off.

Spans are not OpenTelemetry objects: the subset here (sync spans, explicit
parents for worker threads, context managers) is what the actuation paths
need, with no dependency.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: env toggles: FMA_TRACING=off|0|false disables at import; FMA_TRACE_BUFFER
#: overrides the ring capacity (spans retained per process).
ENV_VAR = "FMA_TRACING"
BUFFER_ENV_VAR = "FMA_TRACE_BUFFER"
#: the cross-fork propagation channel: the launcher stamps the current
#: traceparent here around the child fork; the engine service adopts it as
#: the parent of its startup span.
TRACEPARENT_ENV = "FMA_TRACEPARENT"

DEFAULT_BUFFER_SPANS = 4096

#: wall-clock anchor: spans carry monotonic times (immune to clock steps);
#: export maps them onto the epoch so per-process exports line up on one
#: Perfetto timeline.
_ANCHOR_WALL = time.time()
_ANCHOR_MONO = time.monotonic()


def _wall(mono_s: float) -> float:
    return _ANCHOR_WALL + (mono_s - _ANCHOR_MONO)


@dataclass
class SpanContext:
    """The propagatable identity of a span: what a child (local, HTTP, or
    forked-process) parents itself on."""

    trace_id: str
    span_id: str


@dataclass
class Span:
    """One finished (or in-flight) span. ``start_s``/``end_s`` are
    monotonic; attrs are small JSON-able scalars (bytes, bucket index,
    model name...)."""

    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start_s: float
    end_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    pid: int = 0
    thread: str = ""

    @property
    def duration_s(self) -> float:
        return max(0.0, (self.end_s or self.start_s) - self.start_s)


class TraceBuffer:
    """Thread-safe bounded ring of finished spans (per process)."""

    def __init__(self, capacity: int = DEFAULT_BUFFER_SPANS) -> None:
        self._buf: deque = deque(maxlen=max(1, capacity))
        self._mu = threading.Lock()

    def add(self, span: Span) -> None:
        with self._mu:
            self._buf.append(span)

    def snapshot(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._mu:
            spans = list(self._buf)
        if trace_id:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans

    def drain(self, trace_id: Optional[str] = None) -> List[Span]:
        """Atomic snapshot-and-remove: a span recorded between the two
        would otherwise be dropped unexported. With ``trace_id`` only
        that trace's spans are removed — other traces stay for their own
        later export."""
        with self._mu:
            spans = list(self._buf)
            self._buf.clear()
            if trace_id is None:
                return spans
            self._buf.extend(s for s in spans if s.trace_id != trace_id)
            return [s for s in spans if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._buf)


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").lower() not in ("off", "0", "false")


def _env_capacity() -> int:
    try:
        return int(os.environ.get(BUFFER_ENV_VAR, "") or DEFAULT_BUFFER_SPANS)
    except ValueError:
        return DEFAULT_BUFFER_SPANS


_BUFFER = TraceBuffer(_env_capacity())
_enabled = _env_enabled()
_current: "contextvars.ContextVar[Optional[SpanContext]]" = (
    contextvars.ContextVar("fma_trace_ctx", default=None)
)


def enabled() -> bool:
    """Hot-loop guard: hoist this once per loop; when False, skip
    :func:`begin` entirely (no span objects, no attr dicts)."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset_after_fork() -> None:
    """Forked-child hygiene (the launcher's process model): the fork
    duplicates the parent's ring buffers — drop the copies so the child's
    export is its own spans only, and re-read the env so per-instance
    env_vars (FMA_TRACING / FMA_TRACE_BUFFER) win over inherited state.
    Request sampling resets to 0 (off): the child re-applies its own
    ``--trace-requests`` during engine construction."""
    global _BUFFER, _enabled, _REQ_BUFFER, _req_frac
    _BUFFER = TraceBuffer(_env_capacity())
    _REQ_BUFFER = TraceBuffer(_req_env_capacity())
    _req_frac = 0.0
    _enabled = _env_enabled()
    _current.set(None)


# -- ids / W3C traceparent ----------------------------------------------------


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(ctx: SpanContext) -> str:
    """W3C trace-context header value: 00-<trace>-<span>-01."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a ``traceparent`` header / env value; None on anything
    malformed (a bad header must never break the request that carried
    it)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


def current_context() -> Optional[SpanContext]:
    return _current.get()


def current_traceparent() -> Optional[str]:
    ctx = _current.get()
    return format_traceparent(ctx) if ctx is not None else None


def context_from_headers(headers: Any) -> Optional[SpanContext]:
    """Adopt a remote parent from request headers (any mapping with a
    ``.get``; the port's servers keep header names in lower case)."""
    try:
        return parse_traceparent(
            headers.get("traceparent") or headers.get("Traceparent")
        )
    except Exception:  # noqa: BLE001 — odd header containers
        return None


def env_context() -> Optional[SpanContext]:
    """The cross-fork parent, if the spawning process stamped one."""
    return parse_traceparent(os.environ.get(TRACEPARENT_ENV, ""))


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Run a block with ``ctx`` as the current span context (no-op when
    ctx is None) — the executor-thread adoption helper: HTTP handlers
    parse the remote parent on the event loop and re-establish it inside
    the worker running the blocking admin call."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


# -- spans --------------------------------------------------------------------


class _NoopSpan:
    """The disabled-path singleton: every operation is a no-op, nothing
    allocates per call site."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    ended = True

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def end(self) -> None:
        return None

    def traceparent(self) -> Optional[str]:
        return None

    def context(self) -> Optional[SpanContext]:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class SpanHandle:
    """A live span. Usable as a context manager (``with span("x"): ...``)
    or with explicit ``end()`` for pipelined/overlapping lifetimes (the
    swap bucket loop issues several at once with ``activate=False``)."""

    __slots__ = ("_span", "_token", "_activated")

    def __init__(self, span: Span, token, activated: bool) -> None:
        self._span = span
        self._token = token
        self._activated = activated

    @property
    def trace_id(self) -> str:
        return self._span.trace_id

    @property
    def span_id(self) -> str:
        return self._span.span_id

    @property
    def ended(self) -> bool:
        return bool(self._span.end_s)

    def context(self) -> SpanContext:
        return SpanContext(self._span.trace_id, self._span.span_id)

    def traceparent(self) -> str:
        return format_traceparent(self.context())

    def set(self, **attrs: Any) -> "SpanHandle":
        self._span.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._span.end_s:
            return  # idempotent
        self._span.end_s = time.monotonic()
        if self._activated and self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # ended on a different thread/context than it began on
                # (pipelined handles): the ContextVar was never theirs
                pass
            self._token = None
        _BUFFER.add(self._span)

    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and "error" not in self._span.attrs:
            self._span.attrs["error"] = f"{type(exc).__name__}: {exc}"
        self.end()
        return False


def begin(
    name: str,
    parent: Optional[SpanContext] = None,
    activate: bool = True,
    **attrs: Any,
):
    """Start a span. ``parent`` overrides the ambient context (worker
    threads pass the captured parent explicitly — ContextVars do not cross
    thread starts); with ``activate=False`` the span does NOT become the
    current context, which is what overlapping (pipelined) spans in one
    thread need to avoid misparenting each other."""
    if not _enabled:
        return NOOP_SPAN
    ctx = parent if parent is not None else _current.get()
    span = Span(
        trace_id=ctx.trace_id if ctx else _new_trace_id(),
        span_id=_new_span_id(),
        parent_id=ctx.span_id if ctx else "",
        name=name,
        start_s=time.monotonic(),
        attrs=dict(attrs) if attrs else {},
        pid=os.getpid(),
        thread=threading.current_thread().name,
    )
    token = None
    if activate:
        token = _current.set(SpanContext(span.trace_id, span.span_id))
    return SpanHandle(span, token, activate)


def span(
    name: str, parent: Optional[SpanContext] = None, **attrs: Any
):
    """``with tracing.span("engine.swap", model=m): ...`` — begin +
    activate, ended (and attrs stamped with any exception) on exit."""
    return begin(name, parent=parent, activate=True, **attrs)


def snapshot(trace_id: Optional[str] = None) -> List[Span]:
    return _BUFFER.snapshot(trace_id=trace_id)


def clear() -> None:
    _BUFFER.clear()


def buffer_len() -> int:
    return len(_BUFFER)


# -- request-scoped tracing ---------------------------------------------------
#
# The ``request.*`` span family: one trace per served
# request, spans recorded retrospectively at lifecycle edges (explicit
# start/end monotonic times — no open handles crossing threads, no
# per-decode-step span flood). Retained spans land in a DEDICATED ring,
# separate from the actuation ring above, so decode traffic can never
# evict swap forensics (and vice versa). Retention is head sampling
# (``--trace-requests <frac>``) plus tail-keep: SLO-violated, aborted,
# and migrated requests always keep their spans.

#: ring capacity override for the request-span ring (spans per process).
REQ_BUFFER_ENV_VAR = "FMA_REQ_TRACE_BUFFER"
DEFAULT_REQ_BUFFER_SPANS = 8192


def _req_env_capacity() -> int:
    try:
        return int(
            os.environ.get(REQ_BUFFER_ENV_VAR, "")
            or DEFAULT_REQ_BUFFER_SPANS
        )
    except ValueError:
        return DEFAULT_REQ_BUFFER_SPANS


_REQ_BUFFER = TraceBuffer(_req_env_capacity())
_req_frac = 0.0


def configure_request_sampling(frac: float) -> None:
    """Set the head-sampling fraction for request traces
    (``--trace-requests``). 0 — the default — keeps the serving hot path
    byte-inert: no RequestTrace objects are created and every hook
    reduces to one ``is None`` check."""
    global _req_frac
    try:
        _req_frac = min(1.0, max(0.0, float(frac)))
    except (TypeError, ValueError):
        _req_frac = 0.0


def request_sampling() -> float:
    return _req_frac


def sample_request() -> bool:
    """One head-sampling draw, decided at request creation. The draw is
    carried on the RequestTrace (``sampled``) so tail-keep can overrule
    a negative draw at completion — not the other way around."""
    return _enabled and _req_frac > 0.0 and random.random() < _req_frac


class RequestTrace:
    """Per-request span collector.

    Spans accumulate privately on the instance (appends are GIL-atomic;
    the engine's step discipline serializes real mutators anyway) and
    nothing touches any ring until :meth:`finish` decides retention:
    head-sampled requests keep their spans, everyone else's are dropped
    at completion unless tail-keep (SLO violation / abort / migration)
    overrules. The lifecycle root's span_id is allocated up front so
    child spans — including spans recorded by ANOTHER process after a
    migration, via :meth:`context` serialized into the parked bundle —
    parent on it before it is finished."""

    __slots__ = ("trace_id", "root_id", "parent_id", "sampled", "spans",
                 "_done")

    def __init__(
        self,
        sampled: bool = False,
        parent: Optional[SpanContext] = None,
    ) -> None:
        self.trace_id = parent.trace_id if parent else _new_trace_id()
        self.parent_id = parent.span_id if parent else ""
        self.root_id = _new_span_id()
        self.sampled = bool(sampled)
        self.spans: List[Span] = []
        self._done = False

    def context(self) -> SpanContext:
        """What a child recorded elsewhere (another thread, or another
        process across the migration wire) parents on: the lifecycle
        root."""
        return SpanContext(self.trace_id, self.root_id)

    def traceparent(self) -> str:
        return format_traceparent(self.context())

    def add(
        self,
        name: str,
        start_s: float,
        end_s: float,
        parent_id: Optional[str] = None,
        **attrs: Any,
    ) -> str:
        """Record one retrospective child span from explicit monotonic
        times; returns its span_id (for grandchildren)."""
        span = Span(
            trace_id=self.trace_id,
            span_id=_new_span_id(),
            parent_id=self.root_id if parent_id is None else parent_id,
            name=name,
            start_s=float(start_s),
            end_s=float(end_s),
            attrs=dict(attrs) if attrs else {},
            pid=os.getpid(),
            thread=threading.current_thread().name,
        )
        self.spans.append(span)
        return span.span_id

    def finish(
        self,
        start_s: float,
        end_s: float,
        keep: bool,
        name: str = "request.lifecycle",
        **attrs: Any,
    ) -> str:
        """Build the ``request.lifecycle`` root over [start_s, end_s] and,
        iff ``keep``, flush root + children to the request ring. Always
        returns the trace_id; idempotent (a double finish flushes
        nothing twice)."""
        if self._done:
            return self.trace_id
        self._done = True
        if keep:
            _REQ_BUFFER.add(
                Span(
                    trace_id=self.trace_id,
                    span_id=self.root_id,
                    parent_id=self.parent_id,
                    name=name,
                    start_s=float(start_s),
                    end_s=float(end_s),
                    attrs=dict(attrs) if attrs else {},
                    pid=os.getpid(),
                    thread=threading.current_thread().name,
                )
            )
            for s in self.spans:
                _REQ_BUFFER.add(s)
        self.spans = []
        return self.trace_id


def request_snapshot(trace_id: Optional[str] = None) -> List[Span]:
    return _REQ_BUFFER.snapshot(trace_id=trace_id)


def request_buffer_len() -> int:
    return len(_REQ_BUFFER)


def clear_requests() -> None:
    _REQ_BUFFER.clear()


# -- export -------------------------------------------------------------------


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def export_chrome(spans: List[Span]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the JSON Array Format with complete "X"
    events) — loads directly in Perfetto and chrome://tracing. Timestamps
    are wall-anchored microseconds, so exports from several processes
    concatenate into one coherent timeline; args carry the span identity
    for cross-process tree reassembly."""
    events = []
    for s in spans:
        events.append(
            {
                "name": s.name,
                "cat": "fma",
                "ph": "X",
                "ts": round(_wall(s.start_s) * 1e6, 3),
                "dur": round(s.duration_s * 1e6, 3),
                "pid": s.pid,
                "tid": s.thread or "main",
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    **{k: _jsonable(v) for k, v in s.attrs.items()},
                },
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_chrome(payload: Dict[str, Any]) -> List[Span]:
    """Inverse of :func:`export_chrome` (identity fields + timings): lets
    a caller merge another process's export (e.g. the engine child's
    ``GET /v1/traces``) with its own spans into one tree."""
    out: List[Span] = []
    for e in payload.get("traceEvents", []):
        args = dict(e.get("args") or {})
        trace_id = args.pop("trace_id", "")
        span_id = args.pop("span_id", "")
        parent_id = args.pop("parent_id", "")
        if not trace_id or not span_id:
            continue
        start = float(e.get("ts", 0.0)) / 1e6
        dur = float(e.get("dur", 0.0)) / 1e6
        # wall-anchored ts mapped back onto THIS process's monotonic axis,
        # so merged spans sort/nest consistently with local ones
        start_mono = _ANCHOR_MONO + (start - _ANCHOR_WALL)
        out.append(
            Span(
                trace_id=trace_id,
                span_id=span_id,
                parent_id=parent_id,
                name=str(e.get("name", "")),
                start_s=start_mono,
                end_s=start_mono + dur,
                attrs=args,
                pid=int(e.get("pid", 0) or 0),
                thread=str(e.get("tid", "")),
            )
        )
    return out


def build_tree(
    spans: List[Span],
) -> Tuple[List[Span], Dict[str, List[Span]]]:
    """(roots, children-by-span_id). A span whose parent is absent from
    the set (evicted from the ring, or recorded by a process we did not
    merge) is treated as a root rather than dropped."""
    by_id = {s.span_id: s for s in spans}
    children: Dict[str, List[Span]] = {}
    roots: List[Span] = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    for v in children.values():
        v.sort(key=lambda s: s.start_s)
    roots.sort(key=lambda s: s.start_s)
    return roots, children


def render_tree(spans: List[Span]) -> str:
    """Human rendering: one indented tree per trace, durations in ms,
    attrs inline — the "why was THIS actuation slow" view."""
    lines: List[str] = []
    by_trace: Dict[str, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    for trace_id in sorted(by_trace):
        lines.append(f"trace {trace_id}")
        roots, children = build_tree(by_trace[trace_id])

        def walk(node: Span, depth: int) -> None:
            attrs = " ".join(
                f"{k}={_jsonable(v)}" for k, v in node.attrs.items()
            )
            lines.append(
                "  " * (depth + 1)
                + f"{node.name}  {node.duration_s * 1e3:.2f}ms"
                + (f"  [{attrs}]" if attrs else "")
            )
            for c in children.get(node.span_id, []):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 0)
    return "\n".join(lines) + "\n"


def export_http(
    fmt: str = "chrome",
    trace_id: Optional[str] = None,
    clear: bool = False,
) -> Tuple[int, str, str]:
    """(status, body, content_type) — the shared body of the three export
    endpoints (engine ``/v1/traces``, launcher ``/v2/vllm/traces``,
    controller ``/debug/traces``), so format validation and the
    snapshot/clear semantics cannot drift between them. ``fmt`` is
    ``chrome`` (Perfetto-loadable JSON, the default) or ``tree`` (text);
    ``clear`` drains atomically with the snapshot, and composed with
    ``trace_id`` removes ONLY the exported trace — other traces' spans
    are never dropped unexported. Exports the union of the actuation
    ring and the request-span ring (a ``trace_id`` filter naturally
    scopes to whichever ring holds that trace)."""
    import json

    if fmt not in ("chrome", "tree"):
        return 400, "format must be chrome or tree\n", "text/plain"
    spans = (
        _BUFFER.drain(trace_id) if clear else _BUFFER.snapshot(trace_id)
    )
    spans += (
        _REQ_BUFFER.drain(trace_id)
        if clear
        else _REQ_BUFFER.snapshot(trace_id)
    )
    if fmt == "tree":
        return 200, render_tree(spans), "text/plain"
    return 200, json.dumps(export_chrome(spans)), "application/json"


def wrap_with_headers(headers: Any, fn):
    """Zero-arg callable running ``fn`` with the headers' ``traceparent``
    (if any) as the current context — the run_in_executor adoption
    pattern shared by the engine and launcher REST handlers (ContextVars
    don't follow executor dispatch on their own)."""
    ctx = context_from_headers(headers)

    def call():
        with use_context(ctx):
            return fn()

    return call


def run_traced(loop: Any, headers: Any, fn):
    """``loop.run_in_executor`` of a blocking call with the headers'
    remote ``traceparent`` adopted inside the worker thread — the one
    REST-handler dispatch pattern every traced server uses."""
    return loop.run_in_executor(None, wrap_with_headers(headers, fn))
