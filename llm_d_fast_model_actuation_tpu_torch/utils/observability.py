"""One observability endpoint: prometheus metrics + python debug handlers.

The port of the JAX package's ``utils/observability.py``. The reference
serves prometheus and Go pprof from one mux
(pkg/observability/prom-and-debug.go:34-79). The python-native analogue:

  GET /metrics       — prometheus exposition of this process's registry
                       (``utils/prom.py``, written by hand: the card's
                       machine has no ``prometheus_client``)
  GET /debug/stacks  — current traceback of every thread (the goroutine-dump
                       equivalent; what you want from a wedged controller)
  GET /debug/vars    — process vitals: rss, fds, gc counts, thread count,
                       process uptime
  GET /debug/traces  — this process's actuation-span ring buffer
                       (utils/tracing.py): Chrome trace-event JSON
                       (Perfetto-loadable) or ?format=tree

Runs on a daemon thread with the stdlib ThreadingHTTPServer — zero extra
dependencies, safe to import before an event loop exists.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: import-time anchor: the fallback for uptime_s when /proc is unavailable
#: (this module is imported early in every process that serves it)
_IMPORT_MONO = time.monotonic()


def _uptime_s() -> float:
    """Seconds since the PROCESS started (not since this module imported),
    via /proc where available — stuck-thread triage wants "has this
    controller been up 30 s or 30 days" without diffing /debug/stacks."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])  # starttime: field 22 overall
        with open("/proc/uptime") as f:
            sys_uptime = float(f.read().split()[0])
        return max(0.0, sys_uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, IndexError, ValueError):
        return time.monotonic() - _IMPORT_MONO


def _dump_stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def _vars() -> dict:
    info = {
        "pid": os.getpid(),
        "uptime_s": round(_uptime_s(), 3),
        "threads": threading.active_count(),
        "gc_counts": gc.get_count(),
        "gc_objects": len(gc.get_objects()),
    }
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmHWM", "Threads", "FDSize")):
                    k, v = line.split(":", 1)
                    info["proc_" + k.lower()] = v.strip()
    except OSError:
        pass
    return info


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            from .prom import exposition

            self._send(200, exposition().encode(), "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/stacks":
            self._send(200, _dump_stacks().encode(), "text/plain")
        elif path == "/debug/vars":
            self._send(
                200, json.dumps(_vars(), default=str).encode(), "application/json"
            )
        elif path == "/debug/traces":
            from urllib.parse import parse_qs

            from . import tracing

            q = parse_qs(query)
            status, body, ctype = tracing.export_http(
                (q.get("format") or ["chrome"])[0],
                trace_id=(q.get("trace_id") or [None])[0],
                clear=(q.get("clear") or [""])[0] in ("1", "true"),
            )
            self._send(status, body.encode(), ctype)
        else:
            self._send(404, b"not found\n", "text/plain")


def serve_observability(
    port: int, host: str = "0.0.0.0"
) -> ThreadingHTTPServer:
    """Start the metrics+debug server on a daemon thread; returns the server
    (tests call .shutdown())."""
    server = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(
        target=server.serve_forever, daemon=True, name="observability"
    )
    t.start()
    return server
