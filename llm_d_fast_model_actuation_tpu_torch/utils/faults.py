"""Fault-injection registry: named failure points on the actuation paths.

The port's own copy of ``llm_d_fast_model_actuation_tpu/utils/faults.py``
(the same spec grammar, modes and ``describe()`` document). A transactional
swap is only trustworthy if its failure paths are deterministically
testable, so each recovery-relevant transfer edge has a *named injection
point*: production code calls :func:`fire` at the edge, which is a no-op
until a test (or an operator running a fault drill) arms the point.

Known points (the reference's set, in its ``describe()``; arbitrary names
are accepted so tests can add their own). Fired by the port: ``swap.d2h``
(a hot-swap's outgoing bucket issue) and ``swap.h2d`` (its incoming
bucket issue), ``coldload.read`` (a reader's shard), ``coldload.h2d`` (a
tensor's transfer), ``prefetch.stage``, ``launcher.rpc`` (each launcher
to engine call), ``instance.spawn`` (a supervised restart's spawn),
``kvsave.d2h`` and ``kvrestore.h2d`` (each chunk of a zero-drain park's
page-out and of its resume's page-in, ``engine/parked.py``), and
``migrate.export`` (after a migration's park), ``migrate.import`` (before
an import is seated) and ``migrate.ack`` (after it is seated, its ack
stored: the lost-ack drill).

Modes (per point): **fail** raises :class:`FaultError` the next ``count``
times the point fires (fail-once is ``count=1``, fail-N is ``count=N``,
``count=-1`` is every time); **delay** sleeps ``delay_s`` seconds for the
next ``count`` firings (default: every time) — the slow-link / slow-bind
simulator.

Arming surfaces (all equivalent):
  * env var ``FMA_FAULTS`` — loaded by the engine service at startup
    (a launcher's engine children get it through their env_vars);
  * engine flag ``--faults "<spec>"``;
  * REST — engine ``/v1/faults`` (GET describe / POST arm / DELETE reset).

Spec grammar (comma-separated): ``point=fail`` | ``point=fail:N`` |
``point=delay:SECONDS`` | ``point=delay:SECONDS:N``, e.g.
``FMA_FAULTS="swap.h2d=fail:1,coldload.read=delay:0.25"``.

The registry is process-global and thread-safe; state armed pre-fork is
inherited by forked children (the launcher's process model).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

#: the points production code is wired to fire (documentation + describe())
KNOWN_POINTS = (
    "swap.d2h",
    "swap.h2d",
    "kvsave.d2h",
    "kvrestore.h2d",
    "migrate.export",
    "migrate.import",
    "migrate.ack",
    "coldload.read",
    "coldload.h2d",
    "prefetch.stage",
    "launcher.rpc",
    "instance.spawn",
)

ENV_VAR = "FMA_FAULTS"


class FaultError(RuntimeError):
    """The injected failure (mode=fail). Deliberately a plain RuntimeError
    subclass: recovery code must handle it exactly like a real transfer /
    RPC / spawn failure, never special-case it."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault at {point!r}")
        self.point = point


@dataclass
class _Armed:
    mode: str  # "fail" | "delay"
    remaining: int  # firings left to act on; -1 = unbounded
    delay_s: float = 0.0
    fired: int = 0  # times this point acted (raised or slept)


def _parse_one(item: str) -> tuple:
    """``point=mode[:arg[:count]]`` -> (point, _Armed); ValueError on junk."""
    point, sep, rhs = item.partition("=")
    point = point.strip()
    if not sep or not point or not rhs.strip():
        raise ValueError(f"bad fault spec {item!r} (want point=mode[:...])")
    parts = [p.strip() for p in rhs.split(":")]
    mode = parts[0]
    if mode == "fail":
        if len(parts) > 2:
            raise ValueError(f"bad fault spec {item!r} (fail[:N])")
        count = int(parts[1]) if len(parts) == 2 else 1
        return point, _Armed(mode="fail", remaining=count)
    if mode == "delay":
        if len(parts) < 2 or len(parts) > 3:
            raise ValueError(f"bad fault spec {item!r} (delay:SECONDS[:N])")
        delay_s = float(parts[1])
        if delay_s < 0:
            raise ValueError(f"bad fault spec {item!r} (negative delay)")
        count = int(parts[2]) if len(parts) == 3 else -1
        return point, _Armed(mode="delay", remaining=count, delay_s=delay_s)
    raise ValueError(f"bad fault spec {item!r} (mode must be fail|delay)")


def parse_spec(spec: str) -> Dict[str, _Armed]:
    """Validate + parse a comma-separated spec string (see module doc)."""
    out: Dict[str, _Armed] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        point, armed = _parse_one(item)
        out[point] = armed
    return out


class FaultRegistry:
    """Thread-safe map of armed injection points."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._points: Dict[str, _Armed] = {}
        self._env_loaded = False

    # -- arming ------------------------------------------------------------

    def arm(
        self,
        point: str,
        mode: str = "fail",
        count: Optional[int] = None,
        delay_s: float = 0.0,
    ) -> None:
        """Programmatic arming; ``count=None`` takes the mode's documented
        default — fail once, delay every time — matching the spec grammar
        (``p=fail`` vs ``p=delay:S``)."""
        if count is None:
            count = 1 if mode == "fail" else -1
        _, armed = _parse_one(
            f"{point}={mode}:{delay_s}:{count}"
            if mode == "delay"
            else f"{point}={mode}:{count}"
        )
        with self._mu:
            self._points[point] = armed

    def arm_spec(self, spec: str) -> None:
        parsed = parse_spec(spec)
        with self._mu:
            self._points.update(parsed)

    def disarm(self, point: str) -> None:
        with self._mu:
            self._points.pop(point, None)

    def reset(self) -> None:
        with self._mu:
            self._points.clear()

    def load_env(self) -> None:
        """Arm from ``FMA_FAULTS`` once per process (idempotent: a second
        service constructed in the same process must not re-arm points the
        first already consumed)."""
        with self._mu:
            if self._env_loaded:
                return
            self._env_loaded = True
        spec = os.environ.get(ENV_VAR, "")
        if spec:
            self.arm_spec(spec)

    # -- firing ------------------------------------------------------------

    def fire(self, point: str) -> None:
        """Act on ``point`` if armed: raise :class:`FaultError` (fail) or
        sleep (delay). No-op — one dict lookup under a lock — otherwise."""
        with self._mu:
            armed = self._points.get(point)
            if armed is None or armed.remaining == 0:
                return
            if armed.remaining > 0:
                armed.remaining -= 1
            armed.fired += 1
            if armed.mode == "fail":
                if armed.remaining == 0:
                    # consumed: drop so describe() shows only live points
                    self._points.pop(point, None)
                raise FaultError(point)
            delay_s = armed.delay_s
            if armed.remaining == 0:
                self._points.pop(point, None)
        time.sleep(delay_s)  # outside the lock: a delay must not serialize

    # -- observability -----------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "known_points": list(KNOWN_POINTS),
                "armed": {
                    p: {
                        "mode": a.mode,
                        "remaining": a.remaining,
                        "delay_s": a.delay_s,
                        "fired": a.fired,
                    }
                    for p, a in self._points.items()
                },
            }


#: the process-global registry every injection site fires into
FAULTS = FaultRegistry()


def fire(point: str) -> None:
    FAULTS.fire(point)


def arm(
    point: str,
    mode: str = "fail",
    count: Optional[int] = None,
    delay_s: float = 0.0,
) -> None:
    FAULTS.arm(point, mode=mode, count=count, delay_s=delay_s)


def arm_spec(spec: str) -> None:
    FAULTS.arm_spec(spec)


def disarm(point: str) -> None:
    FAULTS.disarm(point)


def reset() -> None:
    FAULTS.reset()


def load_env() -> None:
    FAULTS.load_env()


def describe() -> Dict[str, Any]:
    return FAULTS.describe()
