"""The actuation cost oracle's substrate: bandwidth EWMAs and the
decision flight recorder.

Port of ``llm_d_fast_model_actuation_tpu/utils/costs.py``, with its names,
keys and constants, so the same observations give the same estimates and
summaries. A scheduler needs the cost of an actuation (a sleep, a wake, a
swap, a prefetch) in bytes and seconds before anything moves. Bytes are
exactly predictable beforehand (the chunk store's digests fix a sibling
swap's delta, ``models/quant.py:payload_nbytes`` sizes a compressed
payload from its shape); seconds need a measured bandwidth. Every engine
keeps two pieces:

  * :class:`BandwidthEWMA` / :class:`BandwidthBook`: per transfer kind,
    an exponentially decayed GiB/s estimate (``swap.d2h``, ``swap.h2d``,
    ``swap.total`` (the whole verb's effective rate, which pool-hit
    pricing prefers), ``wake.h2d``, ``sleep.d2h``, ``coldload.read``,
    ``coldload.h2d`` and ``quant.dequant``, the on-device expansion tail
    of a compressed wake that no transfer hid), fed by the byte and time
    figures the transfer paths measure (``engine/sleep.py``,
    ``models/hf.py``) and kept across actuations by the service. A kind
    with no history falls back to the best-sampled kind of the same
    direction, then to a conservative constant, flagged ``measured:
    false``.
  * :class:`FlightRecorder`: a bounded ring of :class:`ActuationRecord`
    rows, one per actuation: kind, model, trigger, tier, predicted and
    actual bytes and seconds, their relative errors, outcome. Served by
    ``GET /v1/actuations`` and summarized into ``GET /v1/stats``, which a
    launcher lifts into its ``ledger.costs`` block.

Standard library only, bounded memory, thread-safe; never raises into an
actuation path.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: conservative cold-start GiB/s per direction family — used only before
#: the first measured transfer of any kind in that family, and always
#: reported with ``measured: false``. Deliberately low-ball: over-predicting seconds makes a
#: scheduler conservative, never late.
DEFAULT_GIBPS: Dict[str, float] = {
    "d2h": 1.0,
    "h2d": 1.0,
    "read": 0.5,
}
_FALLBACK_GIBPS = 1.0

#: default flight-recorder capacity (records, not bytes — each is a
#: small dict); overridable via FMA_FLIGHT_RECORDER_CAP
DEFAULT_RECORDER_CAPACITY = 512


def kind_family(kind: str) -> str:
    """Direction family of a transfer kind: ``"swap.d2h" -> "d2h"`` —
    the fallback bucket when the exact kind has no history yet."""
    return kind.rsplit(".", 1)[-1]


class BandwidthEWMA:
    """Exponentially-decayed GiB/s estimate for one transfer kind.

    Each observation contributes weight 1; all prior weight decays by
    ``exp(-dt / tau_s) * obs_decay`` — exponential in elapsed time AND
    in observation count — so the estimate is a weighted mean dominated
    by recent transfers. That double decay is deliberate: the first
    transfer of a kind often carries one-time costs (allocator growth, cache
    population) that would anchor a
    plain mean low forever, and a backend change (new link, new host)
    must re-converge within a few actuations. Reading is side-effect
    free (numerator and denominator decay together, so the ratio is
    time-invariant between observations)."""

    def __init__(
        self, tau_s: float = 600.0, obs_decay: float = 0.35
    ) -> None:
        self.tau_s = max(1e-6, float(tau_s))
        self.obs_decay = min(1.0, max(0.0, float(obs_decay)))
        self._weight = 0.0
        self._weighted_gibps = 0.0
        self._t: Optional[float] = None
        self.samples = 0
        self.last_gibps = 0.0

    def observe(
        self, nbytes: int, seconds: float, now: Optional[float] = None
    ) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        g = (nbytes / 2**30) / seconds
        t = time.monotonic() if now is None else now
        decay = self.obs_decay
        if self._t is not None and t > self._t:
            decay *= math.exp(-(t - self._t) / self.tau_s)
        self._weight *= decay
        self._weighted_gibps *= decay
        self._t = t
        self._weight += 1.0
        self._weighted_gibps += g
        self.samples += 1
        self.last_gibps = g

    def gibps(self) -> Optional[float]:
        if self._weight <= 0:
            return None
        return self._weighted_gibps / self._weight


class BandwidthBook:
    """Per-kind :class:`BandwidthEWMA` registry with direction-family
    fallback — one instance per engine process, fed by every actuation
    transfer. Thread-safe (observations come from the engine/admin
    threads, reads from HTTP executor threads)."""

    def __init__(self, tau_s: float = 600.0) -> None:
        self.tau_s = tau_s
        self._mu = threading.Lock()
        self._kinds: Dict[str, BandwidthEWMA] = {}

    def observe(self, kind: str, nbytes: int, seconds: float) -> None:
        with self._mu:
            ew = self._kinds.get(kind)
            if ew is None:
                ew = self._kinds[kind] = BandwidthEWMA(self.tau_s)
            ew.observe(nbytes, seconds)

    def has(self, kind: str) -> bool:
        """True when `kind` itself has measured history (no family
        fallback considered)."""
        with self._mu:
            ew = self._kinds.get(kind)
            return ew is not None and ew.samples > 0

    def estimate(self, kind: str) -> Tuple[float, bool, str]:
        """``(gibps, measured, source)`` for `kind`: the kind's own EWMA
        when it has history; else the best-sampled same-family kind
        (``measured`` stays True — same direction, same link); else the
        conservative :data:`DEFAULT_GIBPS` constant with ``measured``
        False."""
        fam = kind_family(kind)
        with self._mu:
            ew = self._kinds.get(kind)
            if ew is not None and ew.samples > 0:
                return float(ew.gibps()), True, kind
            best: Optional[Tuple[str, BandwidthEWMA]] = None
            for k, cand in self._kinds.items():
                if kind_family(k) != fam or cand.samples <= 0:
                    continue
                if best is None or cand.samples > best[1].samples:
                    best = (k, cand)
            if best is not None:
                return float(best[1].gibps()), True, best[0]
        return DEFAULT_GIBPS.get(fam, _FALLBACK_GIBPS), False, "default"

    def seconds_for(self, kind: str, nbytes: int) -> Tuple[float, bool]:
        """Predicted seconds to move `nbytes` on the `kind` path, and
        whether the bandwidth behind it was measured."""
        gibps, measured, _ = self.estimate(kind)
        return (max(0, nbytes) / 2**30) / max(1e-9, gibps), measured

    def describe(self) -> Dict[str, Dict[str, Any]]:
        with self._mu:
            return {
                k: {
                    "gibps": round(ew.gibps() or 0.0, 6),
                    "last_gibps": round(ew.last_gibps, 6),
                    "samples": ew.samples,
                }
                for k, ew in self._kinds.items()
            }


@dataclass
class ActuationRecord:
    """One flight-recorder row: what the scheduler decided to move, what
    the oracle priced it at, and what it actually cost."""

    seq: int
    t_wall: float  #: unix seconds at record time (the ring is ordered)
    kind: str  #: swap | sleep | wake | coldload | prefetch | attach | detach | migrate
    model: str
    trigger: str  #: client | restart | escalation | startup
    #: where the moved state lived / went: pool | prefetched | host |
    #: disk | cold | resident | coresident (a sibling variant sharing
    #: the live base's device tensors) | discard (an L2 sleep drops the
    #: host copy) | "" (unknown, e.g. a failed swap priced before any
    #: tier resolved)
    tier: str
    outcome: str  #: committed | rolled_back | failed
    actual_bytes: int = 0
    actual_s: float = 0.0
    predicted_bytes: Optional[int] = None
    predicted_s: Optional[float] = None
    #: prediction based on measured bandwidth (False = cold-start
    #: constant fallback — distrust the seconds figure)
    measured: bool = False
    #: signed (predicted - actual) / actual; None when unpredicted or
    #: the actual is zero
    bytes_error_ratio: Optional[float] = None
    seconds_error_ratio: Optional[float] = None
    #: structured per-actuation context; zero-drain actuations record
    #: ``preempted`` / ``resumed`` request counts here, so
    #: GET /v1/actuations shows what each swap displaced
    extra: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "seq": self.seq,
            "t_wall": round(self.t_wall, 6),
            "kind": self.kind,
            "model": self.model,
            "trigger": self.trigger,
            "tier": self.tier,
            "outcome": self.outcome,
            "actual_bytes": int(self.actual_bytes),
            "actual_s": round(self.actual_s, 6),
            "predicted_bytes": (
                None if self.predicted_bytes is None
                else int(self.predicted_bytes)
            ),
            "predicted_s": (
                None if self.predicted_s is None
                else round(self.predicted_s, 6)
            ),
            "measured": bool(self.measured),
            "bytes_error_ratio": (
                None if self.bytes_error_ratio is None
                else round(self.bytes_error_ratio, 6)
            ),
            "seconds_error_ratio": (
                None if self.seconds_error_ratio is None
                else round(self.seconds_error_ratio, 6)
            ),
        }
        if self.extra:
            out["extra"] = dict(self.extra)
        return out


def _rel_error(
    predicted: Optional[float], actual: float
) -> Optional[float]:
    if predicted is None or actual <= 0:
        return None
    return (float(predicted) - float(actual)) / float(actual)


class FlightRecorder:
    """Bounded ring of :class:`ActuationRecord` rows (oldest dropped).

    ``record(...)`` computes the prediction error ratios; ``records()``
    returns dict rows oldest-first; ``summary(last_n)`` scores the
    oracle over the most recent predicted records — what ``GET
    /v1/stats`` serves and the fleet harness reads."""

    def __init__(self, capacity: int = DEFAULT_RECORDER_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.total_recorded = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    def record(
        self,
        kind: str,
        model: str,
        trigger: str = "client",
        tier: str = "",
        outcome: str = "committed",
        actual_bytes: int = 0,
        actual_s: float = 0.0,
        predicted_bytes: Optional[int] = None,
        predicted_s: Optional[float] = None,
        measured: bool = False,
        extra: Optional[Dict[str, Any]] = None,
    ) -> ActuationRecord:
        with self._mu:
            self._seq += 1
            rec = ActuationRecord(
                seq=self._seq,
                t_wall=time.time(),
                kind=kind,
                model=model,
                trigger=trigger,
                tier=tier,
                outcome=outcome,
                actual_bytes=int(actual_bytes),
                actual_s=float(actual_s),
                predicted_bytes=predicted_bytes,
                predicted_s=predicted_s,
                measured=measured,
                bytes_error_ratio=_rel_error(
                    predicted_bytes, float(actual_bytes)
                ),
                seconds_error_ratio=_rel_error(predicted_s, actual_s),
                extra=dict(extra or {}),
            )
            self._ring.append(rec)
            self.total_recorded += 1
            return rec

    def records(
        self, n: int = 0, kind: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        with self._mu:
            rows = list(self._ring)
        if kind:
            rows = [r for r in rows if r.kind == kind]
        if n and n > 0:
            rows = rows[-n:]
        return [r.as_dict() for r in rows]

    def summary(self, last_n: int = 32) -> Dict[str, Any]:
        """Oracle accuracy over the last `last_n` records: how many were
        priced, the byte-exact fraction (delta/quant byte prediction is
        deterministic — anything below 1.0 means digests drifted), and
        the mean/max absolute seconds error ratio."""
        with self._mu:
            rows = list(self._ring)[-max(1, last_n):]
            total = self.total_recorded
        by_kind: Dict[str, int] = {}
        for r in rows:
            by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
        # only COMMITTED actuations score byte exactness: a rolled-back
        # or failed swap recorded actual_bytes=0 against a real
        # prediction, and counting it as a miss would read as digest
        # drift (the signal byte_exact_frac exists to expose)
        priced = [
            r
            for r in rows
            if r.predicted_bytes is not None and r.outcome == "committed"
        ]
        byte_exact = sum(
            1 for r in priced if r.predicted_bytes == r.actual_bytes
        )
        sec_errors = [
            abs(r.seconds_error_ratio)
            for r in rows
            if r.seconds_error_ratio is not None and r.measured
        ]
        out: Dict[str, Any] = {
            "recorded_total": total,
            "window": len(rows),
            "by_kind": by_kind,
            "priced": len(priced),
            "byte_exact": byte_exact,
            "byte_exact_frac": (
                round(byte_exact / len(priced), 6) if priced else None
            ),
            "seconds_error_judged": len(sec_errors),
            "mean_abs_seconds_error_ratio": (
                round(sum(sec_errors) / len(sec_errors), 6)
                if sec_errors
                else None
            ),
            "max_abs_seconds_error_ratio": (
                round(max(sec_errors), 6) if sec_errors else None
            ),
        }
        if rows:
            out["last"] = rows[-1].as_dict()
        return out


class CostBook:
    """The one cost-oracle object an :class:`EngineService` owns: the
    bandwidth book plus the flight recorder, with the transfer-path
    callback (`observe_transfer`) the sleep/load machinery feeds."""

    def __init__(
        self,
        capacity: int = DEFAULT_RECORDER_CAPACITY,
        tau_s: float = 600.0,
    ) -> None:
        self.bandwidths = BandwidthBook(tau_s=tau_s)
        self.recorder = FlightRecorder(capacity=capacity)

    def observe_transfer(
        self, kind: str, nbytes: int, seconds: float
    ) -> None:
        """The byte/time figure callback every transfer path reports
        through (engine/sleep.py on_transfer, models/hf.py
        LoadStats.transfer_figures). Never raises — telemetry must not
        fail an actuation."""
        try:
            self.bandwidths.observe(kind, nbytes, seconds)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def record(self, **kw: Any) -> ActuationRecord:
        return self.recorder.record(**kw)

    def summary(self, last_n: int = 32) -> Dict[str, Any]:
        return {
            "bandwidth_gibps": self.bandwidths.describe(),
            "prediction": self.recorder.summary(last_n=last_n),
        }
