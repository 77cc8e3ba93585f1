"""Prometheus metric kinds and the text exposition, written by hand.

The JAX package builds its metrics on ``prometheus_client``; the card's
machine has none, so the port writes the three kinds its catalogs use
(``Counter``, ``Gauge``, ``Histogram``, with ``labels()``, ``inc``,
``set`` and ``observe``) and the text exposition format 0.0.4
(:func:`exposition`), as ``prometheus_client.generate_latest`` writes it
less its ``_created`` samples. Every catalog of the port (the controllers'
``controller/metrics.py``, the engine's and the launcher's) registers here:
one registry per process, in registration order.

Registering a family name that is already registered does not add a
second family: the new object shares the first one's children, so both
update the same samples and the exposition holds the family once. That
happens when a module is imported twice under two names, as the engine's
server is when it runs as ``__main__`` in a process that also imports it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

#: prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0)

#: every family registered in this process, in registration order
REGISTRY: List["_Metric"] = []
_REGISTRY_LOCK = threading.Lock()


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
        with _REGISTRY_LOCK:
            first = next((m for m in REGISTRY if m.name == name and m.kind == self.kind), None)
            if first is None:
                self._children: Dict[Tuple[str, ...], object] = {}
                self._lock = threading.Lock()
                REGISTRY.append(self)
            else:
                # the same family again: one set of samples
                self._children, self._lock = first._children, first._lock
        if not self.labelnames:
            self.labels()  # exposed at 0 from the start, as prometheus_client does

    def labels(self, **kw: str):
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
            return child

    def _unlabelled(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}: use labels()")
        return self.labels()

    # a family without labels is its own child, as in prometheus_client
    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)

    def set(self, value: float) -> None:
        self._unlabelled().set(value)

    def observe(self, value: float) -> None:
        self._unlabelled().observe(value)

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

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


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

    @property
    def count(self) -> int:
        return sum(self.counts)

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
        self.buckets = tuple(float(b) for b in buckets if not math.isinf(b))
        super().__init__(name, documentation, labelnames)

    def _child(self):
        return _HistogramValue(self.buckets)


def exposition() -> str:
    """Every registered family in the Prometheus text format 0.0.4."""
    lines = []
    for m in list(REGISTRY):
        # a counter's family is named with its _total, as prometheus_client writes it
        family = m.name + "_total" if m.kind == "counter" else m.name
        lines.append(f"# HELP {family} {m.documentation}")
        lines.append(f"# TYPE {family} {m.kind}")
        lines.extend(m.samples())
    return "\n".join(lines) + "\n"


def unregister(prefix: str) -> None:
    """Drop every family whose name starts with ``prefix``."""
    with _REGISTRY_LOCK:
        REGISTRY[:] = [m for m in REGISTRY if not m.name.startswith(prefix)]
