"""Metrics registry: counters, gauges, and log-bucket histograms (the
port's copy of ``repro.obs.metrics``).

One :class:`MetricsRegistry` per measurement scope (a drain, a tuning
plan run, a calibration pass).  Producers grab an instrument by name —
``registry.counter("serve.retired").inc()`` — and every instrument is
created on first touch, so publishing code never pre-declares schemas.
Consumers read either :meth:`MetricsRegistry.snapshot` (a plain nested
dict, the programmatic API the drain harnesses rebuild their
``stats_out`` shims from) or :meth:`MetricsRegistry.to_prometheus`
(text exposition in the Prometheus format).

Histograms are log-bucketed (power-of-two upper edges): an observation
``v`` lands in the bucket whose upper edge is the smallest ``2**k >=
v``.  That keeps per-instrument state O(log range) — queue waits span
one tick to tens of thousands — while still answering p50/p99 queries
to within a factor of two, which is the right resolution for a tick
clock (exact percentiles for latency come from the trace spans, see
:mod:`repro_torch.obs.trace`).

Nothing here touches torch or the runtime: the module is importable from
anywhere (tunables, benchmarks, calibrate) without cycles.
"""

from __future__ import annotations

import math
from typing import Iterator

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _prom_name(name: str) -> str:
    """Dotted registry names -> Prometheus-legal metric names."""

    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class Counter:
    """Monotonic accumulator; ``inc`` with a negative amount raises."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, "
                             f"got {amount}")
        self.value += amount


class Gauge:
    """Last-write-wins scalar (plus inc/dec for level tracking)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Log-bucket (base-2) histogram.

    ``buckets`` maps bucket exponent ``k`` to a count of observations
    ``v`` with ``2**(k-1) < v <= 2**k`` (``k=0`` holds ``v <= 1``,
    non-positive observations included).  ``sum``/``count`` give exact
    totals; :meth:`quantile` answers from bucket upper edges, so it is
    exact-to-a-factor-of-two, never an underestimate by more."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}
        self.sum = 0.0
        self.count = 0

    @staticmethod
    def bucket_of(value: float) -> int:
        if value <= 1.0:
            return 0
        return max(0, math.ceil(math.log2(value)))

    def observe(self, value: float) -> None:
        k = self.bucket_of(float(value))
        self.buckets[k] = self.buckets.get(k, 0) + 1
        self.sum += float(value)
        self.count += 1

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket containing the ``q``-quantile
        observation (0 when the histogram is empty)."""

        if not self.count:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = q * self.count
        seen = 0
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if seen >= rank:
                return float(2 ** k)
        return float(2 ** max(self.buckets))

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name -> instrument store with create-on-first-touch semantics.

    A name is bound to one instrument kind for the registry's lifetime;
    asking for the same name as a different kind raises (catching the
    classic counter-vs-gauge publishing bug at the call site)."""

    def __init__(self) -> None:
        self._metrics: dict[tuple[str, LabelKey], object] = {}
        self._kinds: dict[str, str] = {}
        self._help: dict[str, str] = {}

    def _get(self, kind: str, cls, name: str, help: str,
             labels: dict[str, str]):
        bound = self._kinds.setdefault(name, kind)
        if bound != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{bound}, requested {kind}")
        if help and name not in self._help:
            self._help[name] = help
        key = (name, _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = self._metrics[key] = cls()
        return inst

    def counter(self, name: str, help: str = "",
                **labels: str) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  **labels: str) -> Histogram:
        return self._get("histogram", Histogram, name, help, labels)

    def __iter__(self) -> Iterator[tuple[str, LabelKey, object]]:
        for (name, key), inst in sorted(self._metrics.items()):
            yield name, key, inst

    def collect(self, prefix: str) -> dict[str, float]:
        """Unlabelled scalar values under ``prefix.`` keyed by the name
        remainder — the back-compat bridge that rebuilds the drain
        harnesses' ``stats_out`` dicts from registry state."""

        dot = prefix + "."
        out: dict[str, float] = {}
        for name, key, inst in self:
            if key or not name.startswith(dot):
                continue
            if isinstance(inst, (Counter, Gauge)):
                out[name[len(dot):]] = inst.value
        return out

    def snapshot(self) -> dict[str, dict]:
        """Plain-data view of every instrument: ``{"counters": {...},
        "gauges": {...}, "histograms": {name: {count,sum,p50,p99,
        buckets}}}`` with labelled series keyed
        ``name{label="value"}``."""

        snap: dict[str, dict] = {"counters": {}, "gauges": {},
                                 "histograms": {}}
        for name, key, inst in self:
            label = name + _label_str(key)
            if isinstance(inst, Counter):
                snap["counters"][label] = inst.value
            elif isinstance(inst, Gauge):
                snap["gauges"][label] = inst.value
            else:
                assert isinstance(inst, Histogram)
                snap["histograms"][label] = {
                    "count": inst.count, "sum": inst.sum,
                    "mean": inst.mean(),
                    "p50": inst.quantile(0.5),
                    "p99": inst.quantile(0.99),
                    "buckets": {str(k): v for k, v
                                in sorted(inst.buckets.items())},
                }
        return snap

    def to_prometheus(self) -> str:
        """Text exposition (Prometheus format): HELP/TYPE headers per
        family, cumulative ``_bucket{le=...}`` series plus ``_sum`` /
        ``_count`` for histograms."""

        lines: list[str] = []
        seen_header: set[str] = set()
        for name, key, inst in self:
            pname = _prom_name(name)
            if name not in seen_header:
                seen_header.add(name)
                if name in self._help:
                    lines.append(f"# HELP {pname} {self._help[name]}")
                lines.append(f"# TYPE {pname} {self._kinds[name]}")
            ls = _label_str(key)
            if isinstance(inst, (Counter, Gauge)):
                lines.append(f"{pname}{ls} {inst.value:g}")
            else:
                assert isinstance(inst, Histogram)
                cum = 0
                for k in sorted(inst.buckets):
                    cum += inst.buckets[k]
                    edge = _label_key({"le": f"{2 ** k:g}"})
                    lines.append(f"{pname}_bucket"
                                 f"{_label_str(key + edge)} {cum}")
                inf = _label_key({"le": "+Inf"})
                lines.append(f"{pname}_bucket{_label_str(key + inf)} "
                             f"{inst.count}")
                lines.append(f"{pname}_sum{ls} {inst.sum:g}")
                lines.append(f"{pname}_count{ls} {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
