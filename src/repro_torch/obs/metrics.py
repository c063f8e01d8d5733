"""Low-overhead metrics registry: counters, gauges, log-scale histograms.

A copy of ``repro/obs/metrics.py``, which is framework-agnostic.

The serving stack used to keep telemetry in unbounded Python lists
(``ServingCell.latencies`` grew one float per request, forever) and a
scatter of ``_stats_lock``-guarded ints.  This module replaces both with
three fixed-footprint instruments:

``Counter``
    Monotone int64, internally locked.  ``inc(n)`` / ``.value``.
``Gauge``
    Last-write float, internally locked.  ``set(v)`` / ``.value``.
``Histogram``
    Fixed-bucket **log-scale** histogram on a preallocated numpy int64
    array — observing ten requests or ten billion costs the same bytes.
    Buckets are geometric (``per_decade`` buckets per factor of 10
    between ``lo`` and ``hi``), so quantile estimates carry a bounded
    *relative* error of one bucket ratio (~12% at the default
    ``per_decade=20``) across the whole dynamic range — the right trade
    for latencies, where 100us and 100ms matter equally.  Exact
    ``sum``/``count``/``min``/``max`` ride along, so means are exact and
    quantiles clamp to the observed range.

Every instrument owns a private ``threading.Lock`` — callers never wrap
metric updates in their own locks (the ``repro.analysis`` lock lint
knows this and exempts instrument mutations from the per-class lock
discipline).  A :class:`MetricsRegistry` is a named, get-or-create
collection with two serializations:

* :meth:`MetricsRegistry.snapshot` — JSON-safe dict (counters as ints,
  histograms as count/sum/min/max/p50/p90/p99 + sparse bucket pairs);
* :meth:`MetricsRegistry.exposition` — Prometheus text format
  (cumulative ``_bucket{le=...}`` series), round-trippable through
  :func:`parse_exposition` for scrape-pipeline tests.

See ``docs/observability.md`` for the metric catalog.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "merge_snapshots",
    "parse_exposition",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """Prometheus-legal metric name (dots and dashes become ``_``)."""
    out = _NAME_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


class Counter:
    """Monotone counter.  Internally locked: safe to ``inc`` from any
    thread without holding the owner's lock."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def footprint_bytes(self) -> int:
        return 64

    def to_snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins float gauge.  Internally locked."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += float(n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def footprint_bytes(self) -> int:
        return 64

    def to_snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-memory log-scale histogram.

    ``edges[i]`` is the inclusive upper bound of bucket ``i``
    (Prometheus ``le`` semantics); one extra overflow bucket catches
    ``v > hi``, and ``v <= lo`` lands in bucket 0 — the footprint is
    fixed at construction no matter what is observed.  Non-finite
    observations are dropped (counted in ``n_dropped``) rather than
    poisoning sum/min/max.
    """

    kind = "histogram"

    def __init__(self, name: str, *, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 20):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        n_edges = max(1, round(per_decade * math.log10(hi / lo))) + 1
        self.edges = np.geomspace(lo, hi, num=n_edges)
        self.edges[-1] = hi                     # kill geomspace rounding
        self._counts = np.zeros(n_edges + 1, np.int64)   # + overflow
        self._lock = threading.Lock()
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self.n_dropped = 0

    # -- writes --------------------------------------------------------
    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            with self._lock:
                self.n_dropped += 1
            return
        idx = int(np.searchsorted(self.edges, v, side="left"))
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # -- reads ---------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def _state(self):
        with self._lock:
            return (self._counts.copy(), self._count, self._sum,
                    self._min, self._max)

    def quantile(self, q: float) -> float:
        """Approximate quantile: log-interpolated within the covering
        bucket, clamped to the exact observed [min, max]."""
        counts, count, _, vmin, vmax = self._state()
        if count == 0:
            return 0.0
        target = q * count
        cum = np.cumsum(counts)
        j = int(np.searchsorted(cum, max(target, 1e-12), side="left"))
        j = min(j, len(counts) - 1)
        lo_b = self.edges[j - 1] if j >= 1 else self.lo / \
            (self.edges[1] / self.edges[0])
        hi_b = self.edges[j] if j < len(self.edges) else max(vmax, self.hi)
        prev = cum[j - 1] if j >= 1 else 0
        in_bucket = counts[j] if counts[j] else 1
        frac = min(max((target - prev) / in_bucket, 0.0), 1.0)
        if lo_b > 0 and hi_b > lo_b:
            val = lo_b * (hi_b / lo_b) ** frac
        else:
            val = lo_b + (hi_b - lo_b) * frac
        return float(min(max(val, vmin), vmax))

    def percentiles(self, qs: Iterable[float] = (0.5, 0.9, 0.99)) -> dict:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def footprint_bytes(self) -> int:
        return int(self._counts.nbytes + self.edges.nbytes + 128)

    def stats_dict(self) -> dict:
        """The per-stage summary shape ``EngineStats.stages`` carries."""
        counts, count, total, vmin, vmax = self._state()
        if count == 0:
            return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        return {"n": int(count),
                "p50_ms": self.quantile(0.5),
                "p99_ms": self.quantile(0.99),
                "mean_ms": total / count}

    def to_snapshot(self):
        counts, count, total, vmin, vmax = self._state()
        nz = np.nonzero(counts)[0]
        buckets = [[(float(self.edges[i]) if i < len(self.edges)
                     else math.inf), int(counts[i])] for i in nz]
        out = {"type": "histogram", "count": int(count),
               "sum": float(total), "buckets": buckets}
        if count:
            out.update(min=float(vmin), max=float(vmax),
                       p50=self.quantile(0.5), p90=self.quantile(0.9),
                       p99=self.quantile(0.99))
        return out

    @classmethod
    def merged(cls, name: str, hists: "Iterable[Histogram]") -> "Histogram":
        """Sum identically-bucketed histograms (fleet aggregation)."""
        hists = list(hists)
        if not hists:
            return cls(name)
        h0 = hists[0]
        out = cls(name, lo=h0.lo, hi=h0.hi)
        out.edges = h0.edges.copy()
        out._counts = np.zeros(len(h0._counts), np.int64)
        for h in hists:
            if len(h._counts) != len(out._counts):
                raise ValueError(
                    f"cannot merge {h.name}: bucket layout differs")
            counts, count, total, vmin, vmax = h._state()
            out._counts += counts
            out._count += count
            out._sum += total
            out._min = min(out._min, vmin)
            out._max = max(out._max, vmax)
        return out


class MetricsRegistry:
    """Named get-or-create collection of instruments.

    The registry lock only guards the name table — each instrument is
    internally locked, so the hot path (``counter(...)`` once at
    construction, ``inc()``/``observe()`` per event) never contends on
    registry-wide state.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}

    def _get_or_create(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name), "gauge")

    def histogram(self, name: str, *, lo: float = 1e-3, hi: float = 1e5,
                  per_decade: int = 20) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, lo=lo, hi=hi,
                                    per_decade=per_decade), "histogram")

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def _items(self):
        with self._lock:
            return sorted(self._metrics.items())

    def footprint_bytes(self) -> int:
        """Fixed-size proof: the sum is invariant under any number of
        observations (the bounded-telemetry regression test pins this)."""
        return sum(m.footprint_bytes() for _, m in self._items())

    # -- serialization -------------------------------------------------
    def snapshot(self, prefix: str = "") -> dict:
        return {prefix + name: m.to_snapshot() for name, m in self._items()}

    def exposition(self, prefix: str = "") -> str:
        """Prometheus text exposition (cumulative ``le`` buckets)."""
        lines = []
        for name, m in self._items():
            pname = sanitize(prefix + name)
            if m.kind == "counter":
                lines += [f"# TYPE {pname} counter",
                          f"{pname}_total {m.value}"]
            elif m.kind == "gauge":
                lines += [f"# TYPE {pname} gauge",
                          f"{pname} {m.value:.9g}"]
            else:
                counts, count, total, _, _ = m._state()
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for i, c in enumerate(counts):
                    cum += int(c)
                    le = (f"{m.edges[i]:.9g}" if i < len(m.edges)
                          else "+Inf")
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {total:.9g}")
                lines.append(f"{pname}_count {count}")
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> dict:
    """Parse :meth:`MetricsRegistry.exposition` output back into
    ``{name: {"type", ...}}`` — the scrape-side half of the round-trip
    test (and a sanity check that the text really is Prometheus-shaped).
    """
    out: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                out[parts[2]] = {"type": parts[3]}
                if parts[3] == "histogram":
                    out[parts[2]]["buckets"] = {}
            continue
        key, _, val = line.rpartition(" ")
        m = re.match(r'^([a-zA-Z0-9_:]+)_bucket\{le="([^"]+)"\}$', key)
        if m:
            out.setdefault(m.group(1), {"type": "histogram",
                                        "buckets": {}})
            out[m.group(1)]["buckets"][m.group(2)] = int(val)
            continue
        for suffix, field, cast in (("_sum", "sum", float),
                                    ("_count", "count", int),
                                    ("_total", "value", int)):
            base = key[:-len(suffix)]
            if key.endswith(suffix) and types.get(base) in (
                    "histogram", "counter"):
                out.setdefault(base, {"type": types[base]})[field] = \
                    cast(val)
                break
        else:
            if types.get(key) == "gauge":
                out.setdefault(key, {"type": "gauge"})["value"] = \
                    float(val)
    return out


def merge_snapshots(parts: "Dict[str, MetricsRegistry]") -> dict:
    """One JSON-safe snapshot over many registries: ``parts`` maps a
    prefix (``"cell0."``) to its registry — the fleet/smoke view."""
    out: dict = {}
    for prefix, reg in sorted(parts.items()):
        out.update(reg.snapshot(prefix=prefix))
    return out
