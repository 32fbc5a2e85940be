"""Typed metrics registry: the port's copy of the registry in
dml_tpu/observability.py.

- `Counter`: monotonically increasing totals (requests served, tokens
  decoded).
- `Gauge`: instantaneous values (occupied slots, resident cache bytes).
- `Histogram`: streaming distributions over fixed log-spaced buckets
  (`log_buckets`), mergeable and O(buckets) in memory.

Each takes labels (`.labels(reason="acceptance")`); one metric object
fans out into per-label-set children. Updates are host-side,
lock-protected dict writes, outside any device work: the LM server
updates a handful of them per dispatch, never per token.

`METRICS` is the process-wide registry that `inference.lm_server` and
`inference.kv_cache` write into, under the JAX package's metric names.
`snapshot()` dumps it as JSON-able data, `to_prometheus_text()` in the
Prometheus text format. The JAX module's spans, profiles, JSON logs and
cross-node merge are not part of the port yet.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_key(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


def log_buckets(lo: float = 1e-4, hi: float = 100.0, per_decade: int = 6) -> Tuple[float, ...]:
    """Fixed log-spaced bucket edges: `per_decade` edges per decade from
    `lo` up to (at least) `hi`. The constant ratio between adjacent
    edges bounds a percentile's error to one ratio step at any
    magnitude."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    edges: List[float] = []
    i = 0
    while True:
        e = lo * 10.0 ** (i / per_decade)
        edges.append(e)
        if e >= hi:
            return tuple(edges)
        i += 1


#: default edges for latency-in-seconds histograms: 100 µs .. 100 s
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 100.0, per_decade=6)


class _Child:
    """A metric bound to one label set. Holds only (parent, key): the
    values live in the parent, so a registry reset never strands a
    cached handle."""

    __slots__ = ("_m", "_key")

    def __init__(self, metric: "_Metric", key: _LabelKey):
        self._m = metric
        self._key = key


class _CounterChild(_Child):
    def inc(self, n: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + n


class _GaugeChild(_Child):
    def set(self, v: float) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = float(v)

    def inc(self, n: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class _HistChild(_Child):
    def observe(self, v: float) -> None:
        m = self._m
        v = float(v)
        with m._lock:
            st = m._values.get(self._key)
            if st is None:
                # [count, sum, min, max, bucket counts]; the last bucket
                # is the +Inf overflow
                st = m._values[self._key] = [0, 0.0, math.inf, -math.inf,
                                             [0] * (len(m.edges) + 1)]
            st[0] += 1
            st[1] += v
            st[2] = min(st[2], v)
            st[3] = max(st[3], v)
            st[4][bisect.bisect_left(m.edges, v)] += 1


class _Metric:
    kind = ""
    _child_cls = _Child

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[_LabelKey, _Child] = {}
        self._values: Dict[_LabelKey, Any] = {}

    def labels(self, **labels: Any):
        """Bind a label set; returns a cached child handle."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._child_cls(self, key))
        return child

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def items(self) -> List[Tuple[_LabelKey, Any]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(n)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float, **labels: Any) -> None:
        self.labels(**labels).set(v)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    kind = "histogram"
    _child_cls = _HistChild

    def __init__(self, name: str, help: str = "", edges: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"{name}: bucket edges must strictly increase")
        self.edges = edges

    def observe(self, v: float, **labels: Any) -> None:
        self.labels(**labels).observe(v)


class MetricsRegistry:
    """Process-wide named-metric table. `counter`/`gauge`/`histogram`
    are get-or-create (idempotent by name; a kind clash raises), so any
    module can declare its metrics at import time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "",
                  edges: Sequence[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, edges=edges)  # type: ignore[return-value]

    def reset(self) -> None:
        """Zero every metric's values. Metric objects and cached child
        handles stay valid."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def snapshot(self, node: Optional[str] = None) -> Dict[str, Any]:
        """JSON-able dump. Histogram buckets are sparse ({index: count}
        for nonzero buckets); the default edge set is named, not
        listed."""
        out: Dict[str, Any] = {"v": 1, "proc": os.getpid(), "ts": time.time(),
                               "counters": {}, "gauges": {}, "histograms": {}}
        if node is not None:
            out["node"] = node
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, val in m.items():
                fk = _fmt_key(m.name, key)
                if m.kind == "counter":
                    out["counters"][fk] = val
                elif m.kind == "gauge":
                    out["gauges"][fk] = val
                else:
                    count, total, mn, mx, buckets = val
                    edges = m.edges  # type: ignore[attr-defined]
                    out["histograms"][fk] = {
                        "count": count, "sum": total,
                        "min": mn if count else None, "max": mx if count else None,
                        "edges": "default" if edges == DEFAULT_TIME_BUCKETS else list(edges),
                        "bkt": {str(i): c for i, c in enumerate(buckets) if c},
                    }
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            items = m.items()
            if not items:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(items):
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{m.name}{_prom_labels(key)} {_g(val)}")
                    continue
                count, total, _mn, _mx, buckets = val
                cum = 0
                for i, edge in enumerate(m.edges):  # type: ignore[attr-defined]
                    cum += buckets[i]
                    lines.append(f"{m.name}_bucket{_prom_labels(key, le=_g(edge))} {cum}")
                lines.append(f"{m.name}_bucket{_prom_labels(key, le='+Inf')} {count}")
                lines.append(f"{m.name}_sum{_prom_labels(key)} {_g(total)}")
                lines.append(f"{m.name}_count{_prom_labels(key)} {count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _g(v: float) -> str:
    return f"{float(v):g}"


def _prom_labels(key: _LabelKey, **extra: str) -> str:
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    inner = ",".join('{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\""))
                     for k, v in pairs)
    return f"{{{inner}}}"


#: the process-wide registry the LM server and the KV prefix cache write into
METRICS = MetricsRegistry()
