"""Typed metrics: counters, gauges and histograms, and a registry that
renders the Prometheus text exposition and a structured snapshot.

The port of the JAX package's ``repro.obs.metrics``.  A metric either owns
its state (``inc``, ``set``, ``observe``) or is a callback view that reads a
value (or a stats object) through a closure at collect time; the engine's
registry is all views over its ``EngineStats``, so it copies nothing and a
``reset_stats()`` that rebinds the stats is seen at the next scrape.

Histograms render as the Prometheus *summary* type (quantile labels, _sum,
_count): the serving latencies live in bounded windows of samples
(``LatencyStat``), and quantiles over a window export what they keep.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

QUANTILES = (0.5, 0.9, 0.95, 0.99)


def _fmt(v: float) -> str:
    """A Prometheus sample value: the shortest float repr (ints stay ints)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())) + "}"


class Counter:
    """Monotonic counter; ``fn`` makes it a live view of an outside value."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._fn = fn
        self._value = 0.0  # owned-by: metrics-owner

    def inc(self, n: float = 1.0) -> None:  # thread: metrics-owner
        if self._fn is not None:
            raise TypeError(f"counter {self.name} is a callback view")
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._value += n

    @property
    # analysis: allow(lock:thread) — the scrape's read: a float load is atomic
    # under the interpreter lock and a scrape tolerates one sample's staleness
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def samples(self) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
        return [(self.name, self.labels, self.value)]


class Gauge:
    """Point-in-time value; ``fn`` makes it a live view."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._fn = fn
        self._value = 0.0  # owned-by: metrics-owner

    def set(self, v: float) -> None:  # thread: metrics-owner
        if self._fn is not None:
            raise TypeError(f"gauge {self.name} is a callback view")
        self._value = float(v)

    @property
    # analysis: allow(lock:thread) — the scrape's read: a float load is atomic
    # under the interpreter lock and a scrape tolerates one sample's staleness
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def samples(self) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
        return [(self.name, self.labels, self.value)]


class _WindowStat:
    """A histogram's own state: count and sum forever, a bounded window of
    samples (the ``LatencyStat`` shape, kept here so that obs imports
    nothing of serving)."""

    def __init__(self, window: int):
        self.count = 0  # owned-by: metrics-owner
        self.total = 0.0  # owned-by: metrics-owner
        self._win: deque = deque(maxlen=window)  # owned-by: metrics-owner

    def record(self, v: float) -> None:  # thread: metrics-owner
        self.count += 1
        self.total += float(v)
        self._win.append(float(v))

    # analysis: allow(lock:thread) — the scrape's read: np.asarray(deque)
    # copies under the interpreter lock; quantiles tolerate a stale window
    def percentile(self, q: float) -> float:
        if not self._win:
            return 0.0
        return float(np.percentile(np.asarray(self._win), q))


class Histogram:
    """Quantile summary over a bounded window of samples.  ``source_fn``
    binds it to an outside stats object (with ``count``, ``total`` and
    ``percentile(q)``, e.g. ``LatencyStat``), resolved at every collect."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 window: int = 2048, source_fn: Optional[Callable[[], Any]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._source_fn = source_fn
        self._own = None if source_fn is not None else _WindowStat(window)

    def _src(self):
        return self._source_fn() if self._source_fn is not None else self._own

    def observe(self, v: float) -> None:
        if self._own is None:
            raise TypeError(f"histogram {self.name} is a callback view")
        self._own.record(v)

    def summary(self) -> Dict[str, float]:
        src = self._src()
        out = {"count": float(src.count), "sum": float(src.total)}
        out["mean"] = out["sum"] / out["count"] if out["count"] else 0.0
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = float(src.percentile(q * 100))
        return out

    def samples(self) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
        src = self._src()
        base = dict(self.labels) if self.labels else {}
        rows: List[Tuple[str, Optional[Dict[str, str]], float]] = []
        for q in QUANTILES:
            rows.append((self.name, {**base, "quantile": str(q)}, float(src.percentile(q * 100))))
        rows.append((self.name + "_sum", base or None, float(src.total)))
        rows.append((self.name + "_count", base or None, float(src.count)))
        return rows


class MetricsRegistry:
    """An ordered collection of metrics.  Several metrics may share a name
    (with other labels, e.g. one a tenant); they render under one HELP/TYPE
    block."""

    def __init__(self):
        self._metrics: List[Any] = []
        self._collectors: List[Callable[[], List[Any]]] = []

    def register(self, metric) -> Any:
        self._metrics.append(metric)
        return metric

    def register_collector(self, fn: Callable[[], List[Any]]) -> None:
        """A callable that makes metrics at collect time, for label sets
        that exist only at run time (tenant lanes, reject reasons)."""
        self._collectors.append(fn)

    def counter(self, name: str, help: str = "", **kw) -> Counter:
        return self.register(Counter(name, help, **kw))

    def gauge(self, name: str, help: str = "", **kw) -> Gauge:
        return self.register(Gauge(name, help, **kw))

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self.register(Histogram(name, help, **kw))

    def metrics(self) -> List[Any]:
        out = list(self._metrics)
        for fn in self._collectors:
            out.extend(fn())
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format 0.0.4 (histograms as the
        ``summary`` type)."""
        lines: List[str] = []
        seen_header: set = set()
        for m in self.metrics():
            if m.name not in seen_header:
                seen_header.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                ptype = "summary" if m.kind == "histogram" else m.kind
                lines.append(f"# TYPE {m.name} {ptype}")
            for name, labels, value in m.samples():
                lines.append(f"{name}{_render_labels(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """``{counters: {...}, gauges: {...}, histograms: {...}}``; labeled
        series nest under their label sets."""
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            section = out[m.kind + "s"]
            value = m.summary() if m.kind == "histogram" else m.value
            if m.labels:
                key = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                section.setdefault(m.name, {})[key] = value
            else:
                section[m.name] = value
        return out
