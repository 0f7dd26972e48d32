"""Metrics registry: counters, gauges and histograms with tags and sinks.

The port of ``deepspeed_tpu/telemetry/registry.py``. Every subsystem emits
through a :class:`MetricsRegistry`, which fans out to the sinks attached:
JSONL (append-only, line-buffered) or in-memory (tests and probes). With
no sink attached an emit is one attribute check, so an engine with
telemetry off pays nothing.

A row is ``{tag, value, step, kind, ...tags}``: the reference's schema, so
``tools/serving_report.py`` and ``tools/slo_report.py`` read the port's
files unchanged. The tensorboard sink needs the reference's
``utils/monitor.py``, which is not ported yet; the config refuses it.
"""

import bisect
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.utils.logging import logger


class Sink:
    """Sink interface: receives every metric emission."""

    def emit(self, kind: str, name: str, value: float, step: int,
             tags: Dict[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JSONLSink(Sink):
    """Append-only JSONL rows ``{tag, value, step, kind, ...tags}``,
    line-buffered so a crash loses at most the current line (the
    reference's ``MetricsJSONL`` schema and behaviour)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def emit(self, kind, name, value, step, tags):
        with self._lock:
            if self._f.closed:
                return
            row = {"tag": name, "value": float(value), "step": int(step),
                   "kind": kind}
            row.update(tags)
            self._f.write(json.dumps(row) + "\n")

    def flush(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


class InMemorySink(Sink):
    """Keeps every emission as a dict row: the test and probe sink."""

    def __init__(self):
        self.rows: List[Dict[str, Any]] = []

    def emit(self, kind, name, value, step, tags):
        row = {"kind": kind, "tag": name, "value": float(value),
               "step": int(step)}
        row.update(tags)
        self.rows.append(row)

    def values(self, name: str) -> List[float]:
        return [r["value"] for r in self.rows if r["tag"] == name]

    def tags(self) -> set:
        return {r["tag"] for r in self.rows}


class _Metric:
    def __init__(self, registry: "MetricsRegistry", name: str,
                 tags: Optional[Dict[str, Any]] = None):
        self._registry = registry
        self.name = name
        self.tags = dict(tags or {})


class Counter(_Metric):
    """Monotonic count; emits the running total, so the newest row is the
    current value."""

    def __init__(self, registry, name, tags=None):
        super().__init__(registry, name, tags)
        self.total = 0.0

    def inc(self, n: float = 1.0, step: Optional[int] = None, **tags) -> None:
        self.total += n
        self._registry._emit("counter", self.name, self.total, step,
                             {**self.tags, **tags})


class Gauge(_Metric):
    """Point-in-time value."""

    def __init__(self, registry, name, tags=None):
        super().__init__(registry, name, tags)
        self.value: Optional[float] = None

    def set(self, value: float, step: Optional[int] = None, **tags) -> None:
        self.value = float(value)
        self._registry._emit("gauge", self.name, self.value, step,
                             {**self.tags, **tags})


class Histogram(_Metric):
    """Distribution: every observation is emitted, and a bounded sorted
    reservoir keeps percentiles queryable on the host."""

    def __init__(self, registry, name, tags=None, max_samples: int = 4096):
        super().__init__(registry, name, tags)
        self._sorted: List[float] = []
        self._max = int(max_samples)
        self.count = 0

    def observe(self, value: float, step: Optional[int] = None,
                **tags) -> None:
        value = float(value)
        self.count += 1
        if len(self._sorted) < self._max:
            bisect.insort(self._sorted, value)
        self._registry._emit("histogram", self.name, value, step,
                             {**self.tags, **tags})

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation over the reservoir."""
        if not self._sorted:
            raise ValueError(f"histogram {self.name!r} has no observations")
        s = self._sorted
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def percentiles(self, qs: Sequence[float]) -> Tuple[float, ...]:
        return tuple(self.percentile(q) for q in qs)

    def reset(self) -> None:
        """Drop the host-side reservoir (rows already emitted stay)."""
        self._sorted.clear()
        self.count = 0


class MetricsRegistry:
    """Named metrics and their fan-out to sinks. Thread-safe."""

    def __init__(self, sinks: Optional[Iterable[Sink]] = None):
        self._sinks: List[Sink] = list(sinks or [])
        self._metrics: Dict[Tuple[str, str], Any] = {}
        self._lock = threading.Lock()
        self._step = 0

    def add_sink(self, sink: Sink) -> Sink:
        self._sinks.append(sink)
        return sink

    @property
    def sinks(self) -> List[Sink]:
        return list(self._sinks)

    def _get(self, kind: str, cls, name: str, **kw):
        key = (kind, name)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(self, name, **kw)
            return m

    def counter(self, name: str, **kw) -> Counter:
        return self._get("counter", Counter, name, **kw)

    def gauge(self, name: str, **kw) -> Gauge:
        return self._get("gauge", Gauge, name, **kw)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get("histogram", Histogram, name, **kw)

    def set_step(self, step: int) -> None:
        """Default step stamped on emissions that pass none."""
        self._step = int(step)

    def _emit(self, kind: str, name: str, value: float,
              step: Optional[int], tags: Dict[str, Any]) -> None:
        if not self._sinks:
            return
        step = self._step if step is None else int(step)
        with self._lock:
            for sink in self._sinks:
                try:
                    sink.emit(kind, name, value, step, tags)
                except Exception as e:  # noqa: BLE001 - a broken sink must
                    # not take down the loop it observes
                    logger.warning("telemetry sink %s failed on %s: %s",
                                   type(sink).__name__, name, e)

    def add_scalar(self, tag: str, value: float, step: int, **extra) -> None:
        """Gauge semantics under the monitor's ``add_scalar`` signature."""
        self.gauge(tag).set(value, step=step, **extra)

    def flush(self) -> None:
        with self._lock:
            for sink in self._sinks:
                sink.flush()

    def close(self) -> None:
        with self._lock:
            for sink in self._sinks:
                sink.close()
            self._sinks = []
