"""Step tracer: Chrome trace-event spans of the serving and inference
steps.

The port of ``deepspeed_tpu/telemetry/tracer.py``. It records named spans
(``prefill``, ``decode_step``, ``mixed_step``, ``spec_step``, ...), instant
and counter events and async request tracks as Chrome trace-event JSON,
which Perfetto and ``chrome://tracing`` open directly.

Span semantics on the card: kernel launches are asynchronous, so a span
around them measures what the host enqueued unless the step ends in a host
fetch. With ``sync_spans`` on (the default of an enabled tracer) every span
boundary waits for the device through ``utils/timer._device_synchronize``,
so a span brackets exactly the device work issued inside it. A disabled
tracer's ``span()`` is a reusable no-op that makes no sync and no
allocation.

``jax_profiler_dir`` (the reference's config key, kept so a reference
config runs unchanged) starts a ``torch.profiler`` capture beside the
spans: CPU activity, and CUDA activity when the tracer's device is the
card, exported at ``close()`` as a Chrome trace into that directory.
"""

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

# The file the torch.profiler capture is exported to, in its directory.
PROFILER_TRACE_FILE = "torch_profiler_trace.json"


def _device_sync(device) -> None:
    """Wait for the device through the package's one sync primitive
    (tests count calls by patching it)."""
    from deepspeed_tpu_torch.utils import timer as _timer

    _timer._device_synchronize(device)


class _NullSpan:
    """Reusable no-op context manager of the disabled tracer."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "duration")

    def __init__(self, tracer: "StepTracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self.duration = 0.0

    def __enter__(self):
        if self._tracer.sync_spans:
            _device_sync(self._tracer.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._tracer.sync_spans:
            _device_sync(self._tracer.device)
        t1 = time.perf_counter()
        self.duration = t1 - self._t0
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class StepTracer:
    """Chrome trace-event recorder. Thread-safe and bounded: at most
    ``max_events`` events are held (the oldest are dropped first;
    ``dropped_events`` counts them and the saved trace carries the count).
    ``save()`` is skipped when nothing was recorded since the last one.

    ``device``: the device the spans wait for under ``sync_spans`` (None:
    the CPU, where the wait does nothing).
    """

    def __init__(self, path: Optional[str] = None,
                 enabled: Optional[bool] = None, sync_spans: bool = True,
                 jax_profiler_dir: Optional[str] = None,
                 max_events: int = 200_000, host: Optional[str] = None,
                 device=None):
        self.path = path
        self.enabled = bool(path) if enabled is None else bool(enabled)
        # sync barriers need an enabled tracer: disabled telemetry is free
        self.sync_spans = bool(sync_spans) and self.enabled
        self.jax_profiler_dir = jax_profiler_dir
        self.host = host
        self.device = device
        self._events = collections.deque(maxlen=int(max_events))
        self.dropped_events = 0
        self._dirty = False
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        # wall-clock anchor of ts = 0, saved in the trace's metadata
        self._epoch_wall = time.time()
        self._pid = os.getpid()
        self._profiler = None
        self._profiler_dir: Optional[str] = None
        self._atexit_registered = False
        if self.enabled:
            self._meta("process_name", {"name": "deepspeed_tpu_torch"})
            if jax_profiler_dir:
                self.start_profiler()

    def _append(self, ev: Dict[str, Any]) -> None:
        """Caller holds the lock."""
        if len(self._events) == self._events.maxlen:
            self.dropped_events += 1
        self._events.append(ev)
        self._dirty = True

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _meta(self, name: str, args: Dict[str, Any]) -> None:
        with self._lock:
            self._append({"name": name, "ph": "M", "pid": self._pid,
                          "tid": threading.get_ident(), "args": args})

    def _record(self, name: str, t0: float, t1: float,
                args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": threading.get_ident(), "ts": self._us(t0),
              "dur": (t1 - t0) * 1e6}
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    # -- public API -----------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing the enclosed region (a no-op when
        disabled); the handle's ``.duration`` (seconds) is set on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": self._us(time.perf_counter())}
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    def counter(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._append({
                "name": name, "ph": "C", "pid": self._pid,
                "tid": threading.get_ident(),
                "ts": self._us(time.perf_counter()),
                "args": {"value": float(value)}})

    def _async(self, ph: str, name: str, aid, cat: str,
               args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": ph, "cat": cat, "id": str(aid),
              "pid": self._pid, "tid": threading.get_ident(),
              "ts": self._us(time.perf_counter())}
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    def async_begin(self, name: str, aid, cat: str = "request",
                    **args) -> None:
        """Open an async-track span (Chrome ``ph: b``) on its own (cat, id)
        track, so a request's queue -> prefill -> decode arc renders beside
        the step spans. Pair with :meth:`async_end`."""
        if not self.enabled:
            return
        self._async("b", name, aid, cat, args)

    def async_end(self, name: str, aid, cat: str = "request",
                  **args) -> None:
        if not self.enabled:
            return
        self._async("e", name, aid, cat, args)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> set:
        with self._lock:
            return {e["name"] for e in self._events if e.get("ph") == "X"}

    # -- torch.profiler capture -----------------------------------------
    @property
    def profiler_active(self) -> bool:
        return self._profiler is not None

    @staticmethod
    def host_scoped_profile_dir(target: str) -> str:
        """A per-host subdirectory when the run spans processes (or
        ``DSTPU_TELEMETRY_HOST`` forces it); the directory itself
        otherwise."""
        from deepspeed_tpu_torch.telemetry.fleet import \
            telemetry_host_component

        part = telemetry_host_component()
        return os.path.join(target, part) if part else target

    def start_profiler(self, dir: Optional[str] = None) -> Optional[str]:
        """Start a ``torch.profiler`` capture that ``stop_profiler`` exports
        into ``dir`` (default: ``jax_profiler_dir``). Returns the
        host-scoped directory, or None (already active, no directory, or
        the profiler is unavailable)."""
        target = dir or self.jax_profiler_dir
        if self._profiler is not None or not target:
            return None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            target = self.host_scoped_profile_dir(target)
            os.makedirs(target, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self.device is not None \
                    and torch.device(self.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 - the capture is best-effort
            logger.warning("torch.profiler capture unavailable: %s", e)
            return None
        self._profiler = prof
        self._profiler_dir = target
        # stop the capture even when a crash skips close(); stopping twice
        # is a no-op
        if not self._atexit_registered:
            import atexit

            atexit.register(self.stop_profiler)
            self._atexit_registered = True
        return target

    def stop_profiler(self) -> Optional[str]:
        """Stop the active capture and export it as a Chrome trace
        (``PROFILER_TRACE_FILE`` in its directory). Idempotent; returns the
        file written, or None when nothing was active."""
        prof, d = self._profiler, self._profiler_dir
        if prof is None:
            return None
        self._profiler = None
        self._profiler_dir = None
        path = os.path.join(d, PROFILER_TRACE_FILE)
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - the capture is best-effort
            logger.warning("torch.profiler export to %s failed: %s", path, e)
            return None
        return path

    # -- persistence ----------------------------------------------------
    def save(self) -> Optional[str]:
        """Write the trace file (atomic rename); a no-op when nothing was
        recorded since the last write."""
        if not self.enabled or not self.path:
            return None
        with self._lock:
            if not self._dirty:
                return self.path
            events = list(self._events)
            dropped = self.dropped_events
            self._dirty = False
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"wall_epoch": self._epoch_wall,
                            "host": self.host}}
        if dropped:
            doc["metadata"]["dropped_events"] = dropped
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        return self.path

    flush = save

    def close(self) -> None:
        try:
            self.stop_profiler()
        finally:
            self.save()
