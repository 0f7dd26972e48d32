"""Telemetry of the port, behind one facade.

The port of ``deepspeed_tpu/telemetry/__init__.py``, as far as serving and
the training engine need it:

- :class:`MetricsRegistry`: counters, gauges and histograms with tags, fanned
  out to JSONL and in-memory sinks;
- :class:`StepTracer`: Chrome trace-event spans, with device syncs only when
  the tracer is on and ``sync_spans`` asks for them;
- :class:`RecompileDetector`: the first call of a step at a new input
  signature;
- :class:`RequestAccountant`: the per-request SLO ledger and the engine's
  serving-time partition;
- :class:`GoodputAccountant`: training's wall-clock attribution, MFU and
  run manifests;
- :class:`NumericsObservatory`: training's per-layer-group statistics.

``build_telemetry(config.telemetry)`` wires the first three from the
``telemetry`` block; a disabled block yields the same facade with every
path a no-op (no sinks, a reusable null span, detector off), so call sites
never branch on "is telemetry on". ``build_training_telemetry`` adds
numerics and goodput for the training engine, each ``None`` when off, as
the reference's engine wires them. The memory observatory (but for its
crash-dump helpers, ``telemetry/memory.py``), device time, the fleet
aggregator and MoE telemetry are not ported yet.
"""

import os
from typing import Optional

from deepspeed_tpu_torch.telemetry.fleet import (default_host,
                                                 host_scoped_path,
                                                 telemetry_host_component)
from deepspeed_tpu_torch.telemetry.goodput import (GOODPUT_METRIC_TAGS,
                                                   GoodputAccountant,
                                                   build_goodput, card_info,
                                                   config_hash)
from deepspeed_tpu_torch.telemetry.goodput import \
    CATEGORIES as GOODPUT_CATEGORIES
from deepspeed_tpu_torch.telemetry.memory import collect_memory_snapshot
from deepspeed_tpu_torch.telemetry.numerics import (NUMERICS_METRIC_TAGS,
                                                    NumericsObservatory,
                                                    NumericsPlan,
                                                    build_numerics)
from deepspeed_tpu_torch.telemetry.recompile import (RECOMPILE_COUNTER,
                                                     RecompileDetector,
                                                     tree_signature)
from deepspeed_tpu_torch.telemetry.registry import (Counter, Gauge,
                                                    Histogram, InMemorySink,
                                                    JSONLSink,
                                                    MetricsRegistry, Sink)
from deepspeed_tpu_torch.telemetry.requests import (ENGINE_CATEGORIES,
                                                    REQUEST_CATEGORIES,
                                                    REQUEST_METRIC_TAGS,
                                                    RequestAccountant,
                                                    build_requests)
from deepspeed_tpu_torch.telemetry.tracer import StepTracer

__all__ = [
    "Counter", "ENGINE_CATEGORIES", "GOODPUT_CATEGORIES",
    "GOODPUT_METRIC_TAGS", "Gauge", "GoodputAccountant", "Histogram",
    "InMemorySink", "JSONLSink", "MetricsRegistry", "NUMERICS_METRIC_TAGS",
    "NumericsObservatory", "NumericsPlan", "RECOMPILE_COUNTER",
    "REQUEST_CATEGORIES", "REQUEST_METRIC_TAGS", "RecompileDetector",
    "RequestAccountant", "Sink", "StepTracer", "Telemetry",
    "build_goodput", "build_numerics", "build_requests", "build_telemetry",
    "build_training_telemetry", "collect_memory_snapshot", "default_host",
    "host_scoped_path", "null_telemetry", "telemetry_host_component",
    "tree_signature",
]


class Telemetry:
    """The facade the engines hold: ``.registry``, ``.tracer``,
    ``.recompile`` and passthroughs."""

    def __init__(self, registry: MetricsRegistry, tracer: StepTracer,
                 recompile: RecompileDetector, enabled: bool = True):
        self.registry = registry
        self.tracer = tracer
        self.recompile = recompile
        self.enabled = bool(enabled)
        # the JSONL sink's path (None without one)
        self.metrics_path = next(
            (s.path for s in registry.sinks if isinstance(s, JSONLSink)),
            None)

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def check_recompile(self, fn_name: str, *trees,
                        step: Optional[int] = None) -> str:
        return self.recompile.check(fn_name, *trees, step=step)

    def instant(self, name: str, **args) -> None:
        self.tracer.instant(name, **args)

    def set_step(self, step: int) -> None:
        self.registry.set_step(step)

    def flush(self) -> None:
        self.registry.flush()
        self.tracer.flush()

    def close(self) -> None:
        try:
            self.tracer.close()
        finally:
            self.registry.close()


def null_telemetry() -> Telemetry:
    """A fully disabled facade (no sinks, no trace, detector off)."""
    return Telemetry(MetricsRegistry(), StepTracer(enabled=False),
                     RecompileDetector(enabled=False), enabled=False)


def build_telemetry(tcfg, device=None) -> Telemetry:
    """Build the facade from a parsed ``TelemetryConfig``. ``device``: the
    device whose work the tracer's sync spans wait for (None: the CPU).

    Across processes the metrics and trace files gain a ``.<host>.``
    component; a single process keeps the bare names."""
    if tcfg is None or not tcfg.enabled:
        return null_telemetry()
    host_part = telemetry_host_component()
    registry = MetricsRegistry()
    for sink_name in tcfg.metrics.sinks:
        if sink_name == "jsonl":
            registry.add_sink(JSONLSink(os.path.join(
                tcfg.dir, host_scoped_path(tcfg.metrics.file, host_part))))
        elif sink_name == "memory":
            registry.add_sink(InMemorySink())
    tracer = StepTracer(
        path=(os.path.join(tcfg.dir,
                           host_scoped_path(tcfg.trace.file, host_part))
              if tcfg.trace.enabled else None),
        sync_spans=tcfg.trace.sync_spans,
        jax_profiler_dir=tcfg.trace.jax_profiler_dir,
        host=host_part or default_host(), device=device)
    recompile = RecompileDetector(registry=registry, tracer=tracer,
                                  enabled=tcfg.recompile_detection)
    return Telemetry(registry, tracer, recompile, enabled=True)


def build_training_telemetry(tcfg, device, param_names, compute_dtype=None,
                             param_dict=None):
    """The training engine's telemetry: ``(telemetry, numerics, goodput)``.
    The facade as :func:`build_telemetry` builds it; the numerics
    observatory over ``param_names`` (statistics against
    ``compute_dtype``), attached to it; the goodput accountant with the
    config's hash (of ``param_dict``) and, on a card, its name and power
    limit. A block that is off gives ``None`` for each of the last two."""
    tel = build_telemetry(tcfg, device=device)
    numerics = build_numerics(tcfg, param_names, compute_dtype=compute_dtype)
    if numerics is not None:
        numerics.attach(tel)
    goodput = None
    if tcfg is not None and tcfg.enabled and tcfg.goodput:
        goodput = build_goodput(tcfg, telemetry=tel,
                                cfg_hash=config_hash(param_dict),
                                card=card_info(device))
    return tel, numerics, goodput
