"""Parsed configs of the port: ``DeepSpeedConfig`` (training),
``ServingConfig``, ``TelemetryConfig`` (serving) and ``ConfigError``.

Held to the walls of ``deepspeed_tpu/config/config.py``. A key the port has
no feature for yet raises a ``ConfigError`` that names it and says "not yet
ported"; an unknown key raises too. Nothing is ignored.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from deepspeed_tpu_torch.config import constants as C


class ConfigError(ValueError):
    pass


def not_yet_ported(what: str) -> ConfigError:
    return ConfigError(f"{what} is not yet ported to deepspeed_tpu_torch")


def _get(d: Dict[str, Any], key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v is None else v


def _as_block(value: Any, what: str) -> Dict[str, Any]:
    """A sub-block as the reference reads it: a falsy value is an empty
    block; a truthy value that is not a dict raises."""
    value = value or {}
    if not isinstance(value, dict):
        raise ConfigError(f"{what} must be a dict")
    return value


def _flag(block: Dict[str, Any], key: str) -> bool:
    """``bool(block[key])`` with None read as False (the reference's
    ``_get(d, key, False)``)."""
    return bool(_get(block, key, False))


_KNOWN_SERVING_KEYS = frozenset({
    C.SERVING_MAX_BATCH_SIZE, C.SERVING_KV_BLOCK_SIZE,
    C.SERVING_KV_NUM_BLOCKS, C.SERVING_INT8_KV_CACHE,
    C.SERVING_MAX_MODEL_LEN, C.SERVING_MAX_PREFILLS_PER_STEP,
    C.SERVING_EOS_TOKEN_ID, C.SERVING_TEMPERATURE, C.SERVING_TOP_K,
    C.SERVING_SEED, C.SERVING_DECODE_ATTENTION, C.SERVING_PREFIX_CACHE,
    C.SERVING_SPECULATIVE, C.SERVING_RESILIENCE, C.SERVING_CHUNKED_PREFILL,
})


@dataclass
class ServingConfig:
    """``serving`` block: the continuous-batching serving engine.

    ``max_batch_size``: decode slots. ``kv_block_size`` / ``kv_num_blocks``:
    the paged KV pool geometry; capacity is ``(kv_num_blocks - 1) *
    kv_block_size`` positions (block 0 is reserved scratch).
    ``max_model_len``: per-sequence prompt + output cap (defaults to the
    model's max_seq_len). ``max_prefills_per_step``: prefills admitted per
    decode boundary. ``temperature`` / ``top_k`` / ``seed``: sampling
    (0.0 = greedy). ``decode_attention``: gather | auto | kernel.
    ``int8_kv_cache``: int8 K/V pools with per-(token, head) fp32 scales.
    ``prefix_cache``: share full prompt-head blocks between requests.
    ``chunked_prefill`` / ``chunked_token_budget``: chunked-prefill
    admission, at most ``chunked_token_budget`` tokens per mixed step.
    ``spec_decode`` / ``spec_k`` / ``spec_draft_layers``: speculative
    decoding, ``k`` draft tokens a round from the target's first
    ``draft_layers`` layers (None: half of them); greedy only.
    ``resilience`` and the ``resil_*`` fields: deadlines and ``cancel``,
    the admission gate (``max_queue_depth``, ``max_queue_wait_ms``),
    decode recovery (``max_retries``, ``retry_base_sec``) and the
    degradation ladder (``degrade_after`` anomalies a rung;
    ``slow_step_ms`` marks a slow decode step as one).
    """

    max_batch_size: int = C.SERVING_MAX_BATCH_SIZE_DEFAULT
    kv_block_size: int = C.SERVING_KV_BLOCK_SIZE_DEFAULT
    kv_num_blocks: int = C.SERVING_KV_NUM_BLOCKS_DEFAULT
    max_model_len: Optional[int] = None
    max_prefills_per_step: int = C.SERVING_MAX_PREFILLS_PER_STEP_DEFAULT
    eos_token_id: Optional[int] = None
    temperature: float = C.SERVING_TEMPERATURE_DEFAULT
    top_k: int = C.SERVING_TOP_K_DEFAULT
    seed: int = C.SERVING_SEED_DEFAULT
    decode_attention: str = C.SERVING_DECODE_ATTENTION_DEFAULT
    int8_kv_cache: bool = C.SERVING_INT8_KV_CACHE_DEFAULT
    prefix_cache: bool = C.SERVING_PREFIX_CACHE_DEFAULT
    chunked_prefill: bool = False
    chunked_token_budget: int = C.SERVING_CHUNKED_TOKEN_BUDGET_DEFAULT
    spec_decode: bool = False
    spec_k: int = C.SERVING_SPEC_K_DEFAULT
    spec_draft_layers: Optional[int] = None
    resilience: bool = False
    resil_max_queue_depth: Optional[int] = None
    resil_max_queue_wait_ms: Optional[float] = None
    resil_default_deadline_ms: Optional[float] = None
    resil_max_retries: int = C.SERVING_RESIL_MAX_RETRIES_DEFAULT
    resil_retry_base_sec: float = C.SERVING_RESIL_RETRY_BASE_SEC_DEFAULT
    resil_degrade_after: int = C.SERVING_RESIL_DEGRADE_AFTER_DEFAULT
    resil_slow_step_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ConfigError("serving.max_batch_size must be >= 1")
        if self.kv_block_size < 1:
            raise ConfigError("serving.kv_block_size must be >= 1")
        if self.kv_num_blocks < 2:
            raise ConfigError(
                "serving.kv_num_blocks must be >= 2 (block 0 is reserved "
                "as the scratch block for inactive slots)")
        if self.max_model_len is not None and self.max_model_len < 1:
            raise ConfigError("serving.max_model_len must be >= 1")
        if self.max_prefills_per_step < 1:
            raise ConfigError("serving.max_prefills_per_step must be >= 1")
        if self.temperature < 0:
            raise ConfigError("serving.temperature must be >= 0")
        if self.top_k < 0:
            raise ConfigError("serving.top_k must be >= 0")
        if self.decode_attention not in C.SERVING_DECODE_ATTENTION_CHOICES:
            raise ConfigError(
                f"serving.decode_attention must be one of "
                f"{C.SERVING_DECODE_ATTENTION_CHOICES}, got "
                f"{self.decode_attention!r}")
        if self.chunked_token_budget < self.max_batch_size:
            raise ConfigError(
                "serving.chunked_prefill.token_budget must be >= "
                "max_batch_size (every decoding slot needs a row in each "
                "mixed step)")
        if self.chunked_prefill and self.temperature != 0.0:
            raise ConfigError(
                "serving.chunked_prefill requires temperature == 0 "
                "(greedy): the contract with the bucketed path is token "
                "identity")
        if self.spec_k < 1:
            raise ConfigError("serving.speculative.k must be >= 1")
        if self.spec_draft_layers is not None and self.spec_draft_layers < 1:
            raise ConfigError(
                "serving.speculative.draft_layers must be >= 1")
        if self.spec_decode and self.temperature != 0.0:
            raise ConfigError(
                "serving.speculative requires temperature == 0 (greedy): "
                "the accept rule's contract is token identity with greedy "
                "decode")
        for key, lo, strict in (
                ("max_queue_depth", 1, False),
                ("max_queue_wait_ms", 0, True),
                ("default_deadline_ms", 0, True),
                ("max_retries", 0, False),
                ("retry_base_sec", 0, True),
                ("degrade_after", 1, False),
                ("slow_step_ms", 0, True)):
            v = getattr(self, f"resil_{key}")
            if v is not None and (v <= lo if strict else v < lo):
                raise ConfigError(f"serving.resilience.{key} must be "
                                  f"{'>' if strict else '>='} {lo}")

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        d = d or {}
        unknown = set(d) - _KNOWN_SERVING_KEYS
        if unknown:
            raise ConfigError(
                f"unknown serving keys {sorted(unknown)}; expected a subset "
                f"of {sorted(_KNOWN_SERVING_KEYS)}")
        # as the reference parses them: speculative decoding is on only
        # with ``enabled: true``; resilience with ``enabled: true`` or,
        # without ``enabled``, for a non-empty block
        spec = _as_block(d.get(C.SERVING_SPECULATIVE),
                         f"serving.{C.SERVING_SPECULATIVE}")
        resil = _as_block(d.get(C.SERVING_RESILIENCE),
                          f"serving.{C.SERVING_RESILIENCE}")
        unknown = set(resil) - C.SERVING_RESILIENCE_KEYS
        if unknown:
            raise ConfigError(
                f"unknown serving.resilience keys {sorted(unknown)}; "
                f"expected a subset of {sorted(C.SERVING_RESILIENCE_KEYS)}")

        def opt(block, key, cast):
            return cast(block[key]) if block.get(key) is not None else None

        # as the reference parses it: a present key (even a falsy one,
        # read as an empty block) turns chunked prefill on by default
        chunked = d.get(C.SERVING_CHUNKED_PREFILL)
        present = chunked is not None
        chunked = chunked or {}
        if not isinstance(chunked, dict):
            raise ConfigError("serving.chunked_prefill must be a dict")
        known_chunked = {C.SERVING_CHUNKED_ENABLED,
                         C.SERVING_CHUNKED_TOKEN_BUDGET}
        unknown = set(chunked) - known_chunked
        if unknown:
            raise ConfigError(
                f"unknown serving.chunked_prefill keys {sorted(unknown)}; "
                f"expected a subset of {sorted(known_chunked)}")
        return cls(
            max_batch_size=int(_get(d, C.SERVING_MAX_BATCH_SIZE,
                                    C.SERVING_MAX_BATCH_SIZE_DEFAULT)),
            kv_block_size=int(_get(d, C.SERVING_KV_BLOCK_SIZE,
                                   C.SERVING_KV_BLOCK_SIZE_DEFAULT)),
            kv_num_blocks=int(_get(d, C.SERVING_KV_NUM_BLOCKS,
                                   C.SERVING_KV_NUM_BLOCKS_DEFAULT)),
            max_model_len=(int(d[C.SERVING_MAX_MODEL_LEN])
                           if d.get(C.SERVING_MAX_MODEL_LEN) is not None
                           else None),
            max_prefills_per_step=int(_get(
                d, C.SERVING_MAX_PREFILLS_PER_STEP,
                C.SERVING_MAX_PREFILLS_PER_STEP_DEFAULT)),
            eos_token_id=(int(d[C.SERVING_EOS_TOKEN_ID])
                          if d.get(C.SERVING_EOS_TOKEN_ID) is not None
                          else None),
            temperature=float(_get(d, C.SERVING_TEMPERATURE,
                                   C.SERVING_TEMPERATURE_DEFAULT)),
            top_k=int(_get(d, C.SERVING_TOP_K, C.SERVING_TOP_K_DEFAULT)),
            seed=int(_get(d, C.SERVING_SEED, C.SERVING_SEED_DEFAULT)),
            decode_attention=str(_get(d, C.SERVING_DECODE_ATTENTION,
                                      C.SERVING_DECODE_ATTENTION_DEFAULT)),
            int8_kv_cache=bool(_get(d, C.SERVING_INT8_KV_CACHE,
                                    C.SERVING_INT8_KV_CACHE_DEFAULT)),
            prefix_cache=bool(_get(d, C.SERVING_PREFIX_CACHE,
                                   C.SERVING_PREFIX_CACHE_DEFAULT)),
            # a present block defaults to enabled
            chunked_prefill=bool(chunked.get(
                C.SERVING_CHUNKED_ENABLED, present)),
            chunked_token_budget=int(_get(
                chunked, C.SERVING_CHUNKED_TOKEN_BUDGET,
                C.SERVING_CHUNKED_TOKEN_BUDGET_DEFAULT)),
            spec_decode=bool(spec.get(C.SUB_BLOCK_ENABLED, False)),
            spec_k=int(spec.get(C.SERVING_SPEC_K, C.SERVING_SPEC_K_DEFAULT)),
            spec_draft_layers=opt(spec, C.SERVING_SPEC_DRAFT_LAYERS, int),
            resilience=bool(resil.get(C.SUB_BLOCK_ENABLED, bool(resil))),
            resil_max_queue_depth=opt(resil, C.SERVING_RESIL_MAX_QUEUE_DEPTH,
                                      int),
            resil_max_queue_wait_ms=opt(
                resil, C.SERVING_RESIL_MAX_QUEUE_WAIT_MS, float),
            resil_default_deadline_ms=opt(
                resil, C.SERVING_RESIL_DEFAULT_DEADLINE_MS, float),
            resil_max_retries=int(resil.get(
                C.SERVING_RESIL_MAX_RETRIES,
                C.SERVING_RESIL_MAX_RETRIES_DEFAULT)),
            resil_retry_base_sec=float(resil.get(
                C.SERVING_RESIL_RETRY_BASE_SEC,
                C.SERVING_RESIL_RETRY_BASE_SEC_DEFAULT)),
            resil_degrade_after=int(resil.get(
                C.SERVING_RESIL_DEGRADE_AFTER,
                C.SERVING_RESIL_DEGRADE_AFTER_DEFAULT)),
            resil_slow_step_ms=opt(resil, C.SERVING_RESIL_SLOW_STEP_MS,
                                   float),
        )


def _telemetry_block(d: Any, what: str, known) -> Dict[str, Any]:
    """A telemetry (sub-)block as the reference reads it (a falsy value is
    an empty block), with the port's wall: an unknown key raises."""
    d = _as_block(d, what)
    unknown = set(d) - set(known)
    if unknown:
        raise ConfigError(f"unknown {what} keys {sorted(unknown)}; expected "
                          f"a subset of {sorted(known)}")
    return d


@dataclass
class TelemetryTraceConfig:
    """Step tracer knobs (telemetry/tracer.py). ``jax_profiler_dir`` keeps
    the reference's name: in the port it is a ``torch.profiler`` capture
    directory."""

    enabled: bool = C.TELEMETRY_TRACE_ENABLED_DEFAULT
    file: str = C.TELEMETRY_TRACE_FILE_DEFAULT
    sync_spans: bool = C.TELEMETRY_TRACE_SYNC_SPANS_DEFAULT
    jax_profiler_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryTraceConfig":
        d = _telemetry_block(d, "telemetry.trace", (
            C.TELEMETRY_TRACE_ENABLED, C.TELEMETRY_TRACE_FILE,
            C.TELEMETRY_TRACE_SYNC_SPANS,
            C.TELEMETRY_TRACE_JAX_PROFILER_DIR))
        return cls(
            enabled=bool(_get(d, C.TELEMETRY_TRACE_ENABLED,
                              C.TELEMETRY_TRACE_ENABLED_DEFAULT)),
            file=str(_get(d, C.TELEMETRY_TRACE_FILE,
                          C.TELEMETRY_TRACE_FILE_DEFAULT)),
            sync_spans=bool(_get(d, C.TELEMETRY_TRACE_SYNC_SPANS,
                                 C.TELEMETRY_TRACE_SYNC_SPANS_DEFAULT)),
            jax_profiler_dir=d.get(C.TELEMETRY_TRACE_JAX_PROFILER_DIR))


@dataclass
class TelemetryMetricsConfig:
    """Metrics registry sinks (telemetry/registry.py)."""

    sinks: tuple = C.TELEMETRY_METRICS_SINKS_DEFAULT
    file: str = C.TELEMETRY_METRICS_FILE_DEFAULT

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryMetricsConfig":
        d = _telemetry_block(d, "telemetry.metrics", (
            C.TELEMETRY_METRICS_SINKS, C.TELEMETRY_METRICS_FILE))
        sinks = tuple(_get(d, C.TELEMETRY_METRICS_SINKS,
                           C.TELEMETRY_METRICS_SINKS_DEFAULT))
        for s in sinks:
            if s not in C.TELEMETRY_METRICS_VALID_SINKS:
                raise ConfigError(
                    f"telemetry.metrics.sinks: unknown sink {s!r} (valid: "
                    f"{list(C.TELEMETRY_METRICS_VALID_SINKS)})")
        return cls(sinks=sinks,
                   file=str(_get(d, C.TELEMETRY_METRICS_FILE,
                                 C.TELEMETRY_METRICS_FILE_DEFAULT)))


def _pattern_file(value: str, prefix: str, ext: str, what: str,
                  reader: str) -> None:
    """Files the stdlib-only report tools discover by pattern must match
    it, or they would be written and never read."""
    if not (value.startswith(prefix) and value.endswith(ext)):
        raise ConfigError(f"{what} must match '{prefix}*{ext}' ({reader} "
                          f"discovers it by that pattern), got '{value}'")


@dataclass
class TelemetryFleetConfig:
    """``telemetry.fleet``: parsed and checked as the reference does; the
    fleet aggregator is not ported yet (refused when on)."""

    enabled: bool = C.TELEMETRY_FLEET_ENABLED_DEFAULT
    window: int = C.TELEMETRY_FLEET_WINDOW_DEFAULT
    min_window: int = C.TELEMETRY_FLEET_MIN_WINDOW_DEFAULT
    zscore: float = C.TELEMETRY_FLEET_ZSCORE_DEFAULT
    persist: int = C.TELEMETRY_FLEET_PERSIST_DEFAULT
    breakdown_file: str = C.TELEMETRY_FLEET_BREAKDOWN_FILE_DEFAULT

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryFleetConfig":
        d = _telemetry_block(d, "telemetry.fleet", (
            C.TELEMETRY_FLEET_ENABLED, C.TELEMETRY_FLEET_WINDOW,
            C.TELEMETRY_FLEET_MIN_WINDOW, C.TELEMETRY_FLEET_ZSCORE,
            C.TELEMETRY_FLEET_PERSIST, C.TELEMETRY_FLEET_BREAKDOWN_FILE))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_FLEET_ENABLED,
                              C.TELEMETRY_FLEET_ENABLED_DEFAULT)),
            window=int(_get(d, C.TELEMETRY_FLEET_WINDOW,
                            C.TELEMETRY_FLEET_WINDOW_DEFAULT)),
            min_window=int(_get(d, C.TELEMETRY_FLEET_MIN_WINDOW,
                                C.TELEMETRY_FLEET_MIN_WINDOW_DEFAULT)),
            zscore=float(_get(d, C.TELEMETRY_FLEET_ZSCORE,
                              C.TELEMETRY_FLEET_ZSCORE_DEFAULT)),
            persist=int(_get(d, C.TELEMETRY_FLEET_PERSIST,
                             C.TELEMETRY_FLEET_PERSIST_DEFAULT)),
            breakdown_file=str(_get(d, C.TELEMETRY_FLEET_BREAKDOWN_FILE,
                                    C.TELEMETRY_FLEET_BREAKDOWN_FILE_DEFAULT)))
        if cfg.min_window < 1 or cfg.window < cfg.min_window:
            raise ConfigError(
                f"telemetry.fleet: need window >= min_window >= 1, got "
                f"window={cfg.window} min_window={cfg.min_window}")
        if cfg.zscore <= 0:
            raise ConfigError(
                f"telemetry.fleet.zscore must be positive, got {cfg.zscore}")
        if cfg.persist < 1:
            raise ConfigError(
                f"telemetry.fleet.persist must be >= 1, got {cfg.persist}")
        _pattern_file(cfg.breakdown_file, "fleet_breakdown", ".json",
                      "telemetry.fleet.breakdown_file",
                      "tools/fleet_report.py")
        return cfg


@dataclass
class TelemetryMemoryConfig:
    """``telemetry.memory``: parsed and checked as the reference does; the
    memory observatory is not ported yet (refused when on)."""

    enabled: bool = C.TELEMETRY_MEMORY_ENABLED_DEFAULT
    headroom_warn_frac: float = C.TELEMETRY_MEMORY_HEADROOM_WARN_FRAC_DEFAULT
    crashdump_dir: str = C.TELEMETRY_MEMORY_CRASHDUMP_DIR_DEFAULT
    oom_exit_code: int = C.TELEMETRY_MEMORY_OOM_EXIT_CODE_DEFAULT
    plan_at_init: bool = C.TELEMETRY_MEMORY_PLAN_AT_INIT_DEFAULT
    plan_file: str = C.TELEMETRY_MEMORY_PLAN_FILE_DEFAULT
    activation_bytes_per_sample: float = C.TELEMETRY_MEMORY_ACT_BYTES_DEFAULT
    hbm_limit_gb: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryMemoryConfig":
        d = _telemetry_block(d, "telemetry.memory", (
            C.TELEMETRY_MEMORY_ENABLED, C.TELEMETRY_MEMORY_HEADROOM_WARN_FRAC,
            C.TELEMETRY_MEMORY_CRASHDUMP_DIR, C.TELEMETRY_MEMORY_OOM_EXIT_CODE,
            C.TELEMETRY_MEMORY_PLAN_AT_INIT, C.TELEMETRY_MEMORY_PLAN_FILE,
            C.TELEMETRY_MEMORY_ACT_BYTES, C.TELEMETRY_MEMORY_HBM_LIMIT_GB))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_MEMORY_ENABLED,
                              C.TELEMETRY_MEMORY_ENABLED_DEFAULT)),
            headroom_warn_frac=float(_get(
                d, C.TELEMETRY_MEMORY_HEADROOM_WARN_FRAC,
                C.TELEMETRY_MEMORY_HEADROOM_WARN_FRAC_DEFAULT)),
            crashdump_dir=str(_get(d, C.TELEMETRY_MEMORY_CRASHDUMP_DIR,
                                   C.TELEMETRY_MEMORY_CRASHDUMP_DIR_DEFAULT)),
            oom_exit_code=int(_get(d, C.TELEMETRY_MEMORY_OOM_EXIT_CODE,
                                   C.TELEMETRY_MEMORY_OOM_EXIT_CODE_DEFAULT)),
            plan_at_init=bool(_get(d, C.TELEMETRY_MEMORY_PLAN_AT_INIT,
                                   C.TELEMETRY_MEMORY_PLAN_AT_INIT_DEFAULT)),
            plan_file=str(_get(d, C.TELEMETRY_MEMORY_PLAN_FILE,
                               C.TELEMETRY_MEMORY_PLAN_FILE_DEFAULT)),
            activation_bytes_per_sample=float(_get(
                d, C.TELEMETRY_MEMORY_ACT_BYTES,
                C.TELEMETRY_MEMORY_ACT_BYTES_DEFAULT)),
            hbm_limit_gb=(float(d[C.TELEMETRY_MEMORY_HBM_LIMIT_GB])
                          if d.get(C.TELEMETRY_MEMORY_HBM_LIMIT_GB)
                          is not None else None))
        if not 0.0 <= cfg.headroom_warn_frac <= 1.0:
            raise ConfigError(
                f"telemetry.memory.headroom_warn_frac must be in [0, 1], "
                f"got {cfg.headroom_warn_frac}")
        if not 1 <= cfg.oom_exit_code <= 255:
            raise ConfigError(
                f"telemetry.memory.oom_exit_code must be in [1, 255], got "
                f"{cfg.oom_exit_code}")
        if cfg.hbm_limit_gb is not None and cfg.hbm_limit_gb <= 0:
            raise ConfigError(
                f"telemetry.memory.hbm_limit_gb must be positive, got "
                f"{cfg.hbm_limit_gb}")
        _pattern_file(cfg.plan_file, "memory_plan", ".json",
                      "telemetry.memory.plan_file", "tools/memory_report.py")
        return cfg


@dataclass
class TelemetryDevicetimeConfig:
    """``telemetry.devicetime``: parsed and checked as the reference does;
    the device-time observatory is not ported yet (refused when on)."""

    enabled: bool = C.TELEMETRY_DEVICETIME_ENABLED_DEFAULT
    capture_steps: int = C.TELEMETRY_DEVICETIME_CAPTURE_STEPS_DEFAULT
    every_steps: int = C.TELEMETRY_DEVICETIME_EVERY_STEPS_DEFAULT
    keep_last: int = C.TELEMETRY_DEVICETIME_KEEP_LAST_DEFAULT
    dir: str = C.TELEMETRY_DEVICETIME_DIR_DEFAULT
    top_k: int = C.TELEMETRY_DEVICETIME_TOP_K_DEFAULT
    divergence_warn: float = C.TELEMETRY_DEVICETIME_DIVERGENCE_WARN_DEFAULT
    hbm_gbps: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryDevicetimeConfig":
        d = _telemetry_block(d, "telemetry.devicetime", (
            C.TELEMETRY_DEVICETIME_ENABLED,
            C.TELEMETRY_DEVICETIME_CAPTURE_STEPS,
            C.TELEMETRY_DEVICETIME_EVERY_STEPS,
            C.TELEMETRY_DEVICETIME_KEEP_LAST, C.TELEMETRY_DEVICETIME_DIR,
            C.TELEMETRY_DEVICETIME_TOP_K,
            C.TELEMETRY_DEVICETIME_DIVERGENCE_WARN,
            C.TELEMETRY_DEVICETIME_HBM_GBPS))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_DEVICETIME_ENABLED,
                              C.TELEMETRY_DEVICETIME_ENABLED_DEFAULT)),
            capture_steps=int(_get(
                d, C.TELEMETRY_DEVICETIME_CAPTURE_STEPS,
                C.TELEMETRY_DEVICETIME_CAPTURE_STEPS_DEFAULT)),
            every_steps=int(_get(
                d, C.TELEMETRY_DEVICETIME_EVERY_STEPS,
                C.TELEMETRY_DEVICETIME_EVERY_STEPS_DEFAULT)),
            keep_last=int(_get(d, C.TELEMETRY_DEVICETIME_KEEP_LAST,
                               C.TELEMETRY_DEVICETIME_KEEP_LAST_DEFAULT)),
            dir=str(_get(d, C.TELEMETRY_DEVICETIME_DIR,
                         C.TELEMETRY_DEVICETIME_DIR_DEFAULT)),
            top_k=int(_get(d, C.TELEMETRY_DEVICETIME_TOP_K,
                           C.TELEMETRY_DEVICETIME_TOP_K_DEFAULT)),
            divergence_warn=float(_get(
                d, C.TELEMETRY_DEVICETIME_DIVERGENCE_WARN,
                C.TELEMETRY_DEVICETIME_DIVERGENCE_WARN_DEFAULT)),
            hbm_gbps=(float(d[C.TELEMETRY_DEVICETIME_HBM_GBPS])
                      if d.get(C.TELEMETRY_DEVICETIME_HBM_GBPS) is not None
                      else None))
        if cfg.capture_steps < 1:
            raise ConfigError(
                f"telemetry.devicetime.capture_steps must be >= 1, got "
                f"{cfg.capture_steps}")
        if cfg.every_steps <= cfg.capture_steps:
            raise ConfigError(
                f"telemetry.devicetime needs every_steps > capture_steps "
                f"(a capture must close before the next can open), got "
                f"every_steps={cfg.every_steps} "
                f"capture_steps={cfg.capture_steps}")
        if cfg.keep_last < 1:
            raise ConfigError(
                f"telemetry.devicetime.keep_last must be >= 1, got "
                f"{cfg.keep_last}")
        if cfg.top_k < 1:
            raise ConfigError(
                f"telemetry.devicetime.top_k must be >= 1, got {cfg.top_k}")
        if not 0.0 < cfg.divergence_warn <= 1.0:
            raise ConfigError(
                f"telemetry.devicetime.divergence_warn must be in (0, 1], "
                f"got {cfg.divergence_warn}")
        if cfg.hbm_gbps is not None and cfg.hbm_gbps <= 0:
            raise ConfigError(
                f"telemetry.devicetime.hbm_gbps must be positive, got "
                f"{cfg.hbm_gbps}")
        return cfg


@dataclass
class TelemetryNumericsConfig:
    """``telemetry.numerics``: in serving, the int8 KV-cache round-trip
    error gauges (one measure per prefill on the int8 pool)."""

    enabled: bool = C.TELEMETRY_NUMERICS_ENABLED_DEFAULT
    max_groups: int = C.TELEMETRY_NUMERICS_MAX_GROUPS_DEFAULT
    max_spike_dumps: int = C.TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS_DEFAULT

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryNumericsConfig":
        d = _telemetry_block(d, "telemetry.numerics", (
            C.TELEMETRY_NUMERICS_ENABLED, C.TELEMETRY_NUMERICS_MAX_GROUPS,
            C.TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_NUMERICS_ENABLED,
                              C.TELEMETRY_NUMERICS_ENABLED_DEFAULT)),
            max_groups=int(_get(d, C.TELEMETRY_NUMERICS_MAX_GROUPS,
                                C.TELEMETRY_NUMERICS_MAX_GROUPS_DEFAULT)),
            max_spike_dumps=int(_get(
                d, C.TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS,
                C.TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS_DEFAULT)))
        if cfg.max_groups < 1:
            raise ConfigError(
                f"telemetry.numerics.max_groups must be >= 1, got "
                f"{cfg.max_groups}")
        if cfg.max_spike_dumps < 0:
            raise ConfigError(
                f"telemetry.numerics.max_spike_dumps must be >= 0, got "
                f"{cfg.max_spike_dumps}")
        return cfg


@dataclass
class TelemetryRequestsConfig:
    """``telemetry.requests``: the per-request SLO accountant
    (telemetry/requests.py)."""

    enabled: bool = C.TELEMETRY_REQUESTS_ENABLED_DEFAULT
    file: str = C.TELEMETRY_REQUESTS_FILE_DEFAULT
    window_sec: float = C.TELEMETRY_REQUESTS_WINDOW_SEC_DEFAULT

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryRequestsConfig":
        d = _telemetry_block(d, "telemetry.requests", (
            C.TELEMETRY_REQUESTS_ENABLED, C.TELEMETRY_REQUESTS_FILE,
            C.TELEMETRY_REQUESTS_WINDOW_SEC))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_REQUESTS_ENABLED,
                              C.TELEMETRY_REQUESTS_ENABLED_DEFAULT)),
            file=str(_get(d, C.TELEMETRY_REQUESTS_FILE,
                          C.TELEMETRY_REQUESTS_FILE_DEFAULT)),
            window_sec=float(_get(d, C.TELEMETRY_REQUESTS_WINDOW_SEC,
                                  C.TELEMETRY_REQUESTS_WINDOW_SEC_DEFAULT)))
        _pattern_file(cfg.file, "requests", ".jsonl",
                      "telemetry.requests.file", "tools/slo_report.py")
        if cfg.window_sec <= 0:
            raise ConfigError(
                f"telemetry.requests.window_sec must be positive, got "
                f"{cfg.window_sec}")
        return cfg


_TELEMETRY_SUB_BLOCKS = {
    C.TELEMETRY_TRACE: TelemetryTraceConfig,
    C.TELEMETRY_METRICS: TelemetryMetricsConfig,
    C.TELEMETRY_FLEET: TelemetryFleetConfig,
    C.TELEMETRY_MEMORY: TelemetryMemoryConfig,
    C.TELEMETRY_DEVICETIME: TelemetryDevicetimeConfig,
    C.TELEMETRY_NUMERICS: TelemetryNumericsConfig,
    C.TELEMETRY_REQUESTS: TelemetryRequestsConfig,
}


@dataclass
class TelemetryConfig:
    """``telemetry`` block of ``init_serving``: the metrics registry, the
    step tracer, the recompile detector, the int8 KV error gauges
    (``numerics``) and the request accountant (``requests``). Parsed and
    checked as the reference parses it; off (the default) every hook is a
    no-op. With telemetry on, ``fleet``, ``memory``, ``devicetime`` and
    the tensorboard sink are not ported yet and raise by name.
    ``goodput`` parses and serving builds nothing from it, as in the
    reference's ``init_serving``."""

    enabled: bool = False
    dir: str = C.TELEMETRY_DIR_DEFAULT
    trace: TelemetryTraceConfig = field(default_factory=TelemetryTraceConfig)
    metrics: TelemetryMetricsConfig = field(
        default_factory=TelemetryMetricsConfig)
    recompile_detection: bool = C.TELEMETRY_RECOMPILE_DEFAULT
    goodput: bool = C.TELEMETRY_GOODPUT_DEFAULT
    fleet: TelemetryFleetConfig = field(default_factory=TelemetryFleetConfig)
    memory: TelemetryMemoryConfig = field(
        default_factory=TelemetryMemoryConfig)
    devicetime: TelemetryDevicetimeConfig = field(
        default_factory=TelemetryDevicetimeConfig)
    numerics: TelemetryNumericsConfig = field(
        default_factory=TelemetryNumericsConfig)
    requests: TelemetryRequestsConfig = field(
        default_factory=TelemetryRequestsConfig)

    @classmethod
    def from_dict(cls, d: Any) -> "TelemetryConfig":
        d = _telemetry_block(d, C.TELEMETRY, (
            C.TELEMETRY_ENABLED, C.TELEMETRY_DIR, C.TELEMETRY_RECOMPILE,
            C.TELEMETRY_GOODPUT, *_TELEMETRY_SUB_BLOCKS))
        cfg = cls(
            enabled=bool(_get(d, C.TELEMETRY_ENABLED, False)),
            dir=str(_get(d, C.TELEMETRY_DIR, C.TELEMETRY_DIR_DEFAULT)),
            recompile_detection=bool(_get(d, C.TELEMETRY_RECOMPILE,
                                          C.TELEMETRY_RECOMPILE_DEFAULT)),
            goodput=bool(_get(d, C.TELEMETRY_GOODPUT,
                              C.TELEMETRY_GOODPUT_DEFAULT)),
            **{key: sub.from_dict(d.get(key))
               for key, sub in _TELEMETRY_SUB_BLOCKS.items()})
        if cfg.enabled and not cfg.dir:
            raise ConfigError(
                "telemetry.enabled requires telemetry.dir (where the trace "
                "file and metrics JSONL land)")
        if cfg.fleet.enabled and not cfg.goodput:
            raise ConfigError(
                "telemetry.fleet requires telemetry.goodput (fleet "
                "aggregation reads the goodput accountant's deltas)")
        if cfg.devicetime.enabled and cfg.trace.jax_profiler_dir:
            raise ConfigError(
                "telemetry.devicetime and telemetry.trace.jax_profiler_dir "
                "are mutually exclusive: the passthrough holds the one "
                "profiler session open for the whole run, so scheduled "
                "captures could never start")
        if cfg.enabled:
            for key in (C.TELEMETRY_FLEET, C.TELEMETRY_MEMORY,
                        C.TELEMETRY_DEVICETIME):
                if getattr(cfg, key).enabled:
                    raise not_yet_ported(f"telemetry.{key}")
            for sink in cfg.metrics.sinks:
                if sink in C.TELEMETRY_METRICS_UNPORTED_SINKS:
                    raise not_yet_ported(
                        f"the telemetry.metrics.sinks {sink!r} sink")
        return cfg


def check_serving_blocks(config: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
    """Check the top-level blocks of an ``init_serving`` config, read as
    the reference's ``init_serving`` reads them: ``serving``,
    ``telemetry`` (parsed by ``TelemetryConfig``) and ``resilience``; any
    other key raises. Returns the ``resilience.fault_injection`` block
    (the serving chaos plan ``FaultPlan.resolve`` reads), or None when the
    block has none."""
    unknown = set(config) - {C.SERVING, C.TELEMETRY, C.RESILIENCE}
    if unknown:
        raise ConfigError(
            f"unknown init_serving config keys {sorted(unknown)}; the port "
            f"reads {sorted({C.SERVING, C.TELEMETRY, C.RESILIENCE})}")
    return _as_block(config.get(C.RESILIENCE), C.RESILIENCE).get(
        C.FAULT_INJECTION) or None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0      # 0 => dynamic
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FP16Config":
        d = d or {}
        known = {C.FP16_ENABLED, C.FP16_LOSS_SCALE,
                 C.FP16_INITIAL_SCALE_POWER, C.FP16_LOSS_SCALE_WINDOW,
                 C.FP16_HYSTERESIS, C.FP16_MIN_LOSS_SCALE}
        unknown = set(d) - known
        if unknown:
            raise ConfigError(f"unknown fp16 keys {sorted(unknown)}")
        return cls(
            enabled=bool(_get(d, C.FP16_ENABLED, False)),
            loss_scale=float(_get(d, C.FP16_LOSS_SCALE, 0.0)),
            initial_scale_power=int(_get(d, C.FP16_INITIAL_SCALE_POWER,
                                         C.FP16_INITIAL_SCALE_POWER_DEFAULT)),
            loss_scale_window=int(_get(d, C.FP16_LOSS_SCALE_WINDOW,
                                       C.FP16_LOSS_SCALE_WINDOW_DEFAULT)),
            hysteresis=int(_get(d, C.FP16_HYSTERESIS,
                                C.FP16_HYSTERESIS_DEFAULT)),
            min_loss_scale=float(_get(d, C.FP16_MIN_LOSS_SCALE,
                                      C.FP16_MIN_LOSS_SCALE_DEFAULT)))

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


def _known(block: Dict[str, Any], known, what: str) -> None:
    unknown = set(block) - set(known)
    if unknown:
        raise ConfigError(f"unknown {what} keys {sorted(unknown)}; expected "
                          f"a subset of {sorted(known)}")


@dataclass
class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` block
    (``runtime/activation_checkpointing.py`` maps it to a recompute
    policy)."""

    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    cpu_checkpointing: bool = False

    @classmethod
    def from_dict(cls, d: Any) -> "ActivationCheckpointingConfig":
        d = _as_block(d, C.ACTIVATION_CHECKPOINTING)
        _known(d, (C.ACT_CHKPT_PARTITION_ACTIVATIONS,
                   C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
                   C.ACT_CHKPT_NUMBER_CHECKPOINTS,
                   C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
                   C.ACT_CHKPT_PROFILE, C.ACT_CHKPT_CPU_CHECKPOINTING),
               C.ACTIVATION_CHECKPOINTING)
        return cls(
            partition_activations=_flag(d, C.ACT_CHKPT_PARTITION_ACTIVATIONS),
            contiguous_memory_optimization=_flag(
                d, C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION),
            number_checkpoints=d.get(C.ACT_CHKPT_NUMBER_CHECKPOINTS),
            synchronize_checkpoint_boundary=_flag(
                d, C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY),
            profile=_flag(d, C.ACT_CHKPT_PROFILE),
            cpu_checkpointing=_flag(d, C.ACT_CHKPT_CPU_CHECKPOINTING))


@dataclass
class ResilienceCheckpointConfig:
    """The auto-checkpoint knobs (``resilience/checkpoint.py``)."""

    dir: str = ""
    interval: int = C.RESILIENCE_CKPT_INTERVAL_DEFAULT
    keep_last: int = C.RESILIENCE_CKPT_KEEP_LAST_DEFAULT
    max_retries: int = C.RESILIENCE_CKPT_MAX_RETRIES_DEFAULT
    backoff_seconds: float = C.RESILIENCE_CKPT_BACKOFF_DEFAULT
    async_write: bool = C.RESILIENCE_CKPT_ASYNC_DEFAULT

    @classmethod
    def from_dict(cls, d: Any) -> "ResilienceCheckpointConfig":
        d = _as_block(d, f"{C.RESILIENCE}.{C.RESILIENCE_CHECKPOINT}")
        _known(d, (C.RESILIENCE_CKPT_DIR, C.RESILIENCE_CKPT_INTERVAL,
                   C.RESILIENCE_CKPT_KEEP_LAST, C.RESILIENCE_CKPT_MAX_RETRIES,
                   C.RESILIENCE_CKPT_BACKOFF, C.RESILIENCE_CKPT_ASYNC),
               f"{C.RESILIENCE}.{C.RESILIENCE_CHECKPOINT}")
        cfg = cls(
            dir=str(_get(d, C.RESILIENCE_CKPT_DIR, "")),
            interval=int(_get(d, C.RESILIENCE_CKPT_INTERVAL,
                              C.RESILIENCE_CKPT_INTERVAL_DEFAULT)),
            keep_last=int(_get(d, C.RESILIENCE_CKPT_KEEP_LAST,
                               C.RESILIENCE_CKPT_KEEP_LAST_DEFAULT)),
            max_retries=int(_get(d, C.RESILIENCE_CKPT_MAX_RETRIES,
                                 C.RESILIENCE_CKPT_MAX_RETRIES_DEFAULT)),
            backoff_seconds=float(_get(d, C.RESILIENCE_CKPT_BACKOFF,
                                       C.RESILIENCE_CKPT_BACKOFF_DEFAULT)),
            async_write=bool(_get(d, C.RESILIENCE_CKPT_ASYNC,
                                  C.RESILIENCE_CKPT_ASYNC_DEFAULT)))
        if cfg.interval < 1:
            raise ConfigError("resilience.checkpoint.interval must be >= 1")
        if cfg.keep_last < 1:
            raise ConfigError("resilience.checkpoint.keep_last must be >= 1")
        if cfg.max_retries < 0:
            raise ConfigError("resilience.checkpoint.max_retries must be >= 0")
        return cfg


@dataclass
class ResilienceConfig:
    """Preemption-safe training (``resilience/``): auto checkpointing every
    ``checkpoint.interval`` steps off the step path, auto-resume from the
    newest complete manifest, and the deterministic fault plan
    (``fault_injection`` keys are ``FaultPlan`` fields; the
    ``DSTPU_FAULT_PLAN`` JSON overrides them)."""

    enabled: bool = False
    checkpoint: ResilienceCheckpointConfig = field(
        default_factory=ResilienceCheckpointConfig)
    auto_resume: bool = C.RESILIENCE_AUTO_RESUME_DEFAULT
    fault_injection: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Any) -> "ResilienceConfig":
        d = _as_block(d, C.RESILIENCE)
        _known(d, (C.RESILIENCE_ENABLED, C.RESILIENCE_CHECKPOINT,
                   C.RESILIENCE_AUTO_RESUME, C.FAULT_INJECTION),
               C.RESILIENCE)
        cfg = cls(
            enabled=_flag(d, C.RESILIENCE_ENABLED),
            checkpoint=ResilienceCheckpointConfig.from_dict(
                d.get(C.RESILIENCE_CHECKPOINT)),
            auto_resume=bool(_get(d, C.RESILIENCE_AUTO_RESUME,
                                  C.RESILIENCE_AUTO_RESUME_DEFAULT)),
            fault_injection=dict(_as_block(
                d.get(C.FAULT_INJECTION),
                f"{C.RESILIENCE}.{C.FAULT_INJECTION}")))
        if cfg.enabled and not cfg.checkpoint.dir:
            raise ConfigError(
                "resilience.enabled requires resilience.checkpoint.dir "
                "(where manifests/shards are committed)")
        return cfg


def _enabled(value: Any, key: str) -> bool:
    """The rule of most blocks: on only with ``enabled: true``."""
    return _flag(_as_block(value, key), C.SUB_BLOCK_ENABLED)


def _moe_on(value: Any, key: str) -> bool:
    """A present block is an opt-in (``moe: {}``, ``false`` and ``0``
    too) unless it says ``enabled: false``."""
    if value is None:
        return False
    return bool(_get(_as_block(value, key), C.SUB_BLOCK_ENABLED, True))


def _comm_on(value: Any, key: str) -> bool:
    """``hierarchical: on`` forces the explicit grad sync; ``auto``
    engages it only on a multi-slice mesh (refused by ``mesh``), ``off``
    (the default) never."""
    mode = str(_get(_as_block(value, key), "hierarchical", "off")).lower()
    if mode not in ("auto", "on", "off"):
        raise ConfigError(f"comm.hierarchical must be auto|on|off, got "
                          f"{mode!r}")
    return mode == "on"


def _autotuning_on(value: Any, key: str) -> bool:
    """An explicit ``enabled`` wins; without it the launcher's
    environment handshake turns the search on."""
    block = _as_block(value, key)
    if block.get(C.SUB_BLOCK_ENABLED) is not None:
        return bool(block[C.SUB_BLOCK_ENABLED])
    return os.environ.get(C.AUTOTUNING_ENV, "") not in ("", "0")


def _elasticity_on(value: Any, key: str) -> bool:
    """The batch ladder (``enabled``) or its live tier (which the
    reference refuses without the ladder)."""
    block = _as_block(value, key)
    return _flag(block, C.SUB_BLOCK_ENABLED) or _enabled(block.get("live"),
                                                         "elasticity.live")


def _pipeline_on(value: Any, key: str) -> bool:
    return int(_get(_as_block(value, key), "stages", 1)) > 1


def _mesh_on(value: Any, key: str) -> bool:
    """Any axis but a data axis of 1 or -1 (inferred) and sizes of 1."""
    return any(int(v) not in (1, -1)
               for v in _as_block(value, key).values() if v is not None)


def _truthy(value: Any, key: str) -> bool:
    """A boolean switch, read as ``bool(value)``."""
    return bool(value)


def _never(value: Any, key: str) -> bool:
    """Read by no feature of the reference (``eigenvalue`` and
    ``compressed_allreduce``) or only by one that another block turns on
    (``aio`` configures NVMe offload, refused under
    ``zero_optimization``)."""
    return False


# For each top-level block of C.NOT_YET_PORTED_BLOCKS, whether a value
# turns its feature on, by the reference's own rule
# (deepspeed_tpu/config/config.py and the engine that reads it).
_BLOCK_ON = {
    "comm": _comm_on, "pipeline": _pipeline_on, "moe": _moe_on,
    "telemetry": _enabled, "autotuning": _autotuning_on,
    "elasticity": _elasticity_on, "sparse_gradients": _truthy, "flops_profiler": _enabled,
    "progressive_layer_drop": _enabled, "quantize_training": _enabled,
    "guardrails": _enabled, "mesh": _mesh_on, "eigenvalue": _never,
    "amp": _enabled, "tensorboard": _enabled, "aio": _never,
    "wall_clock_breakdown": _truthy, "memory_breakdown": _truthy,
    "dump_state": _truthy, "check_numerics": _truthy,
    "communication_data_type": lambda value, key: value is not None,
    "compressed_allreduce": _never, "legacy_fusion": _truthy,
}


def _turns_on(key: str, value: Any) -> bool:
    """Whether the top-level block ``key`` with ``value`` turns its
    feature on (``_BLOCK_ON``). The environment's autotuning handshake
    counts without its block, as in the reference."""
    if value is None and key != "autotuning":
        return False
    return _BLOCK_ON[key](value, key)


_TRAINING_KEYS = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.TRAIN_MICRO_BATCH_SIZE_PER_CHIP, C.GRADIENT_ACCUMULATION_STEPS,
    C.OPTIMIZER, C.SCHEDULER, C.FP16, C.BF16, C.BFLOAT16, C.DATA_TYPES,
    C.GRADIENT_CLIPPING, C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR,
    C.STEPS_PER_PRINT, C.ZERO_OPTIMIZATION, C.SERVING, C.SPARSE_ATTENTION,
    C.RESILIENCE, C.ACTIVATION_CHECKPOINTING,
})


class DeepSpeedConfig:
    """Parsed, validated training configuration (the port of
    ``DeepSpeedTPUConfig``): the batch triple, the optimizer (Adam/AdamW,
    ``fused_update``; LAMB), the scheduler, bf16/fp16, the
    gradient-accumulation dtype, clipping, prescaling, ``steps_per_print``,
    the ``zero_optimization`` block, the ``sparse_attention`` block
    (kept as given in ``.sparse_attention``; ``initialize`` routes the
    model's attention through it), ``resilience`` and
    ``activation_checkpointing``. Every other training block of the JAX
    schema raises ``ConfigError`` naming it with "not yet ported" unless it
    is off; an unknown key raises. ``world_size`` is the data-parallel
    degree the batch triple is solved for (one process so far)."""

    def __init__(self, config: Union[str, Dict[str, Any], None],
                 world_size: int = 1):
        if config is None:
            config = {}
        if isinstance(config, str):
            if not os.path.exists(config):
                raise ConfigError(f"config file not found: {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ConfigError(f"config must be a path or dict, got "
                              f"{type(config)}")
        d = dict(config)
        for key in C.NOT_YET_PORTED_BLOCKS:
            if _turns_on(key, d.get(key)):
                raise not_yet_ported(f"the {key!r} config block")
        unknown = set(d) - _TRAINING_KEYS - set(C.NOT_YET_PORTED_BLOCKS)
        if unknown:
            raise ConfigError(f"unknown config keys {sorted(unknown)}")
        self.world_size = int(world_size)

        micro = d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                      d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_CHIP))
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = resolve_batch_triple(
            d.get(C.TRAIN_BATCH_SIZE), micro,
            d.get(C.GRADIENT_ACCUMULATION_STEPS), self.world_size)

        opt = d.get(C.OPTIMIZER)
        self.optimizer_name: Optional[str] = None
        self.optimizer_params: Dict[str, Any] = {}
        self.optimizer_fused_update = C.OPTIMIZER_FUSED_UPDATE_DEFAULT
        if opt is not None:
            if C.OPTIMIZER_TYPE not in opt:
                raise ConfigError("optimizer block requires a 'type'")
            unknown = set(opt) - {C.OPTIMIZER_TYPE, C.OPTIMIZER_PARAMS,
                                  C.OPTIMIZER_FUSED_UPDATE}
            if unknown:
                raise ConfigError(f"unknown optimizer keys {sorted(unknown)}")
            name = str(opt[C.OPTIMIZER_TYPE]).lower()
            if name in C.NOT_YET_PORTED_OPTIMIZERS:
                raise not_yet_ported(f"optimizer type {name!r}")
            if name not in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER,
                            C.LAMB_OPTIMIZER):
                raise ConfigError(f"unknown optimizer '{name}'")
            self.optimizer_name = name
            self.optimizer_params = dict(opt.get(C.OPTIMIZER_PARAMS) or {})
            self.optimizer_fused_update = bool(opt.get(
                C.OPTIMIZER_FUSED_UPDATE, C.OPTIMIZER_FUSED_UPDATE_DEFAULT))

        sched = d.get(C.SCHEDULER)
        self.scheduler_name: Optional[str] = None
        self.scheduler_params: Dict[str, Any] = {}
        if sched is not None:
            if C.SCHEDULER_TYPE not in sched:
                raise ConfigError("scheduler block requires a 'type'")
            self.scheduler_name = str(sched[C.SCHEDULER_TYPE])
            self.scheduler_params = dict(sched.get(C.SCHEDULER_PARAMS) or {})

        self.fp16 = FP16Config.from_dict(d.get(C.FP16))
        bf16_block = d.get(C.BF16, d.get(C.BFLOAT16))
        self.bf16_enabled = bool(_get(bf16_block or {}, C.BF16_ENABLED,
                                      False))
        if self.fp16.enabled and self.bf16_enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        self.gradient_clipping = float(_get(d, C.GRADIENT_CLIPPING,
                                            C.GRADIENT_CLIPPING_DEFAULT))
        self.prescale_gradients = bool(_get(d, C.PRESCALE_GRADIENTS,
                                            C.PRESCALE_GRADIENTS_DEFAULT))
        self.gradient_predivide_factor = float(_get(
            d, C.GRADIENT_PREDIVIDE_FACTOR,
            C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT))
        dt_block = dict(d.get(C.DATA_TYPES) or {})
        unknown = set(dt_block) - {C.GRAD_ACCUM_DTYPE}
        if unknown:
            raise ConfigError(f"unknown data_types keys {sorted(unknown)}")
        self.grad_accum_dtype = str(dt_block.get(C.GRAD_ACCUM_DTYPE,
                                                 C.GRAD_ACCUM_DTYPE_DEFAULT))
        if self.grad_accum_dtype not in ("float32", "fp32", "bfloat16",
                                         "bf16"):
            raise ConfigError(
                f"data_types.grad_accum_dtype must be float32 or bfloat16, "
                f"got '{self.grad_accum_dtype}'")
        from deepspeed_tpu_torch.runtime.zero.config import ZeroConfig

        self.zero_config = ZeroConfig.from_dict(d.get(C.ZERO_OPTIMIZATION))
        self.zero_enabled = self.zero_config.enabled
        if C.SERVING in d:
            ServingConfig.from_dict(d[C.SERVING])
        self.sparse_attention = d.get(C.SPARSE_ATTENTION)
        if self.sparse_attention:
            _check_sparse_attention(self.sparse_attention)
        self.steps_per_print = int(_get(d, C.STEPS_PER_PRINT,
                                        C.STEPS_PER_PRINT_DEFAULT))
        self.activation_checkpointing_provided = \
            C.ACTIVATION_CHECKPOINTING in d
        self.activation_checkpointing = \
            ActivationCheckpointingConfig.from_dict(
                d.get(C.ACTIVATION_CHECKPOINTING))
        self.resilience = ResilienceConfig.from_dict(d.get(C.RESILIENCE))

    @property
    def precision_dtype(self) -> str:
        if self.bf16_enabled:
            return "bfloat16"
        if self.fp16.enabled:
            return "float16"
        return "float32"


def _check_sparse_attention(block: Any) -> None:
    """A ``sparse_attention`` block must name a mode and keys that mode
    takes; the layout itself is made when the model first runs."""
    from deepspeed_tpu_torch.ops.sparse_attention.utils import \
        sparsity_config_from_dict

    if not isinstance(block, dict):
        raise ConfigError(f"sparse_attention must be a dict, got "
                          f"{type(block).__name__}")
    try:
        sparsity_config_from_dict(block, num_heads=1)
    except ValueError as e:
        raise ConfigError(str(e)) from None


def resolve_batch_triple(train: Optional[int], micro: Optional[int],
                         gas: Optional[int], dp: int):
    """Solve and check train = micro x gas x dp."""
    train = int(train) if train is not None else None
    micro = int(micro) if micro is not None else None
    gas = int(gas) if gas is not None else None
    if all(v is not None for v in (train, micro, gas)):
        if train != micro * gas * dp:
            raise ConfigError(
                f"batch sizes inconsistent: train_batch_size={train} != "
                f"micro({micro}) x gas({gas}) x dp({dp})")
    elif train is not None and micro is not None:
        if train % (micro * dp) != 0:
            raise ConfigError(f"train_batch_size {train} not divisible by "
                              f"micro x dp={micro * dp}")
        gas = train // (micro * dp)
    elif train is not None and gas is not None:
        if train % (gas * dp) != 0:
            raise ConfigError(f"train_batch_size {train} not divisible by "
                              f"gas x dp={gas * dp}")
        micro = train // (gas * dp)
    elif micro is not None:
        gas = gas or 1
        train = micro * gas * dp
    elif train is not None:
        gas = 1
        if train % dp != 0:
            raise ConfigError(f"train_batch_size {train} not divisible by "
                              f"dp={dp}")
        micro = train // dp
    else:
        raise ConfigError("at least one of train_batch_size / "
                          "train_micro_batch_size_per_gpu must be specified")
    for name, v in (("train_batch_size", train),
                    ("train_micro_batch_size_per_gpu", micro),
                    ("gradient_accumulation_steps", gas)):
        if v <= 0:
            raise ConfigError(f"{name} must be positive, got {v}")
    return train, micro, gas
