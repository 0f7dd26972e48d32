"""Parsed config blocks of the port: ``ServingConfig`` and ``ConfigError``.

Held to the walls of ``deepspeed_tpu/config/config.py:ServingConfig``. A
key the port has no feature for yet raises a ``ConfigError`` that names it
and says "not yet ported"; an unknown key raises too. Nothing is ignored.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.config import constants as C


class ConfigError(ValueError):
    pass


def not_yet_ported(what: str) -> ConfigError:
    return ConfigError(f"{what} is not yet ported to deepspeed_tpu_torch")


def _get(d: Dict[str, Any], key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v is None else v


def _enabled_block(d: Dict[str, Any], key: str) -> bool:
    """Whether a sub-block of the JAX schema turns its feature on: a
    present block is an opt-in unless it says ``enabled: false``."""
    block = d.get(key)
    if block is None or block is False:
        return False
    if not isinstance(block, dict):
        raise ConfigError(f"serving.{key} must be a dict")
    return bool(block.get(C.SUB_BLOCK_ENABLED, True))


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

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        d = d or {}
        unknown = set(d) - _KNOWN_SERVING_KEYS
        if unknown:
            raise ConfigError(
                f"unknown serving keys {sorted(unknown)}; expected a subset "
                f"of {sorted(_KNOWN_SERVING_KEYS)}")
        if d.get(C.SERVING_INT8_KV_CACHE):
            raise not_yet_ported("serving.int8_kv_cache: true (the int8 KV "
                                 "pool)")
        if d.get(C.SERVING_PREFIX_CACHE):
            raise not_yet_ported("serving.prefix_cache")
        for key in (C.SERVING_SPECULATIVE, C.SERVING_RESILIENCE,
                    C.SERVING_CHUNKED_PREFILL):
            if _enabled_block(d, key):
                raise not_yet_ported(f"serving.{key}")
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
        )


def check_serving_blocks(config: Dict[str, Any]) -> None:
    """Refuse the top-level blocks of an ``init_serving`` config that the
    port cannot honour yet: a telemetry block that turns anything on, a
    resilience (fault injection) block, and any key it does not know."""
    unknown = set(config) - {C.SERVING, C.TELEMETRY, C.RESILIENCE}
    if unknown:
        raise ConfigError(
            f"unknown init_serving config keys {sorted(unknown)}; the port "
            f"reads {sorted({C.SERVING, C.TELEMETRY})}")
    tel = config.get(C.TELEMETRY)
    if tel:
        if not isinstance(tel, dict) or set(tel) != {C.SUB_BLOCK_ENABLED} \
                or tel[C.SUB_BLOCK_ENABLED]:
            raise not_yet_ported("the telemetry block")
    if config.get(C.RESILIENCE):
        raise not_yet_ported("the resilience block (serving fault "
                             "injection)")
