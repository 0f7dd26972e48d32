"""The ``zero_optimization`` block.

The port of ``deepspeed_tpu/runtime/zero/config.py``: the same keys, so a
DeepSpeed JSON config parses unchanged, and an unknown key raises. In a
single process every stage (0-3) is accepted and only decides placement,
as on one JAX device: masters, moments and the gradient accumulator live
whole on the one card. The offload tiers and ZeRO++ are not ported yet and
raise when turned on; a world of more than one process is refused by the
engine.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.config.config import ConfigError, not_yet_ported

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0

# Keys of the JAX block that only tune collectives or buffers: accepted and
# recorded, and without effect in one process.
_TUNING_KEYS = {
    "allgather_partitions": bool, "allgather_bucket_size": float,
    "overlap_comm": bool, "reduce_scatter": bool,
    "reduce_bucket_size": float, "contiguous_gradients": bool,
    "elastic_checkpoint": bool, "sub_group_size": float,
    "stage3_max_live_parameters": float, "stage3_max_reuse_distance": float,
    "stage3_prefetch_bucket_size": float,
    "stage3_param_persistence_threshold": float,
    "stage3_gather_fp16_weights_on_model_save": bool,
    "legacy_stage1": bool,
}
OFFLOAD_PARAM = "offload_param"
OFFLOAD_OPTIMIZER = "offload_optimizer"
CPU_OFFLOAD = "cpu_offload"
ZEROPP = "zeropp"
_OFFLOAD_KEYS = {"device", "nvme_path", "buffer_count", "buffer_size",
                 "max_in_cpu", "pin_memory", "pipeline"}
_ZEROPP_KEYS = {"quantized_weights", "quant_block_size", "hpz"}


@dataclass
class ZeroConfig:
    stage: int = ZERO_STAGE_DEFAULT
    tuning: Optional[Dict[str, Any]] = None   # the recorded tuning keys

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        if d is None:
            return cls(tuning={})
        if not isinstance(d, dict):
            raise ConfigError(f"{ZERO_OPTIMIZATION} must be a dict, got "
                              f"{type(d)}")
        d = dict(d)
        stage = int(d.pop(ZERO_STAGE, ZERO_STAGE_DEFAULT))
        if stage not in (0, 1, 2, 3):
            raise ConfigError(f"ZeRO stage must be 0-3, got {stage}")
        tuning = {k: typ(d.pop(k)) for k, typ in _TUNING_KEYS.items()
                  if k in d}
        for key in (OFFLOAD_PARAM, OFFLOAD_OPTIMIZER):
            block = d.pop(key, None)
            if block is None:
                continue
            if not isinstance(block, dict):
                raise ConfigError(f"offload config must be a dict, got "
                                  f"{type(block)}")
            unknown = set(block) - _OFFLOAD_KEYS
            if unknown:
                raise ConfigError(f"unknown offload config keys: "
                                  f"{sorted(unknown)}")
            if block.get("device", "none") not in (None, "none"):
                raise not_yet_ported(f"{ZERO_OPTIMIZATION}.{key}")
        if d.pop(CPU_OFFLOAD, False):
            raise not_yet_ported(f"{ZERO_OPTIMIZATION}.{CPU_OFFLOAD}")
        zpp = d.pop(ZEROPP, None)
        if zpp is not None:
            if not isinstance(zpp, dict):
                raise ConfigError(f"{ZEROPP} must be a dict, got {type(zpp)}")
            unknown = set(zpp) - _ZEROPP_KEYS
            if unknown:
                raise ConfigError(f"unknown {ZEROPP} keys: {sorted(unknown)}")
            if (str(zpp.get("quantized_weights", "off")).lower() != "off"
                    or str(zpp.get("hpz", "off")).lower() != "off"):
                raise not_yet_ported(f"{ZERO_OPTIMIZATION}.{ZEROPP}")
        if d:
            raise ConfigError(f"unknown {ZERO_OPTIMIZATION} keys: "
                              f"{sorted(d)}")
        return cls(stage=stage, tuning=tuning)

    @property
    def enabled(self) -> bool:
        return self.stage > 0
