"""Config parsing of the port."""

from deepspeed_tpu_torch.config.config import (ConfigError, ServingConfig,
                                               TelemetryConfig)

__all__ = ["ConfigError", "ServingConfig", "TelemetryConfig"]
