"""``deepspeed_tpu_torch.checkpointing``: the activation-checkpointing module
alias (``deepspeed.checkpointing``'s API: ``configure``, ``is_configured``,
``checkpoint``)."""

from deepspeed_tpu_torch.runtime.activation_checkpointing import (  # noqa: F401
    checkpoint, configure, get_config, is_configured, remat_policy, reset)

__all__ = ["configure", "is_configured", "checkpoint", "get_config",
           "remat_policy", "reset"]
