"""Guardrails: the shared retry helper."""

from deepspeed_tpu_torch.guardrails.retry import backoff_delay, retry_call

__all__ = ["backoff_delay", "retry_call"]
