"""Resilience: deterministic fault injection (``FaultPlan``). Training
resilience (checkpointing, the supervisor, elasticity) is not ported
yet."""

from deepspeed_tpu_torch.config.constants import FAULT_PLAN_ENV
from deepspeed_tpu_torch.resilience.fault import (RESUME_ATTEMPT_ENV,
                                                  FaultPlan, InjectedFault)

__all__ = ["FaultPlan", "FAULT_PLAN_ENV", "InjectedFault",
           "RESUME_ATTEMPT_ENV"]
