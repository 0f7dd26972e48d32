"""Resilience: preemption-safe checkpointing off the step path, auto-resume,
the supervisor and deterministic fault injection (``FaultPlan``). Live
elasticity is not ported yet."""

from deepspeed_tpu_torch.config.constants import FAULT_PLAN_ENV
from deepspeed_tpu_torch.resilience.checkpoint import (AsyncCheckpointManager,
                                                       ResilienceError,
                                                       find_restorable,
                                                       install_state_arrays,
                                                       list_checkpoints,
                                                       restore,
                                                       snapshot_engine)
from deepspeed_tpu_torch.resilience.fault import (RESUME_ATTEMPT_ENV,
                                                  FaultPlan, InjectedFault,
                                                  corrupt_one_shard)
from deepspeed_tpu_torch.resilience.supervisor import (Supervisor,
                                                       supervise_main)

__all__ = ["AsyncCheckpointManager", "ResilienceError", "find_restorable",
           "install_state_arrays", "list_checkpoints", "restore",
           "snapshot_engine", "FaultPlan", "FAULT_PLAN_ENV", "InjectedFault",
           "RESUME_ATTEMPT_ENV", "corrupt_one_shard", "Supervisor",
           "supervise_main"]
