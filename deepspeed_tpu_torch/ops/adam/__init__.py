from deepspeed_tpu_torch.ops.adam.fused_adam import (AdamState, FusedAdam,
                                                     FusedAdamW)
from deepspeed_tpu_torch.ops.adam.fused_update import (fused_adam_apply,
                                                       fused_update_cost)

__all__ = ["AdamState", "FusedAdam", "FusedAdamW", "fused_adam_apply",
           "fused_update_cost"]
