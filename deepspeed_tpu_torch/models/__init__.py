"""Model families of the port (GPT-2 so far) and weight conversion."""

from deepspeed_tpu_torch.models.convert import (flax_params_from_gpt,
                                                gpt_params_from_flax,
                                                init_flax_gpt_params,
                                                init_gpt_params)
from deepspeed_tpu_torch.models.gpt import (GPT, GPT_CONFIGS, GPTBlock,
                                            GPTConfig, init_kv_cache,
                                            make_gpt)

__all__ = ["GPT", "GPT_CONFIGS", "GPTBlock", "GPTConfig", "init_kv_cache",
           "make_gpt", "gpt_params_from_flax", "flax_params_from_gpt",
           "init_flax_gpt_params", "init_gpt_params"]
