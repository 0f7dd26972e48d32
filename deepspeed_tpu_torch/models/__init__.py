"""Model families of the port (GPT-2 and BERT) and weight conversion."""

from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS, BertConfig,
                                             BertLayer, BertModel, make_bert)
from deepspeed_tpu_torch.models.convert import (bert_layer_params_from_flax,
                                                bert_params_from_flax,
                                                flax_params_from_bert,
                                                flax_params_from_gpt,
                                                gpt_params_from_flax,
                                                init_bert_params,
                                                init_flax_bert_params,
                                                init_flax_gpt_params,
                                                init_gpt_params,
                                                state_arrays_from_flax)
from deepspeed_tpu_torch.models.gpt import (GPT, GPT_CONFIGS, GPTBlock,
                                            GPTConfig, init_kv_cache,
                                            make_gpt)

__all__ = ["GPT", "GPT_CONFIGS", "GPTBlock", "GPTConfig", "init_kv_cache",
           "make_gpt", "gpt_params_from_flax", "flax_params_from_gpt",
           "init_flax_gpt_params", "init_gpt_params", "BERT_CONFIGS",
           "BertConfig", "BertLayer", "BertModel", "make_bert",
           "bert_params_from_flax", "bert_layer_params_from_flax",
           "flax_params_from_bert", "init_flax_bert_params",
           "init_bert_params", "state_arrays_from_flax"]
