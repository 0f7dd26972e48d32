"""Config keys and defaults of the port (the ``serving`` block so far).

Same JSON schema as ``deepspeed_tpu/config/constants.py``: a config file
written for the JAX package means the same here, and a key whose feature
the port does not have yet is refused by name (``config.py``), never
ignored.
"""

#############################################
# Serving: the continuous-batching serving engine (serving/)
#############################################
SERVING = "serving"
SERVING_MAX_BATCH_SIZE = "max_batch_size"
SERVING_MAX_BATCH_SIZE_DEFAULT = 8            # decode slots
SERVING_KV_BLOCK_SIZE = "kv_block_size"
SERVING_KV_BLOCK_SIZE_DEFAULT = 16            # cache positions per block
SERVING_KV_NUM_BLOCKS = "kv_num_blocks"
SERVING_KV_NUM_BLOCKS_DEFAULT = 256           # pool size (block 0 = scratch)
SERVING_INT8_KV_CACHE = "int8_kv_cache"
SERVING_INT8_KV_CACHE_DEFAULT = False         # blockwise-int8 KV pools
SERVING_MAX_MODEL_LEN = "max_model_len"       # None -> model max_seq_len
SERVING_MAX_PREFILLS_PER_STEP = "max_prefills_per_step"
SERVING_MAX_PREFILLS_PER_STEP_DEFAULT = 1     # prefill/decode interleave cap
SERVING_EOS_TOKEN_ID = "eos_token_id"         # None -> length-only stopping
SERVING_TEMPERATURE = "temperature"
SERVING_TEMPERATURE_DEFAULT = 0.0             # greedy
SERVING_TOP_K = "top_k"
SERVING_TOP_K_DEFAULT = 0
SERVING_SEED = "seed"
SERVING_SEED_DEFAULT = 0
# "gather" materialises the [B, window, H, D] K/V copy over the full
# table; "kernel" runs the paged decode-attention kernel over a window
# capped at the longest active row; "auto" is "kernel" on a CUDA device
# (an unfit head geometry raises) and the capped gather on the CPU.
SERVING_DECODE_ATTENTION = "decode_attention"
SERVING_DECODE_ATTENTION_DEFAULT = "gather"
SERVING_DECODE_ATTENTION_CHOICES = ("gather", "auto", "kernel")
# Keys of the JAX package's serving block whose features are not ported
# yet. Each is accepted only in its off state.
SERVING_PREFIX_CACHE = "prefix_cache"
SERVING_SPECULATIVE = "speculative"
SERVING_RESILIENCE = "resilience"
SERVING_CHUNKED_PREFILL = "chunked_prefill"
SUB_BLOCK_ENABLED = "enabled"

#############################################
# Other top-level blocks of the JAX package's config that serving reads
#############################################
TELEMETRY = "telemetry"
RESILIENCE = "resilience"
