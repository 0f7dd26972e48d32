"""Config keys and defaults of the port: the training schema and the
``serving`` block.

Same JSON schema as ``deepspeed_tpu/config/constants.py``: a config file
written for the JAX package means the same here, and a key whose feature
the port does not have yet is refused by name (``config.py``), never
ignored.
"""

#############################################
# Training: batch, optimizer, scheduler, precision, gradients
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_CHIP = "train_micro_batch_size_per_chip"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
OPTIMIZER_TYPE = "type"
OPTIMIZER_PARAMS = "params"
# One multi-tensor kernel for the Adam update (ops/adam/fused_update.py)
# in place of the per-tensor chain of plain ops; opt-in as in JAX.
OPTIMIZER_FUSED_UPDATE = "fused_update"
OPTIMIZER_FUSED_UPDATE_DEFAULT = False
MAX_GRAD_NORM = "max_grad_norm"
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
# Optimizers of the JAX package not ported yet.
NOT_YET_PORTED_OPTIMIZERS = ("onebitadam", "onebitlamb", "cpuadam", "sgd")

SCHEDULER = "scheduler"
SCHEDULER_TYPE = "type"
SCHEDULER_PARAMS = "params"

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1.0
BF16 = "bf16"
BFLOAT16 = "bfloat16"          # accepted alias
BF16_ENABLED = "enabled"

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = "float32"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
ZERO_OPTIMIZATION = "zero_optimization"
# Block-sparse attention (ops/sparse_attention): a present, non-empty
# block routes the in-tree model's training attention through it.
SPARSE_ATTENTION = "sparse_attention"

# Top-level training blocks of the JAX package not ported yet: accepted
# only in their off state, refused by name otherwise. Each is read "on"
# by the reference's own rule (config.py:_BLOCK_ON).
NOT_YET_PORTED_BLOCKS = (
    "comm", "pipeline", "moe", "autotuning",
    "elasticity", "sparse_gradients", "flops_profiler", "progressive_layer_drop",
    "quantize_training", "mesh", "eigenvalue", "amp",
    "tensorboard", "aio", "wall_clock_breakdown",
    "memory_breakdown", "dump_state",
    "communication_data_type", "compressed_allreduce", "legacy_fusion",
)
# Debug mode: fail fast on a non-finite loss or master after a step (one
# more read by the host a step).
CHECK_NUMERICS = "check_numerics"
# The environment the reference's parser also reads: the launcher's
# autotuning handshake turns the search on when the block has no
# ``enabled``; a fault plan in the environment arms fault injection.
AUTOTUNING_ENV = "DSTPU_AUTOTUNE"
FAULT_PLAN_ENV = "DSTPU_FAULT_PLAN"

#############################################
# Resilience: auto checkpointing off the step path, auto-resume and the
# fault plan (resilience/)
#############################################
RESILIENCE = "resilience"
RESILIENCE_ENABLED = "enabled"
RESILIENCE_CHECKPOINT = "checkpoint"
RESILIENCE_CKPT_DIR = "dir"
RESILIENCE_CKPT_INTERVAL = "interval"
RESILIENCE_CKPT_INTERVAL_DEFAULT = 100
RESILIENCE_CKPT_KEEP_LAST = "keep_last"
RESILIENCE_CKPT_KEEP_LAST_DEFAULT = 3
RESILIENCE_CKPT_MAX_RETRIES = "max_retries"
RESILIENCE_CKPT_MAX_RETRIES_DEFAULT = 3
RESILIENCE_CKPT_BACKOFF = "backoff_seconds"
RESILIENCE_CKPT_BACKOFF_DEFAULT = 0.5
RESILIENCE_CKPT_ASYNC = "async"
RESILIENCE_CKPT_ASYNC_DEFAULT = True
RESILIENCE_AUTO_RESUME = "auto_resume"
RESILIENCE_AUTO_RESUME_DEFAULT = True
FAULT_INJECTION = "fault_injection"   # resilience.fault_injection: a FaultPlan
# The supervisor's exit-code classes (resilience/supervisor.py), the JAX
# package's defaults: the guardrails watchdog's rc restarts at once, the
# memory observatory's OOM rc is not restarted, the live-elasticity rc
# restarts as a warned preemption.
MEMORY_OOM_EXIT_CODE_DEFAULT = 114
ELASTIC_PREEMPT_EXIT_CODE_DEFAULT = 115

#############################################
# Guardrails: anomaly detection, in-memory rollback and the step watchdog
# (guardrails/)
#############################################
GUARDRAILS = "guardrails"
GUARDRAILS_ENABLED = "enabled"
GUARDRAILS_DETECTOR = "detector"
GUARDRAILS_DET_ZSCORE = "zscore_threshold"
GUARDRAILS_DET_ZSCORE_DEFAULT = 6.0
GUARDRAILS_DET_WARMUP = "warmup_steps"
GUARDRAILS_DET_WARMUP_DEFAULT = 20
GUARDRAILS_DET_EWMA_ALPHA = "ewma_alpha"
GUARDRAILS_DET_EWMA_ALPHA_DEFAULT = 0.02
GUARDRAILS_DET_TRACK_GRAD_NORM = "track_grad_norm"
GUARDRAILS_DET_TRACK_GRAD_NORM_DEFAULT = True
# skip the update on non-finite gradients in bf16 and fp32 too (fp16's
# loss scaler already does); one more read by the host a step
GUARDRAILS_DET_NONFINITE_GRADS = "check_nonfinite_grads"
GUARDRAILS_DET_NONFINITE_GRADS_DEFAULT = False
GUARDRAILS_ROLLBACK = "rollback"
GUARDRAILS_RB_ENABLED = "enabled"
GUARDRAILS_RB_ENABLED_DEFAULT = True
GUARDRAILS_RB_SNAPSHOT_INTERVAL = "snapshot_interval"
GUARDRAILS_RB_SNAPSHOT_INTERVAL_DEFAULT = 10
GUARDRAILS_RB_RING_SIZE = "ring_size"
GUARDRAILS_RB_RING_SIZE_DEFAULT = 2
GUARDRAILS_RB_CONSECUTIVE_SPIKES = "consecutive_spikes"
GUARDRAILS_RB_CONSECUTIVE_SPIKES_DEFAULT = 2
GUARDRAILS_RB_SKIP_BATCHES = "skip_batches"
GUARDRAILS_RB_SKIP_BATCHES_DEFAULT = 2
GUARDRAILS_RB_LR_DECAY = "lr_decay"
GUARDRAILS_RB_LR_DECAY_DEFAULT = 1.0
GUARDRAILS_RB_MAX_ROLLBACKS = "max_rollbacks"
GUARDRAILS_RB_MAX_ROLLBACKS_DEFAULT = 3
GUARDRAILS_RB_ESCALATE = "escalate_to_disk"
GUARDRAILS_RB_ESCALATE_DEFAULT = True
GUARDRAILS_WATCHDOG = "watchdog"
GUARDRAILS_WD_ENABLED = "enabled"
GUARDRAILS_WD_ENABLED_DEFAULT = False
GUARDRAILS_WD_TIMEOUT = "step_timeout_seconds"
GUARDRAILS_WD_TIMEOUT_DEFAULT = 1800.0
GUARDRAILS_WD_POLL = "poll_interval_seconds"
GUARDRAILS_WD_CRASHDUMP_DIR = "crashdump_dir"
GUARDRAILS_WD_CRASHDUMP_DIR_DEFAULT = "crashdumps"
GUARDRAILS_WD_EXIT_CODE = "exit_code"
# Distinct from every other exit of the runtime (1 generic, 2 usage,
# 137/139/143 signal deaths): the supervisor restarts this one at once.
GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT = 113

#############################################
# Activation checkpointing (runtime/activation_checkpointing.py)
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"

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
# Prompt-head reuse: a ref-counted trie over full prompt blocks.
SERVING_PREFIX_CACHE = "prefix_cache"
SERVING_PREFIX_CACHE_DEFAULT = False
# Chunked-prefill admission: decode tokens and budget-bounded prompt
# chunks share one ragged mixed step (kernel #2). A present block
# defaults to enabled.
SERVING_CHUNKED_PREFILL = "chunked_prefill"
SERVING_CHUNKED_ENABLED = "enabled"
SERVING_CHUNKED_TOKEN_BUDGET = "token_budget"  # tokens per mixed step
SERVING_CHUNKED_TOKEN_BUDGET_DEFAULT = 64
SUB_BLOCK_ENABLED = "enabled"
# Speculative decoding: a draft (the target's first ``draft_layers``
# layers) proposes ``k`` tokens a round, one target pass verifies them.
# On only with ``enabled: true``; greedy only.
SERVING_SPECULATIVE = "speculative"
SERVING_SPEC_K = "k"                          # draft tokens per round
SERVING_SPEC_K_DEFAULT = 4
SERVING_SPEC_DRAFT_LAYERS = "draft_layers"    # None -> num_layers // 2
# Serving resilience (serving/resilience.py): deadlines and cancel,
# admission control and shedding, decode recovery, the degradation
# ladder. A present block defaults to enabled.
SERVING_RESILIENCE = "resilience"
SERVING_RESIL_MAX_QUEUE_DEPTH = "max_queue_depth"      # None: unbounded
SERVING_RESIL_MAX_QUEUE_WAIT_MS = "max_queue_wait_ms"  # None: no wait gate
SERVING_RESIL_DEFAULT_DEADLINE_MS = "default_deadline_ms"  # None: none
SERVING_RESIL_MAX_RETRIES = "max_retries"    # decode-dispatch retries
SERVING_RESIL_MAX_RETRIES_DEFAULT = 2
SERVING_RESIL_RETRY_BASE_SEC = "retry_base_sec"
SERVING_RESIL_RETRY_BASE_SEC_DEFAULT = 0.05
SERVING_RESIL_DEGRADE_AFTER = "degrade_after"  # anomalies per ladder rung
SERVING_RESIL_DEGRADE_AFTER_DEFAULT = 2
SERVING_RESIL_SLOW_STEP_MS = "slow_step_ms"  # None: no slow-step anomaly
# the keys the reference's serving.resilience block takes
SERVING_RESILIENCE_KEYS = frozenset({
    SUB_BLOCK_ENABLED, SERVING_RESIL_MAX_QUEUE_DEPTH,
    SERVING_RESIL_MAX_QUEUE_WAIT_MS, SERVING_RESIL_DEFAULT_DEADLINE_MS,
    SERVING_RESIL_MAX_RETRIES, SERVING_RESIL_RETRY_BASE_SEC,
    SERVING_RESIL_DEGRADE_AFTER, SERVING_RESIL_SLOW_STEP_MS})

#############################################
# Telemetry: metrics registry, step tracer, recompile detector, the
# request accountant, and in training goodput and numerics (telemetry/).
# The fleet, memory and devicetime sub-blocks parse as the reference parses
# them and are refused when on.
#############################################
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_DIR = "dir"
TELEMETRY_DIR_DEFAULT = "telemetry"
TELEMETRY_TRACE = "trace"
TELEMETRY_TRACE_ENABLED = "enabled"
TELEMETRY_TRACE_ENABLED_DEFAULT = True
TELEMETRY_TRACE_FILE = "file"
TELEMETRY_TRACE_FILE_DEFAULT = "trace.json"
TELEMETRY_TRACE_SYNC_SPANS = "sync_spans"
TELEMETRY_TRACE_SYNC_SPANS_DEFAULT = True
# the reference's key; in the port a torch.profiler capture directory
TELEMETRY_TRACE_JAX_PROFILER_DIR = "jax_profiler_dir"
TELEMETRY_METRICS = "metrics"
TELEMETRY_METRICS_SINKS = "sinks"
TELEMETRY_METRICS_SINKS_DEFAULT = ("jsonl",)
TELEMETRY_METRICS_VALID_SINKS = ("jsonl", "tensorboard", "memory")
TELEMETRY_METRICS_UNPORTED_SINKS = ("tensorboard",)
TELEMETRY_METRICS_FILE = "file"
TELEMETRY_METRICS_FILE_DEFAULT = "metrics.jsonl"
TELEMETRY_RECOMPILE = "recompile_detection"
TELEMETRY_RECOMPILE_DEFAULT = True
# training's goodput accountant; serving builds none, as in the reference
TELEMETRY_GOODPUT = "goodput"
TELEMETRY_GOODPUT_DEFAULT = True
TELEMETRY_FLEET = "fleet"
TELEMETRY_FLEET_ENABLED = "enabled"
TELEMETRY_FLEET_ENABLED_DEFAULT = False
TELEMETRY_FLEET_WINDOW = "window"
TELEMETRY_FLEET_WINDOW_DEFAULT = 8
TELEMETRY_FLEET_MIN_WINDOW = "min_window"
TELEMETRY_FLEET_MIN_WINDOW_DEFAULT = 3
TELEMETRY_FLEET_ZSCORE = "zscore"
TELEMETRY_FLEET_ZSCORE_DEFAULT = 3.0
TELEMETRY_FLEET_PERSIST = "persist"
TELEMETRY_FLEET_PERSIST_DEFAULT = 3
TELEMETRY_FLEET_BREAKDOWN_FILE = "breakdown_file"
TELEMETRY_FLEET_BREAKDOWN_FILE_DEFAULT = "fleet_breakdown.json"
TELEMETRY_MEMORY = "memory"
TELEMETRY_MEMORY_ENABLED = "enabled"
TELEMETRY_MEMORY_ENABLED_DEFAULT = False
TELEMETRY_MEMORY_HEADROOM_WARN_FRAC = "headroom_warn_frac"
TELEMETRY_MEMORY_HEADROOM_WARN_FRAC_DEFAULT = 0.1
TELEMETRY_MEMORY_CRASHDUMP_DIR = "crashdump_dir"
TELEMETRY_MEMORY_CRASHDUMP_DIR_DEFAULT = "crashdumps"
TELEMETRY_MEMORY_OOM_EXIT_CODE = "oom_exit_code"
TELEMETRY_MEMORY_OOM_EXIT_CODE_DEFAULT = 114
TELEMETRY_MEMORY_PLAN_AT_INIT = "plan_at_init"
TELEMETRY_MEMORY_PLAN_AT_INIT_DEFAULT = True
TELEMETRY_MEMORY_PLAN_FILE = "plan_file"
TELEMETRY_MEMORY_PLAN_FILE_DEFAULT = "memory_plan.json"
TELEMETRY_MEMORY_ACT_BYTES = "activation_bytes_per_sample"
TELEMETRY_MEMORY_ACT_BYTES_DEFAULT = 0.0
TELEMETRY_MEMORY_HBM_LIMIT_GB = "hbm_limit_gb"
TELEMETRY_DEVICETIME = "devicetime"
TELEMETRY_DEVICETIME_ENABLED = "enabled"
TELEMETRY_DEVICETIME_ENABLED_DEFAULT = False
TELEMETRY_DEVICETIME_CAPTURE_STEPS = "capture_steps"
TELEMETRY_DEVICETIME_CAPTURE_STEPS_DEFAULT = 3
TELEMETRY_DEVICETIME_EVERY_STEPS = "every_steps"
TELEMETRY_DEVICETIME_EVERY_STEPS_DEFAULT = 200
TELEMETRY_DEVICETIME_KEEP_LAST = "keep_last"
TELEMETRY_DEVICETIME_KEEP_LAST_DEFAULT = 2
TELEMETRY_DEVICETIME_DIR = "dir"
TELEMETRY_DEVICETIME_DIR_DEFAULT = "devicetime"
TELEMETRY_DEVICETIME_TOP_K = "top_k"
TELEMETRY_DEVICETIME_TOP_K_DEFAULT = 10
TELEMETRY_DEVICETIME_DIVERGENCE_WARN = "divergence_warn"
TELEMETRY_DEVICETIME_DIVERGENCE_WARN_DEFAULT = 0.25
TELEMETRY_DEVICETIME_HBM_GBPS = "hbm_gbps"
# per-layer-group statistics in training, int8 KV-cache round-trip error
# gauges in serving
TELEMETRY_NUMERICS = "numerics"
TELEMETRY_NUMERICS_ENABLED = "enabled"
TELEMETRY_NUMERICS_ENABLED_DEFAULT = False
TELEMETRY_NUMERICS_MAX_GROUPS = "max_groups"
TELEMETRY_NUMERICS_MAX_GROUPS_DEFAULT = 16
TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS = "max_spike_dumps"
TELEMETRY_NUMERICS_MAX_SPIKE_DUMPS_DEFAULT = 8
# the per-request SLO accountant (telemetry/requests.py)
TELEMETRY_REQUESTS = "requests"
TELEMETRY_REQUESTS_ENABLED = "enabled"
TELEMETRY_REQUESTS_ENABLED_DEFAULT = False
TELEMETRY_REQUESTS_FILE = "file"
TELEMETRY_REQUESTS_FILE_DEFAULT = "requests.jsonl"
TELEMETRY_REQUESTS_WINDOW_SEC = "window_sec"
TELEMETRY_REQUESTS_WINDOW_SEC_DEFAULT = 10.0
