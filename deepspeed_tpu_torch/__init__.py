"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A package of its own beside the JAX package, held against it: same config
schema, same module paths, same outputs on the same weights. It imports
torch and numpy, never jax, flax or deepspeed_tpu. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``.

Ported so far: single-device training (``initialize`` -> ``train_batch``)
of the GPT-2 and BERT families with the flash-attention and fused-Adam
kernels, Adam or LAMB, block-sparse attention (the ``sparse_attention``
block) with its own kernels, the GPT's fused LayerNorm + projection sites
(``GPTConfig.fused_ln``) with theirs, ``DeepSpeedTransformerLayer``, and
continuous-batching GPT serving (``init_serving``) over the inference engine
(``init_inference``) with the paged decode-attention kernel, speculative
decoding, serving resilience (deadlines, shedding, recovery, the
degradation ladder, ``FaultPlan`` chaos) and serving telemetry (metrics,
a Chrome trace of the steps, per-request SLO records); the dataloader,
checkpoint save/load, preemption-safe training (checkpoints off the step
path, auto-resume, the supervisor) and activation checkpointing
(``remat``); every kernel written in CUDA for Hopper.
"""

import json
from typing import Any, Callable, Dict, Optional, Union

from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.version import __version__


def initialize(model=None, params: Optional[Dict[str, Any]] = None,
               config: Optional[Union[str, Dict[str, Any]]] = None,
               loss_fn: Optional[Callable] = None, device=None,
               optimizer=None, lr_scheduler=None, training_data=None,
               collate_fn=None, config_params=None, rng_seed: int = 0):
    """Build the training engine. Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``.

    Two entry styles, as in the JAX package:
    - module: ``model`` is an ``nn.Module`` whose forward returns the loss
      (or a dict holding ``"loss"``), e.g. the port's GPT or BERT;
      ``params`` an optional ``state_dict`` to load first. The module's
      parameters become the fp32 masters, on ``device``, and are trained
      in place;
    - functional: ``loss_fn(params, batch, rng)`` with ``params`` a dict
      of tensors.

    ``device`` None means the CUDA device; the CPU only when asked for.
    ``training_data``: an indexable dataset; the third value is then a
    ``DeepSpeedDataLoader`` over it with batches of the micro-batch size
    (one process: world 1, rank 0), stacked by ``collate_fn``
    (``default_collate`` by default); None without it.
    """
    import numpy as np
    import torch

    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.inference.engine import resolve_device
    from deepspeed_tpu_torch.models.adapter import module_loss_fn
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine,
                                                    engine_world_size)

    cfg = config if config is not None else config_params
    if not isinstance(cfg, DeepSpeedConfig):
        cfg = DeepSpeedConfig(cfg, world_size=engine_world_size())
    dev = resolve_device(device)
    if cfg.sparse_attention:
        model = _sparse_attention_surgery(model, loss_fn,
                                          cfg.sparse_attention)
    if loss_fn is None:
        if model is None:
            raise ValueError("initialize needs model= or loss_fn=")
        if params is not None:
            model.load_state_dict(
                {k: v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v))
                 for k, v in params.items()}, strict=True)
        model.to(device=dev, dtype=torch.float32)
        loss_fn, params = module_loss_fn(model)
    elif params is None:
        raise ValueError("initialize(loss_fn=...) needs params=")
    engine = DeepSpeedEngine(loss_fn, dict(params), cfg, device=dev,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             module=model, rng_seed=rng_seed)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=cfg.train_micro_batch_size_per_gpu,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


def _sparse_attention_surgery(model, loss_fn, block):
    """Config-driven sparse attention (``deepspeed_tpu/__init__.py:61-88``):
    an in-tree model whose config has a ``sparse_attention`` field (the GPT
    or BERT) gets the block in place (the same parameter tensors; nothing
    happens when its config already carries this block). A custom model or
    a ``loss_fn`` entry cannot be rerouted: a warning says so."""
    if model is not None and loss_fn is None and hasattr(model, "cfg") \
            and hasattr(model.cfg, "sparse_attention"):
        if model.cfg.sparse_attention != block:
            from deepspeed_tpu_torch.ops.sparse_attention.utils import \
                SparseAttentionUtils

            model = (SparseAttentionUtils.
                     replace_model_self_attention_with_sparse_self_attention(
                         model, block))
            log_dist(f"sparse_attention: routed {type(model).__name__} "
                     f"attention through mode="
                     f"{block.get('mode', 'fixed')}", ranks=[0])
    else:
        logger.warning(
            "sparse_attention config block with a custom model/loss_fn: no "
            "surgery applied — route attention through "
            "ops.sparse_attention.SparseSelfAttention yourself (see "
            "ops/sparse_attention/utils.py)")
    return model


def init_inference(model=None, **kwargs):
    """Inference engine entry: ``init_inference(model, params=state_dict,
    dtype=torch.bfloat16, device=None)``. ``device`` None means the CUDA
    device; the CPU only when asked for."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, **kwargs)


def init_serving(model=None,
                 config: Optional[Union[str, Dict[str, Any]]] = None,
                 **kwargs):
    """Serving engine entry: continuous batching over ``init_inference``.

    ``config``: a dict (or JSON path) whose ``serving`` block configures
    the engine (``ServingConfig`` keys), whose ``telemetry`` block, when
    enabled, wires the metrics sinks, the step trace, the request records
    (``telemetry.requests``) and the int8 KV error gauges
    (``telemetry.numerics``) into ``telemetry.dir``, and whose
    ``resilience.fault_injection`` block (with the ``DSTPU_FAULT_PLAN``
    override) is the serving chaos plan, as in the JAX package. Keys the
    port has not ported yet raise ``ConfigError``. Other kwargs go to
    ``init_inference`` (params, dtype, device, ...). Returns a step-driven
    ``ServeEngine``; its ``close()`` closes the telemetry files.
    """
    from deepspeed_tpu_torch.config.config import (ServingConfig,
                                                   TelemetryConfig,
                                                   check_serving_blocks)
    from deepspeed_tpu_torch.inference.engine import resolve_device
    from deepspeed_tpu_torch.resilience import FaultPlan
    from deepspeed_tpu_torch.serving.engine import ServeEngine
    from deepspeed_tpu_torch.telemetry import build_requests, build_telemetry

    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    config = dict(config or {})
    fault_block = check_serving_blocks(config)
    scfg = ServingConfig.from_dict(config.get("serving"))
    tcfg = TelemetryConfig.from_dict(config.get("telemetry"))
    fault_plan = (FaultPlan.resolve(fault_block) if fault_block is not None
                  else None)
    kwargs["device"] = resolve_device(kwargs.get("device"))
    tel = build_telemetry(tcfg, device=kwargs["device"])
    try:
        engine = init_inference(model, tracer=tel.tracer, **kwargs)
        return ServeEngine(engine, config=scfg, telemetry=tel,
                           measure_kv_quant_error=tcfg.numerics.enabled,
                           request_accountant=build_requests(tcfg, tel),
                           fault_plan=fault_plan)
    except BaseException:
        tel.close()      # the sink files and a profiler capture
        raise


__all__ = ["initialize", "init_inference", "init_serving", "log_dist",
           "logger", "__version__"]
