"""Activation checkpointing: the port of
``deepspeed_tpu/runtime/activation_checkpointing.py``.

``configure`` / ``is_configured`` / ``get_config`` / ``reset`` keep the
module-level config (the engine calls ``configure`` when its config has an
``activation_checkpointing`` block); ``checkpoint(function, *args)`` runs
``function`` now and recomputes its activations in the backward under the
policy the config maps to. Every policy is non-reentrant
``torch.utils.checkpoint``:

- default: save the outputs of plain matrix products (``aten.mm``,
  ``aten.addmm``) and recompute the rest, a selective policy, the torch
  form of JAX's ``dots_with_no_batch_dims_saveable`` (batched products,
  attention's among them, are recomputed as there);
- ``partition_activations``: save nothing, recompute everything (JAX's
  ``nothing_saveable``);
- ``cpu_checkpointing``: recompute everything and keep what the region
  saves, its inputs, in pinned host memory
  (``torch.autograd.graph.save_on_cpu``). JAX's
  ``offload_dot_with_no_batch_dims`` keeps the matrix products' outputs on
  the host instead and recomputes the rest; torch's selective policy
  holds what it saves in its own cache, out of reach of the saved-tensor
  hooks, so the port recomputes the products too.

``number_checkpoints``, ``contiguous_memory_optimization``,
``synchronize_checkpoint_boundary`` and ``profile`` are recorded only, as
in JAX. The models' ``remat`` flag recomputes each block whole
(:func:`module_checkpoint`) and does not read this policy, as JAX's
``nn.remat`` blocks pass none.
"""

import functools
from typing import Any, Callable, Optional

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

_config = None

# the products JAX's dots_with_no_batch_dims_saveable saves
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Set the module-level config from a parsed ``DeepSpeedConfig``'s
    ``activation_checkpointing`` block or from the keyword flags."""
    global _config
    from deepspeed_tpu_torch.config.config import \
        ActivationCheckpointingConfig

    if deepspeed_config is not None and hasattr(deepspeed_config,
                                                "activation_checkpointing"):
        _config = deepspeed_config.activation_checkpointing
    else:
        _config = ActivationCheckpointingConfig(
            partition_activations=bool(partition_activations or False),
            contiguous_memory_optimization=bool(
                contiguous_checkpointing or False),
            number_checkpoints=num_checkpoints,
            synchronize_checkpoint_boundary=bool(synchronize or False),
            profile=bool(profile or False),
            cpu_checkpointing=bool(checkpoint_in_cpu or False))
    return _config


def is_configured() -> bool:
    return _config is not None


def get_config():
    return _config


def reset():
    global _config
    _config = None


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(cfg=None) -> str:
    """The policy the config (the configured one by default) maps to:
    ``"save_matmuls"``, ``"nothing"`` or ``"offload_to_host"``."""
    cfg = cfg if cfg is not None else _config
    if cfg is not None and cfg.cpu_checkpointing:
        return "offload_to_host"
    if cfg is not None and cfg.partition_activations:
        return "nothing"
    return "save_matmuls"


def checkpoint(function: Callable, *args, **kwargs) -> Any:
    """``function(*args, **kwargs)`` now, its activations recomputed in
    the backward per the configured policy."""
    policy = remat_policy()
    if policy == "save_matmuls":
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_matmuls), **kwargs)
    if policy == "offload_to_host":
        with torch.autograd.graph.save_on_cpu(
                pin_memory=torch.cuda.is_available()):
            return torch.utils.checkpoint.checkpoint(
                function, *args, use_reentrant=False, **kwargs)
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kwargs)


def module_checkpoint(module: torch.nn.Module, fn: Callable, *args) -> Any:
    """``fn(*args)``, a computation over ``module``'s parameters, under
    non-reentrant ``torch.utils.checkpoint`` with no policy (everything
    recomputed). The module's parameters and buffers as they are now
    enter the checkpoint as inputs and are put back in place for the
    recompute: under the engine's ``functional_call`` they are the
    compute-dtype tensors the loss differentiates against, which the
    module no longer holds when the backward recomputes."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    n = len(named)

    def run(*flat):
        with _reparametrize_module(
                module, {k: t for (k, _), t in zip(named, flat[:n])}):
            return fn(*flat[n:])

    return torch.utils.checkpoint.checkpoint(
        run, *(t for _, t in named), *args, use_reentrant=False)
