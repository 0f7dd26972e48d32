"""Model adapters.

The port of ``deepspeed_tpu/models/adapter.py``. The engine consumes a
``loss_fn(params, batch, rng) -> loss`` (or ``(loss, aux)``) over a dict
of parameter tensors; :func:`module_loss_fn` builds one from an
``nn.Module`` whose forward returns the loss (or a dict holding it),
running the module with the given tensors in place of its own parameters
(``torch.func.functional_call``). ``rng`` None means evaluation: the
module runs with ``deterministic=True``. In training the engine passes a
host int drawn for the micro-batch (where JAX passes a PRNG key); it
reaches the forward as ``dropout_seed`` when the forward takes one.
"""

import inspect
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call


def module_loss_fn(module: torch.nn.Module,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   loss_key: str = "loss"
                   ) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Adapt ``module``; returns ``(loss_fn, params)``, where ``params``
    defaults to the module's own named parameters. A batch is a dict of the
    forward's keyword arguments (``input_ids``, ``labels``, ...)."""
    if params is None:
        params = {k: p.detach() for k, p in module.named_parameters()}
    sig = inspect.signature(module.forward).parameters
    takes_det = "deterministic" in sig
    takes_seed = "dropout_seed" in sig

    def loss_fn(p, batch, rng):
        kwargs = dict(batch)
        if takes_det:
            kwargs["deterministic"] = rng is None
        if takes_seed and rng is not None:
            kwargs["dropout_seed"] = rng
        out = functional_call(module, p, (), kwargs)
        if isinstance(out, dict):
            loss = out[loss_key]
            return loss, {k: v for k, v in out.items() if k != loss_key}
        return out

    return loss_fn, params
