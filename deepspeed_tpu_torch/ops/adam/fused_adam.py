"""Adam/AdamW over lists of fp32 tensors, functional.

The port of ``deepspeed_tpu/ops/adam/fused_adam.py``: the update runs in
fp32 on the master params, with the leaf op order of the JAX chain kept
exactly (``fused_update.py``'s kernel and its plain version repeat it).
``update`` returns new lists and leaves its inputs untouched, as the JAX
function does; the engine copies the result into its masters.
"""

from typing import List, NamedTuple, Sequence

import numpy as np
import torch


class AdamState(NamedTuple):
    step: int                        # optimizer steps taken
    exp_avg: List[torch.Tensor]      # m, fp32, one per parameter
    exp_avg_sq: List[torch.Tensor]   # v, fp32, one per parameter


def bias_corrections(beta1: float, beta2: float, step: int,
                     enabled: bool = True):
    """``(1 - b1**step, 1 - b2**step)`` in float32 arithmetic, as the JAX
    update takes them from its int32 step counter."""
    if not enabled:
        return np.float32(1.0), np.float32(1.0)
    s = np.float32(step)
    one = np.float32(1.0)
    return (one - np.float32(beta1) ** s, one - np.float32(beta2) ** s)


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lr, bc1, bc2, *, b1: float, b2: float,
              eps: float, weight_decay: float, adamw_mode: bool):
    """One leaf of the update, in the JAX chain's op order; ``lr``,
    ``bc1``, ``bc2`` are fp32 scalars (tensors or numbers). Each op rounds
    to fp32 on its own: no multiply-add is fused. Returns (p', m', v')."""
    g = g.float()
    if weight_decay != 0.0 and not adamw_mode:
        g = g + weight_decay * p            # classic L2 into the gradient
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    denom = torch.sqrt(v / bc2) + eps
    update = (m / bc1) / denom
    if weight_decay != 0.0 and adamw_mode:
        update = update + weight_decay * p  # decoupled decay
    return p - lr * update, m, v


class FusedAdam:
    """Functional Adam(W) on fp32 master params.

    Args mirror the JAX class: betas, eps, weight_decay, adamw_mode (True
    => decoupled weight decay), bias_correction; amsgrad is refused.
    """

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True,
                 amsgrad: bool = False):
        if amsgrad:
            raise NotImplementedError("amsgrad not supported (parity with "
                                      "the JAX FusedAdam)")
        self.lr = float(lr)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.bias_correction = bool(bias_correction)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            step=0,
            exp_avg=[torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params],
            exp_avg_sq=[torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in params])

    def step_scalars(self, step: int, lr=None, device=None) -> torch.Tensor:
        """``[lr, bc1, bc2]`` as one fp32 tensor on ``device`` for the
        update that makes ``step`` (the first update is step 1)."""
        lr = self.lr if lr is None else lr
        bc1, bc2 = bias_corrections(self.beta1, self.beta2, step,
                                    self.bias_correction)
        host = torch.tensor([np.float32(lr), bc1, bc2], dtype=torch.float32)
        if device is None or torch.device(device).type != "cuda":
            return host if device is None else host.to(device)
        # pinned and asynchronous: the copy does not wait for the card
        return host.pin_memory().to(device, non_blocking=True)

    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor], lr=None):
        """One Adam step. grads/params fp32; returns (new_params,
        new_state)."""
        step = state.step + 1
        device = params[0].device if len(params) else None
        lr_t, bc1, bc2 = self.step_scalars(step, lr, device)
        outs = [adam_leaf(p, g, m, v, lr_t, bc1, bc2, b1=self.beta1,
                          b2=self.beta2, eps=self.eps,
                          weight_decay=self.weight_decay,
                          adamw_mode=self.adamw_mode)
                for p, g, m, v in zip(params, grads, state.exp_avg,
                                      state.exp_avg_sq)]
        return ([o[0] for o in outs],
                AdamState(step=step, exp_avg=[o[1] for o in outs],
                          exp_avg_sq=[o[2] for o in outs]))


class FusedAdamW(FusedAdam):
    def __init__(self, **kwargs):
        kwargs.setdefault("adamw_mode", True)
        super().__init__(**kwargs)
