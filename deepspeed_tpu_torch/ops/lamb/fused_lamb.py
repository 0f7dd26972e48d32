"""LAMB over lists of fp32 tensors, functional.

The port of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (reference
``deepspeed/ops/lamb/fused_lamb.py``): Adam's moments, then a per-tensor
trust ratio ``||w|| / ||update||`` that rescales each tensor's step, for
large-batch pretraining (BERT-large in ``bench.py:bench_bert``).

The JAX function is plain ``jnp`` with no Pallas kernel, so this is plain
PyTorch too, written with the ``torch._foreach_*`` ops: each op runs once
over the whole list (a few multi-tensor launches on the card, where a
chain per tensor would launch ~13 ops for each of BERT-large's ~390
tensors). The op order of the JAX leaf is kept, each op rounding to fp32
on its own, so the two agree to the summation order of the norms. The one
op without a multi-tensor form is the per-tensor rescale by
``lr * trust``: a list of 0-d factors against full tensors, which
PyTorch runs tensor by tensor.

``update`` returns new lists and leaves its inputs untouched, as the JAX
function does; the engine copies the result into its masters.
"""

from typing import List, NamedTuple, Sequence

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import bias_corrections


class LambState(NamedTuple):
    step: int                        # optimizer steps taken
    exp_avg: List[torch.Tensor]      # m, fp32, one per parameter
    exp_avg_sq: List[torch.Tensor]   # v, fp32, one per parameter


class FusedLamb:
    """Functional LAMB on fp32 master params. Args mirror the JAX class:
    betas, eps, weight_decay (added to the update, not the gradient),
    bias_correction, and the trust ratio's clip ``[min_coeff,
    max_coeff]``."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 bias_correction: bool = True, max_coeff: float = 10.0,
                 min_coeff: float = 0.01):
        self.lr = float(lr)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.bias_correction = bool(bias_correction)
        self.max_coeff = float(max_coeff)
        self.min_coeff = float(min_coeff)

    def init(self, params: Sequence[torch.Tensor]) -> LambState:
        return LambState(
            step=0,
            exp_avg=[torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params],
            exp_avg_sq=[torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in params])

    def update(self, grads: Sequence[torch.Tensor], state: LambState,
               params: Sequence[torch.Tensor], lr=None):
        """One LAMB step. grads/params fp32; returns (new_params,
        new_state)."""
        step = state.step + 1
        if not params:
            return [], LambState(step=step, exp_avg=[], exp_avg_sq=[])
        b1, b2 = self.beta1, self.beta2
        dev = params[0].device
        lr = self.lr if lr is None else lr
        bc = bias_corrections(b1, b2, step, self.bias_correction)
        # fp32 device scalars (a tensor divisor divides; a Python one may
        # become a multiply by its reciprocal), copied from pinned memory
        # so that the copy does not wait for the card
        host = torch.tensor([float(lr), float(bc[0]), float(bc[1])],
                            dtype=torch.float32)
        if dev.type == "cuda":
            host = host.pin_memory()
        lr_t, bc1, bc2 = host.to(dev, non_blocking=True).unbind(0)
        params = list(params)
        g = [x if x.dtype == torch.float32 else x.float() for x in grads]
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
        m = torch._foreach_mul(state.exp_avg, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        v = torch._foreach_mul(state.exp_avg_sq, b2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_add_(v, sq)
        del sq
        # update = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p)
        upd = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        if self.weight_decay != 0.0:
            torch._foreach_add_(upd, torch._foreach_mul(params,
                                                        self.weight_decay))
        # trust = clip(||w|| / ||update||, min, max), 1 where a norm is 0
        w_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(upd))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        trust = trust.clamp(self.min_coeff, self.max_coeff)
        # p - (lr * trust) * update
        torch._foreach_mul_(upd, list((lr_t * trust).unbind(0)))
        new_p = torch._foreach_sub(params, upd)
        return new_p, LambState(step=step, exp_avg=m, exp_avg_sq=v)
