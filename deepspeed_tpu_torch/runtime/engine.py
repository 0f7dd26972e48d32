"""The training engine.

The port of ``deepspeed_tpu/runtime/engine.py`` for one process on one
device: fp32 master params, the optimizer state (Adam's or LAMB's), a
gradient accumulator in ``data_types.grad_accum_dtype`` and the
loss-scale state.

- ``train_batch(batches)`` takes batches with a leading
  gradient-accumulation dim. It casts the masters to the compute dtype
  once (hoisted out of the accumulation loop), runs forward and backward
  per micro-batch on the scaled loss ``loss32 * scale / gas``, adds each
  micro-batch's gradients into the accumulator in its dtype (a bf16
  accumulator sums in bf16, as the JAX step does), then applies the
  optimizer at the one apply site, :meth:`DeepSpeedEngine._apply_step`.
- ``forward``/``backward``/``step`` are the reference API over the same
  micro-step and apply.

The apply: unscale into fp32 gradient buffers -> overflow check (fp16 only;
one read of a flag by the host) -> global norm -> clip -> the update
(``FusedAdam.update`` or ``FusedLamb.update``, or for Adam the one
multi-tensor kernel with ``optimizer.fused_update``) -> skip on overflow ->
loss-scale update -> zero the accumulator. The masters are the module's
parameter tensors and are updated in place. With ``optimizer.fused_update``
and a compute dtype below fp32, the kernel also writes the new masters in
that dtype, into buffers the engine keeps: the next step's forward reads
those instead of casting the masters again.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.config.config import (ConfigError, DeepSpeedConfig,
                                               not_yet_ported)
from deepspeed_tpu_torch.ops.adam.fused_adam import (AdamState, FusedAdam,
                                                     FusedAdamW)
from deepspeed_tpu_torch.ops.adam.fused_update import fused_adam_apply
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
from deepspeed_tpu_torch.runtime.precision import (LossScaleState,
                                                   PrecisionPolicy,
                                                   make_loss_scaler)
from deepspeed_tpu_torch.runtime.utils import (clip_coef, global_norm,
                                               has_inf_or_nan)
from deepspeed_tpu_torch.utils.logging import log_dist


# The optimizers the engine builds, and their states.
Optimizer = Union[FusedAdam, FusedLamb]
OptState = Union[AdamState, LambState]


@dataclass
class TrainState:
    """Everything that evolves during training."""

    step: int                      # optimizer steps taken (not skipped)
    micro_step: int                # micro-batches seen
    params: List[torch.Tensor]     # fp32 masters
    opt_state: OptState
    grad_acc: List[torch.Tensor]   # in grad_accum_dtype
    loss_scale: LossScaleState
    skipped_steps: int             # overflow-skipped steps


def configure_optimizer(config: DeepSpeedConfig) -> Optimizer:
    """The config's optimizer: Adam (``adam_w_mode`` defaults to True, as
    in the JAX package), AdamW or LAMB; Adam with default params when the
    config has no optimizer block. A param the class does not take raises
    TypeError, as in the JAX package."""
    name = config.optimizer_name or C.ADAM_OPTIMIZER
    params = dict(config.optimizer_params)
    params.pop(C.MAX_GRAD_NORM, None)   # the engine owns clipping
    if name == C.LAMB_OPTIMIZER:
        return FusedLamb(**params)
    params.pop("torch_adam", None)
    if name == C.ADAM_OPTIMIZER:
        return FusedAdam(adamw_mode=params.pop("adam_w_mode", True),
                         **params)
    return FusedAdamW(**params)


class DeepSpeedEngine:
    """One-device training engine over a ``loss_fn(params, batch, rng)``.

    ``params``: an ordered dict name -> tensor, the fp32 masters; the
    engine updates these tensors in place (pass a module's parameters to
    train the module). ``device``: where they live. ``rng``: a host int in
    [-2**31, 2**31) drawn per micro-batch from a CPU generator seeded with
    ``rng_seed`` (the seed of the step's dropout), None in evaluation.
    """

    def __init__(self, loss_fn: Callable, params: Dict[str, torch.Tensor],
                 config: DeepSpeedConfig, device: torch.device,
                 optimizer: Optional[Optimizer] = None, lr_scheduler=None,
                 module: Optional[torch.nn.Module] = None,
                 rng_seed: int = 0):
        if config.world_size != 1:
            raise not_yet_ported(f"data parallelism over "
                                 f"{config.world_size} processes")
        self.config = config
        self.loss_fn = loss_fn
        self.module = module
        self.device = device
        self.precision = PrecisionPolicy(config.precision_dtype)
        self.grad_accum_dtype = (torch.bfloat16 if config.grad_accum_dtype
                                 in ("bfloat16", "bf16") else torch.float32)
        fp16 = config.fp16
        self.loss_scaler = make_loss_scaler(
            fp16_enabled=fp16.enabled, dynamic=fp16.dynamic_loss_scale,
            static_scale=fp16.loss_scale or 1.0,
            initial_scale_power=fp16.initial_scale_power,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self.optimizer = (optimizer if optimizer is not None
                          else configure_optimizer(config))
        self.lr_scheduler = (lr_scheduler if lr_scheduler is not None
                             else build_lr_schedule(config.scheduler_name,
                                                    config.scheduler_params))
        self._base_lr = getattr(self.optimizer, "lr", 1e-3)
        self._fused_update = bool(config.optimizer_fused_update)
        if self._fused_update and not isinstance(self.optimizer, FusedAdam):
            raise ConfigError(
                f"optimizer.fused_update requires the Adam family (got "
                f"{type(self.optimizer).__name__}): the kernel bakes in the "
                f"Adam recurrence")
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.steps_per_print = config.steps_per_print

        self.param_names = list(params)
        masters = []
        for name in self.param_names:
            p = params[name]
            if p.device != device or p.dtype != torch.float32:
                p = p.detach().to(device=device, dtype=torch.float32)
            masters.append(p.detach())
        self.state = TrainState(
            step=0, micro_step=0, params=masters,
            opt_state=self.optimizer.init(masters),
            grad_acc=[torch.zeros(p.shape, dtype=self.grad_accum_dtype,
                                  device=device) for p in masters],
            loss_scale=self.loss_scaler.init(), skipped_steps=0)
        # unscaled fp32 gradients: the same buffers every step
        self._grads32 = [torch.empty(p.shape, dtype=torch.float32,
                                     device=device) for p in masters]
        # the micro-batches' dropout seeds, drawn on the host: a generator
        # on the card would synchronize every micro-step to give one up
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(rng_seed))
        self.global_steps = 0
        self.micro_steps = 0
        self._micro_in_window = 0
        self._compute_params = None
        # the fused update's compute-dtype copy of the masters, and the
        # masters' version counters when it was written
        self._casts: Optional[List[torch.Tensor]] = None
        self._cast_versions: Optional[List[int]] = None
        self._last_loss = None
        self._last_norm = None

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _make_compute_params(self) -> List[torch.Tensor]:
        """Leaf tensors in the compute dtype that the loss differentiates
        against (the masters themselves, detached, in fp32). The fused
        update's copy stands in for the cast while no in-place write to a
        master has bumped its version counter since the update wrote it."""
        src = self.state.params
        if self._cast_versions is not None and self._cast_versions == [
                p._version for p in src]:
            src = self._casts
        else:
            src = self.precision.cast_params(src)
        return [t.detach().requires_grad_() for t in src]

    def _put(self, batch, leading_gas_dim: bool = False):
        """The batch as tensors on the device (numpy arrays and tensors
        alike)."""
        out = {}
        for k, x in batch.items():
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            if leading_gas_dim and t.shape[0] != \
                    self.gradient_accumulation_steps:
                raise ValueError(
                    f"train_batch: leaf {k!r} has leading dim "
                    f"{t.shape[0]}, expected gradient_accumulation_steps="
                    f"{self.gradient_accumulation_steps}")
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _micro_step(self, compute: List[torch.Tensor], batch) -> torch.Tensor:
        """Forward and backward of one micro-batch; adds its gradients into
        the accumulator. Returns the fp32 loss (unscaled). The loss
        function's ``rng`` is a host int, one draw per micro-step."""
        cfg = self.config
        scale = self.state.loss_scale.scale if cfg.fp16.enabled else 1.0
        seed = int(torch.randint(-2 ** 31, 2 ** 31, (),
                                 generator=self.generator))
        out = self.loss_fn(dict(zip(self.param_names, compute)), batch,
                           seed)
        loss = out[0] if isinstance(out, tuple) else out
        loss32 = loss.float()
        scaled = loss32 * scale / self.gradient_accumulation_steps
        if cfg.prescale_gradients:
            scaled = scaled / cfg.world_size * cfg.gradient_predivide_factor
        grads = torch.autograd.grad(scaled, compute, allow_unused=True)
        for acc, g in zip(self.state.grad_acc, grads):
            if g is not None:
                acc.add_(g.to(acc.dtype))
        self.state.micro_step += 1
        return loss32.detach()

    def _apply_step(self, lr: float) -> bool:
        """The one apply site: unscale -> overflow -> norm -> clip ->
        update -> overflow skip -> loss-scale update -> zero the
        accumulator. Returns whether the step overflowed."""
        cfg = self.config
        st = self.state
        fp16 = cfg.fp16.enabled
        inv = 1.0 / st.loss_scale.scale if fp16 else 1.0
        if cfg.prescale_gradients:
            inv = inv * cfg.world_size / cfg.gradient_predivide_factor
        grads = self._grads32
        for g32, acc in zip(grads, st.grad_acc):
            g32.copy_(acc)
        if inv != 1.0:
            torch._foreach_mul_(grads, inv)
        overflow = bool(has_inf_or_nan(grads)) if fp16 else False
        norm = global_norm(grads)
        if cfg.gradient_clipping > 0.0:
            torch._foreach_mul_(grads, clip_coef(cfg.gradient_clipping,
                                                 norm))
        if not overflow:
            if self._fused_update:
                casts = None
                if self.precision.mixed:
                    if self._casts is None:
                        self._casts = [torch.empty(
                            p.shape, dtype=self.precision.dtype,
                            device=p.device) for p in st.params]
                    casts = self._casts
                st.opt_state = fused_adam_apply(
                    self.optimizer, grads, st.opt_state, st.params, lr=lr,
                    cast_dtype=None if casts is None
                    else self.precision.dtype,
                    cast_out=casts)[1]
                if casts is not None:
                    self._cast_versions = [p._version for p in st.params]
            else:
                new_p, st.opt_state = self.optimizer.update(
                    grads, st.opt_state, st.params, lr=lr)
                for p, n in zip(st.params, new_p):
                    p.copy_(n)
            st.step += 1
        else:
            st.skipped_steps += 1
        st.loss_scale = self.loss_scaler.update(st.loss_scale, overflow)
        torch._foreach_zero_(st.grad_acc)
        self._last_norm = norm
        return overflow

    def _current_lr(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler.lr_at(self.global_steps)
        return float(self._base_lr)

    def _after_step(self, loss) -> None:
        self.global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self._current_lr():.3e} "
                     f"loss_scale={self.state.loss_scale.scale:.1f}",
                     ranks=[0])

    def train_batch(self, batches) -> torch.Tensor:
        """One optimizer step over ``batches``, a dict whose leaves have a
        leading dim of gradient_accumulation_steps. Returns the mean fp32
        loss of the micro-batches (a device tensor; nothing waits for
        it)."""
        gas = self.gradient_accumulation_steps
        batches = self._put(batches, leading_gas_dim=True)
        lr = self._current_lr()
        compute = self._make_compute_params()   # hoisted out of the loop
        losses = [self._micro_step(compute, {k: v[i] for k, v in
                                             batches.items()})
                  for i in range(gas)]
        del compute
        self._apply_step(lr)
        self.micro_steps += gas
        loss = torch.stack(losses).mean()
        self._last_loss = loss
        self._after_step(loss)
        return loss

    # ------------------------------------------------------------------
    # the reference API
    # ------------------------------------------------------------------
    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch) -> torch.Tensor:
        """Forward and backward of one micro-batch, accumulating its
        gradients (the backward cannot be split off an eager autograd
        pass any more than off the JAX program: :meth:`backward` only
        counts)."""
        if self._compute_params is None:
            self._compute_params = self._make_compute_params()
        loss = self._micro_step(self._compute_params, self._put(batch))
        self._last_loss = loss
        return loss

    def backward(self, loss=None, allreduce_gradients: bool = True):
        self.micro_steps += 1
        self._micro_in_window += 1
        return loss if loss is not None else self._last_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_in_window >= self.gradient_accumulation_steps

    def step(self) -> None:
        """The optimizer step at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._compute_params = None
        self._apply_step(self._current_lr())
        self._micro_in_window = 0
        self._after_step(self._last_loss)

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """Deterministic loss of one batch on the compute-dtype params."""
        params = dict(zip(self.param_names,
                          self.precision.cast_params(self.state.params)))
        out = self.loss_fn(params, self._put(batch), None)
        loss = out[0] if isinstance(out, tuple) else out
        return loss.float()

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    def get_global_grad_norm(self) -> float:
        """The norm of the gradient accumulator as it stands (zero right
        after an optimizer step), as the JAX engine reports it."""
        return float(global_norm(self.state.grad_acc))

    def zero_optimization(self) -> bool:
        return self.config.zero_enabled

    def zero_optimization_stage(self) -> int:
        return self.config.zero_config.stage

    def get_lr(self) -> List[float]:
        return [self._current_lr()]

    @property
    def skipped_steps(self) -> int:
        return self.state.skipped_steps

    def loss_scale(self) -> float:
        return float(self.state.loss_scale.scale)


def engine_world_size() -> int:
    """Processes of the default process group, 1 without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
