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

Checkpointing: ``save_checkpoint`` / ``load_checkpoint`` write and read a
tag directory synchronously (``runtime/checkpointing.py``); with a
``resilience`` block the engine snapshots its state every
``checkpoint.interval`` steps and a background thread writes it
(``resilience/checkpoint.py``), ``auto_resume`` restores the newest
complete one, and the fault plan's preemption fires after the step's
snapshot. A restore copies into the live tensors in place: the masters
stay the module's parameters. An ``activation_checkpointing`` block
configures ``runtime/activation_checkpointing.py``.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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
    rng: torch.Generator           # CPU generator of the dropout seeds


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
    ``rng_seed`` (the seed of the step's dropout; ``state.rng``, the JAX
    state's ``rng`` leaf's counterpart), None in evaluation.
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
        if config.activation_checkpointing_provided:
            # an explicit block (re)configures the module-level policy; an
            # absent one leaves it to a later engine's block
            from deepspeed_tpu_torch.runtime import \
                activation_checkpointing as ac
            ac.configure(deepspeed_config=config)
        masters = []
        for name in self.param_names:
            p = params[name]
            if p.device != device or p.dtype != torch.float32:
                p = p.detach().to(device=device, dtype=torch.float32)
            masters.append(p.detach())
        # the micro-batches' dropout seeds, drawn on the host: a generator
        # on the card would synchronize every micro-step to give one up
        generator = torch.Generator(device="cpu")
        generator.manual_seed(int(rng_seed))
        self.state = TrainState(
            step=0, micro_step=0, params=masters,
            opt_state=self.optimizer.init(masters),
            grad_acc=[torch.zeros(p.shape, dtype=self.grad_accum_dtype,
                                  device=device) for p in masters],
            loss_scale=self.loss_scaler.init(), skipped_steps=0,
            rng=generator)
        # unscaled fp32 gradients: the same buffers every step
        self._grads32 = [torch.empty(p.shape, dtype=torch.float32,
                                     device=device) for p in masters]
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
        self._init_resilience(config.resilience)

    @property
    def generator(self) -> torch.Generator:
        return self.state.rng

    def _init_resilience(self, rcfg) -> None:
        """The fault plan (with ``resilience.enabled``, a
        ``fault_injection`` block or ``DSTPU_FAULT_PLAN``) and, with
        ``enabled``, the checkpoint manager. A plan that sets a key whose
        hook is not ported raises."""
        from deepspeed_tpu_torch.resilience.fault import (
            FaultPlan, check_training_plan)

        self.recovery_count = 0
        self.ckpt_manager = None
        self.fault_plan = None
        self._client_state_fn = None
        if (rcfg.enabled or rcfg.fault_injection
                or os.environ.get(C.FAULT_PLAN_ENV)):
            check_training_plan(rcfg.fault_injection)
            self.fault_plan = FaultPlan.resolve(rcfg.fault_injection)
        if rcfg.enabled:
            from deepspeed_tpu_torch.resilience import AsyncCheckpointManager

            ck = rcfg.checkpoint
            self.ckpt_manager = AsyncCheckpointManager(
                ck.dir, interval=ck.interval, keep_last=ck.keep_last,
                max_retries=ck.max_retries, backoff=ck.backoff_seconds,
                async_write=ck.async_write, fault_plan=self.fault_plan)

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

    def put_batch(self, batch, leading_gas_dim: bool = False):
        """The batch (a dict of numpy arrays or tensors) as tensors on the
        engine's device. A host tensor bound for the card is pinned first,
        so its copy is asynchronous (``runtime/dataloader.PrefetchLoader``
        overlaps it with the step); a tensor already there is kept. With
        ``leading_gas_dim`` each leaf's first dim must be
        ``gradient_accumulation_steps`` (the ``train_batch`` form)."""
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
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
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
        batches = self.put_batch(batches, leading_gas_dim=True)
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
        self._resilience_step_hook()
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
        loss = self._micro_step(self._compute_params, self.put_batch(batch))
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
        self._resilience_step_hook()

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """Deterministic loss of one batch on the compute-dtype params."""
        params = dict(zip(self.param_names,
                          self.precision.cast_params(self.state.params)))
        out = self.loss_fn(params, self.put_batch(batch), None)
        loss = out[0] if isinstance(out, tuple) else out
        return loss.float()

    # ------------------------------------------------------------------
    # resilience: auto checkpointing off the step path and auto-resume
    # ------------------------------------------------------------------
    def _resilience_step_hook(self) -> None:
        """After every optimizer step: the interval's snapshot (written in
        the background), then any injected preemption. Snapshot first,
        then preempt: the interrupted write is the torn-checkpoint case
        the manifest protocol handles."""
        mgr = self.ckpt_manager
        if mgr is not None and self.global_steps % mgr.interval == 0:
            self.save_checkpoint_async()
        fp = self.fault_plan
        if fp is not None and fp.should_preempt(self.global_steps):
            fp.preempt(self.global_steps)

    def register_client_state_fn(self, fn: Callable[[], Dict]) -> None:
        """A callable whose result rides every auto checkpoint as the
        client state (e.g. the dataloader's position)."""
        self._client_state_fn = fn

    def save_checkpoint_async(self,
                              client_state: Optional[Dict] = None) -> None:
        """Snapshot now, write in the background (the resilience
        manager)."""
        if self.ckpt_manager is None:
            raise RuntimeError(
                "save_checkpoint_async requires the resilience block: "
                '{"resilience": {"enabled": true, "checkpoint": {"dir": ...}}}')
        if client_state is None and self._client_state_fn is not None:
            client_state = self._client_state_fn()
        self.ckpt_manager.save(self, client_state=client_state)

    def auto_resume(self):
        """Restore from the newest complete resilience checkpoint under the
        configured dir. Returns (path, client_state); (None, {}) means a
        fresh start."""
        from deepspeed_tpu_torch.resilience import restore

        rcfg = self.config.resilience
        if not (rcfg.enabled and rcfg.auto_resume):
            return None, {}
        return restore(self, rcfg.checkpoint.dir)

    def _snapshot_state(self) -> List[Tuple[str, Any]]:
        """The state as named leaves, in ``TrainState`` order and under the
        JAX state's names (``params.<name>``, ``opt_state.exp_avg.<name>``,
        ``loss_scale.scale``, ...): the live tensors, numpy scalars for the
        counters and the generator's state (a uint8 tensor) as ``rng``."""
        st = self.state
        names = self.param_names
        i32 = np.int32
        out: List[Tuple[str, Any]] = [("step", i32(st.step)),
                                      ("micro_step", i32(st.micro_step))]
        out += [(f"params.{n}", p) for n, p in zip(names, st.params)]
        out.append(("opt_state.step", i32(st.opt_state.step)))
        for field in ("exp_avg", "exp_avg_sq"):
            out += [(f"opt_state.{field}.{n}", t)
                    for n, t in zip(names, getattr(st.opt_state, field))]
        out += [(f"grad_acc.{n}", t) for n, t in zip(names, st.grad_acc)]
        ls = st.loss_scale
        out += [("loss_scale.scale", np.float32(ls.scale)),
                ("loss_scale.good_steps", i32(ls.good_steps)),
                ("loss_scale.hysteresis", i32(ls.hysteresis)),
                ("skipped_steps", i32(st.skipped_steps)),
                ("rng", st.rng.get_state())]
        return out

    @torch.no_grad()
    def _apply_restored_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install named host arrays (a subset of :meth:`_snapshot_state`'s
        names, shapes checked by the caller): tensors are copied into the
        live ones in place (the masters stay the module's parameters; their
        version counters move, so the next forward recasts them), the
        counters and the generator state are set."""
        st = self.state
        for name, leaf in self._snapshot_state():
            if name not in arrays or not isinstance(leaf, torch.Tensor) \
                    or name == "rng":
                continue
            leaf.copy_(torch.from_numpy(np.ascontiguousarray(
                arrays[name])))

        def scalar(name, cast, default):
            return cast(arrays[name]) if name in arrays else default

        st.step = scalar("step", int, st.step)
        st.micro_step = scalar("micro_step", int, st.micro_step)
        st.skipped_steps = scalar("skipped_steps", int, st.skipped_steps)
        st.opt_state = st.opt_state._replace(
            step=scalar("opt_state.step", int, st.opt_state.step))
        ls = st.loss_scale
        st.loss_scale = LossScaleState(
            scale=scalar("loss_scale.scale", float, ls.scale),
            good_steps=scalar("loss_scale.good_steps", int, ls.good_steps),
            hysteresis=scalar("loss_scale.hysteresis", int, ls.hysteresis))
        if "rng" in arrays:
            st.rng.set_state(torch.from_numpy(
                np.asarray(arrays["rng"], dtype=np.uint8).copy()))
        self._compute_params = None

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> str:
        from deepspeed_tpu_torch.runtime import checkpointing

        return checkpointing.save_checkpoint(
            self, save_dir, tag=tag, client_state=client_state or {},
            save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True):
        from deepspeed_tpu_torch.runtime import checkpointing

        return checkpointing.load_checkpoint(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states)

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
