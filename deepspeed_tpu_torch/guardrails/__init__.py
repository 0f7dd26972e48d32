"""Training guardrails: the port of ``deepspeed_tpu/guardrails/``. Anomaly
detection, in-memory rollback and a step watchdog for unattended runs,
plus the shared retry helper.

The resilience tier survives a process's death and telemetry makes the
run observable; guardrails close the remaining gap, the run that neither
dies nor behaves:

- :class:`~deepspeed_tpu_torch.guardrails.detector.AnomalyDetector`: the
  EWMA z-score classification of every step's loss and global grad norm
  into ok / skip / spike, plus a non-finite check that works in bf16 (where
  the engine has no loss-scaler overflow path);
- :class:`~deepspeed_tpu_torch.guardrails.rollback.RollbackPolicy` over a
  :class:`~deepspeed_tpu_torch.guardrails.rollback.SnapshotRing`: restore
  the last good in-memory state after N spikes in a row, move the data
  stream past the window, optionally decay the LR, escalate to the on-disk
  resilience checkpoint when the ring is empty;
- :class:`~deepspeed_tpu_torch.guardrails.watchdog.StepWatchdog`: a hung
  step dumps diagnostics and exits with a distinct code that the
  supervisor restarts at once;
- :mod:`~deepspeed_tpu_torch.guardrails.retry`: the jittered exponential
  backoff of the checkpoint writer and the supervisor.

Cost: ``build_guardrails`` returns ``None`` for a disabled block and every
engine hook is behind an ``is None`` check, so a guardrails-off step reads
nothing on the host, syncs nothing and snapshots nothing. Enabled, a step
costs one read of its stacked (loss, grad norm) through :func:`_host_fetch`
plus a ring snapshot every ``snapshot_interval`` steps.
"""

import json
import os
from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.guardrails.detector import (OK, SKIP, SPIKE,
                                                     AnomalyDetector,
                                                     EWMATracker, Verdict)
from deepspeed_tpu_torch.guardrails.retry import backoff_delay, retry_call
from deepspeed_tpu_torch.guardrails.rollback import (GuardrailsError,
                                                     RollbackPolicy,
                                                     SnapshotRing,
                                                     restore_snapshot,
                                                     take_snapshot)
from deepspeed_tpu_torch.guardrails.watchdog import (StepWatchdog,
                                                     is_watchdog_exit)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "OK", "SKIP", "SPIKE", "AnomalyDetector", "EWMATracker", "Verdict",
    "backoff_delay", "retry_call", "GuardrailsError", "RollbackPolicy",
    "SnapshotRing", "restore_snapshot", "take_snapshot", "StepWatchdog",
    "is_watchdog_exit", "Guardrails", "build_guardrails",
]


def _host_fetch(x: torch.Tensor):
    """The device-to-host read of this subsystem and of the engine's
    non-finite gate: one site, so a test counts every read by patching this
    name. A 0-d tensor comes back as a Python number, a vector as a
    list."""
    return x.tolist()


def _finite(z: float, cap: float = 1e9) -> float:
    """Clamp a z-score for a metric (inf is not JSON)."""
    return max(-cap, min(cap, z))


class Guardrails:
    """Per-engine facade over the detector, the rollback and the watchdog.

    The engine owns three call sites: ``step_begin`` / ``step_end`` around
    the step (the watchdog's deadline) and ``after_step`` with the step's
    loss, overflow flag and grad norm (the detector and the policy)."""

    def __init__(self, cfg, telemetry=None, metrics_path: Optional[str] = None,
                 goodput=None):
        self.cfg = cfg
        self.telemetry = telemetry
        self.goodput = goodput
        self.detector = AnomalyDetector(
            zscore_threshold=cfg.detector.zscore_threshold,
            warmup_steps=cfg.detector.warmup_steps,
            ewma_alpha=cfg.detector.ewma_alpha,
            track_grad_norm=cfg.detector.track_grad_norm)
        self.ring: Optional[SnapshotRing] = None
        self.policy: Optional[RollbackPolicy] = None
        if cfg.rollback.enabled:
            self.ring = SnapshotRing(cfg.rollback.ring_size)
            self.policy = RollbackPolicy(
                self.ring,
                consecutive_spikes=cfg.rollback.consecutive_spikes,
                skip_batches=cfg.rollback.skip_batches,
                lr_decay=cfg.rollback.lr_decay,
                max_rollbacks=cfg.rollback.max_rollbacks,
                escalate_to_disk=cfg.rollback.escalate_to_disk)
        self.watchdog: Optional[StepWatchdog] = None
        if cfg.watchdog.enabled:
            self.watchdog = StepWatchdog(
                timeout=cfg.watchdog.step_timeout_seconds,
                crashdump_dir=cfg.watchdog.crashdump_dir,
                exit_code=cfg.watchdog.exit_code,
                poll_interval=cfg.watchdog.poll_interval_seconds,
                telemetry=telemetry,
                metrics_tail_of=metrics_path).start()
        self._data_skip_fn: Optional[Callable[[int], None]] = None
        self.last_verdict: Optional[Verdict] = None
        # spike verdicts name the worst layer group (telemetry/numerics.py)
        # and leave a bounded number of spike dumps naming it
        self.metrics_path = metrics_path
        self._spike_dumps = 0

    # ------------------------------------------------------------------
    @property
    def lr_scale(self) -> float:
        return self.policy.lr_scale if self.policy is not None else 1.0

    def register_data_skip_fn(self, fn: Callable[[int], None]) -> None:
        self._data_skip_fn = fn

    def step_begin(self, step: int, label: str = "train_step") -> None:
        if self.watchdog is not None:
            self.watchdog.step_begin(step, label)

    def step_end(self) -> None:
        if self.watchdog is not None:
            self.watchdog.step_end()

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()

    # ------------------------------------------------------------------
    def after_step(self, engine, loss: torch.Tensor, overflow: bool,
                   norm: torch.Tensor) -> bool:
        """Feed one committed step through detection and policy. ``loss``
        and ``norm``: the step's 0-d tensors, read together in one fetch;
        ``overflow``: whether the engine skipped the update (a bool it
        already read). Returns True when a rollback rewound the engine
        (the caller then skips its own fail-fast numerics check for this
        step)."""
        step = int(engine.global_steps)
        lossf, normf = _host_fetch(torch.stack(
            [loss.detach().float(), norm.detach().float()]))
        verdict = self.detector.observe(step, lossf, grad_norm=normf,
                                        overflow=bool(overflow))
        self.last_verdict = verdict
        # a spike names the worst layer group: the first with a non-finite
        # grad norm, else the largest grad-to-weight ratio (one more read,
        # on spike verdicts only)
        worst = None
        numerics = getattr(engine, "numerics", None)
        if verdict.kind == SPIKE and numerics is not None:
            try:
                worst = numerics.worst_group()
            except Exception as e:  # noqa: BLE001 - naming is best-effort
                logger.warning("guardrails: numerics worst_group failed: "
                               "%s", e)
        self._emit(step, verdict, worst_group=worst)
        if verdict.kind == SPIKE:
            logger.warning(
                "guardrails: spike verdict at step %d (%s: loss=%.6g "
                "loss_z=%.3g norm_z=%.3g%s, streak %d/%s)", step,
                verdict.reason, lossf, verdict.loss_z, verdict.norm_z,
                f", worst layer group '{worst}'" if worst else "",
                (self.policy.spike_streak + 1) if self.policy else 1,
                self.policy.consecutive_spikes if self.policy else "-")
            if numerics is not None:
                self._write_spike_dump(step, verdict, worst, numerics)
            if self.policy is not None and self.policy.note_spike():
                # recovery is not a step: a disk restore or a long loader
                # skip must not trip the step deadline
                if self.watchdog is not None:
                    self.watchdog.suspend()
                if self.goodput is not None:
                    # the restore and loader skip are lost time of their
                    # own; the engine books the re-executed steps as
                    # rollback_replay
                    with self.goodput.measure("rollback_restore"):
                        summary = self.policy.rollback(engine,
                                                       self._data_skip_fn)
                else:
                    summary = self.policy.rollback(engine, self._data_skip_fn)
                self._emit_rollback(step, summary)
                return True
        elif verdict.kind == OK:
            if self.policy is not None:
                self.policy.note_ok()
            # prime the ring at the first ok step (a spike before the first
            # interval boundary would otherwise find it empty), then
            # refresh every snapshot_interval steps
            if self.ring is not None and (
                    len(self.ring) == 0
                    or step % self.cfg.rollback.snapshot_interval == 0):
                self.ring.take(engine)
                self._counter("guardrails/snapshots", step)
        return False

    # ------------------------------------------------------------------
    def _emit(self, step: int, verdict: Verdict,
              worst_group: Optional[str] = None) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        reg = tel.registry
        reg.counter(f"guardrails/steps_{verdict.kind}").inc(step=step)
        reg.gauge("guardrails/loss_zscore").set(_finite(verdict.loss_z),
                                                step=step)
        if verdict.norm_z:
            reg.gauge("guardrails/grad_norm_zscore").set(
                _finite(verdict.norm_z), step=step)
        if verdict.kind == SPIKE:
            extra = ({"worst_group": worst_group} if worst_group else {})
            tel.instant("guardrails_spike", step=step, reason=verdict.reason,
                        loss_z=_finite(verdict.loss_z), **extra)

    def _write_spike_dump(self, step: int, verdict: Verdict,
                          worst_group: Optional[str], numerics) -> None:
        """The spike dump: a directory naming the worst layer group, with
        the whole per-group numerics table and the metrics tail. Bounded
        by ``telemetry.numerics.max_spike_dumps`` (spikes can streak; the
        disk must not fill)."""
        budget = int(getattr(numerics.cfg, "max_spike_dumps", 8))
        if self._spike_dumps >= budget:
            return
        out = os.path.join(self.cfg.watchdog.crashdump_dir,
                           f"spike_step{step}_{os.getpid()}")
        try:
            os.makedirs(out, exist_ok=True)
            info = {
                "kind": "spike",
                "step": int(step),
                "reason": verdict.reason,
                "loss_z": _finite(verdict.loss_z),
                "norm_z": _finite(verdict.norm_z),
                "worst_group": worst_group,
                "groups": numerics.group_table(),
            }
            with open(os.path.join(out, "info.json"), "w") as f:
                json.dump(info, f, indent=1)
            from deepspeed_tpu_torch.telemetry.memory import \
                write_metrics_tail
            write_metrics_tail(out, self.metrics_path)
            self._spike_dumps += 1
            logger.warning("guardrails: spike crashdump written to %s "
                           "(worst layer group: %s)", out, worst_group)
        except Exception as e:  # noqa: BLE001 - a diagnostic dump must
            # never take down the training loop it diagnoses
            logger.warning("guardrails: spike crashdump failed: %s", e)

    def _emit_rollback(self, step: int, summary: dict) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.registry.counter("guardrails/rollbacks").inc(step=step)
        tel.instant("guardrails_rollback", step=step, **{
            k: v for k, v in summary.items() if v is not None})

    def _counter(self, name: str, step: int) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.registry.counter(name).inc(step=step)


def build_guardrails(gcfg, telemetry=None,
                     metrics_path: Optional[str] = None,
                     goodput=None) -> Optional[Guardrails]:
    """``None`` for a disabled block: the engine's hooks test ``is None``,
    which is the whole cost of guardrails that are off."""
    if gcfg is None or not gcfg.enabled:
        return None
    return Guardrails(gcfg, telemetry=telemetry, metrics_path=metrics_path,
                      goodput=goodput)
