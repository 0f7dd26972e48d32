"""In-memory rollback: the port of ``deepspeed_tpu/guardrails/rollback.py``.
A bounded ring of last-good state snapshots plus the policy that decides
when to restore one.

The resilience tier (``resilience/checkpoint.py``) already snapshots an
engine to host memory and copies saved arrays back into it; the ring rides
that machinery. What differs is where the snapshot lives (host memory,
never disk) and why it is restored (a numeric anomaly, not a process
death): the disk path costs a full read and loses up to
``checkpoint.interval`` steps; the ring restores with one copy per leaf
and loses only the steps since its newest push.

The port updates its state in place, so a snapshot is a set of host
buffers (pinned on the card) that the device-to-host copies land in. The
ring owns one buffer pool: a snapshot that leaves the ring (evicted by a
newer push, dropped after a restore) gives its set back, and the next
snapshot reuses it, so a ring of ``capacity`` holds at most ``capacity``
sets of pinned memory for the whole run (at GPT-2 about 1.74 GB each: the
fp32 masters, Adam's two moments and the bf16 accumulator).

Policy (:class:`RollbackPolicy`): after ``consecutive_spikes`` spike
verdicts in a row, restore the newest ring snapshot, ask the data pipeline
to skip ``skip_batches`` batches, optionally decay the LR, and count the
rollback against ``max_rollbacks``. With the ring empty the policy
escalates to the newest on-disk resilience checkpoint; with nothing
anywhere it raises: training on known-poisoned state is the one thing
guardrails exist to prevent.
"""

import collections
from typing import Any, Callable, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger


class GuardrailsError(RuntimeError):
    """Anomaly detected and no recovery path remains."""


class SnapshotRing:
    """Bounded ring of host snapshots of an engine (newest wins).

    Entries are the resilience tier's ``_Snapshot`` objects: host copies of
    every state leaf plus the step and scheduler metadata. The ring's
    :meth:`take` snapshots into buffers from its own pool; :meth:`push`
    takes any object (the policy's unit tests push plain values)."""

    def __init__(self, capacity: int = 2):
        if capacity < 1:
            raise ValueError("snapshot ring capacity must be >= 1")
        from deepspeed_tpu_torch.resilience.checkpoint import _BufferPool

        self.capacity = int(capacity)
        self._ring = collections.deque()
        self.pool = _BufferPool(pin=torch.cuda.is_available())
        self.pushes = 0

    def _release(self, snap: Any) -> None:
        self.pool.release(getattr(snap, "buffers", None))

    def push(self, snap: Any) -> None:
        if len(self._ring) == self.capacity:
            self._release(self._ring.popleft())
        self._ring.append(snap)
        self.pushes += 1

    def take(self, engine) -> Any:
        """Snapshot ``engine`` into the ring. The oldest entry leaves
        first when the ring is full, so its buffers are the ones reused."""
        if len(self._ring) == self.capacity:
            self._release(self._ring.popleft())
        snap = take_snapshot(engine, pool=self.pool)
        self.push(snap)
        return snap

    def newest(self) -> Optional[Any]:
        return self._ring[-1] if self._ring else None

    def drop_newest(self) -> None:
        """Discard the newest snapshot (restoring it did not stop the
        spikes, so the next rollback should reach further back)."""
        if self._ring:
            self._release(self._ring.pop())

    def clear(self) -> None:
        while self._ring:
            self._release(self._ring.pop())

    def __len__(self) -> int:
        return len(self._ring)


def _params_finite(engine) -> bool:
    """Whether every floating master is finite: one multi-tensor reduction
    (the largest magnitude of each leaf, which is NaN or inf exactly when
    the leaf holds one) and one read by the host."""
    from deepspeed_tpu_torch import guardrails

    leaves = [p for p in engine.state.params if p.is_floating_point()]
    if not leaves:
        return True
    peaks = torch.stack(torch._foreach_norm(leaves, ord=float("inf")))
    return bool(guardrails._host_fetch(torch.isfinite(peaks).all()))


def take_snapshot(engine, pool=None) -> Any:
    """Host snapshot of the engine's whole training state (the resilience
    tier's copy; no disk). With ``pool`` the copies land in its reused
    buffers (pinned and asynchronous on the card), else in fresh ones."""
    from deepspeed_tpu_torch.resilience.checkpoint import snapshot_engine

    return snapshot_engine(engine, pool=pool)


def restore_snapshot(engine, snap) -> int:
    """Install a ring snapshot back into the engine, in place (the
    resilience restore path). Returns the number of optimizer steps
    rewound."""
    from deepspeed_tpu_torch.resilience.checkpoint import install_state_arrays

    snap.wait()
    before = int(engine.global_steps)
    install_state_arrays(engine, dict(snap.arrays),
                         step=int(snap.meta["step"]),
                         micro_steps=int(snap.meta["micro_steps"]),
                         lr_scheduler_state=snap.meta.get("lr_scheduler"))
    return before - int(engine.global_steps)


class RollbackPolicy:
    """Spike-streak bookkeeping plus the rollback itself."""

    def __init__(self,
                 ring: SnapshotRing,
                 consecutive_spikes: int = 2,
                 skip_batches: int = 2,
                 lr_decay: float = 1.0,
                 max_rollbacks: int = 3,
                 escalate_to_disk: bool = True):
        if consecutive_spikes < 1:
            raise ValueError("consecutive_spikes must be >= 1")
        if skip_batches < 0:
            raise ValueError("skip_batches must be >= 0")
        if not 0.0 < lr_decay <= 1.0:
            raise ValueError("lr_decay must be in (0, 1]")
        if max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        self.ring = ring
        self.consecutive_spikes = int(consecutive_spikes)
        self.skip_batches = int(skip_batches)
        self.lr_decay = float(lr_decay)
        self.max_rollbacks = int(max_rollbacks)
        self.escalate_to_disk = bool(escalate_to_disk)
        self.spike_streak = 0
        self.rollbacks = 0
        self.lr_scale = 1.0

    # ------------------------------------------------------------------
    def note_ok(self) -> None:
        self.spike_streak = 0

    def note_spike(self) -> bool:
        """Record one spike verdict; True when the streak reached the
        rollback threshold (the caller then calls :meth:`rollback`)."""
        self.spike_streak += 1
        return self.spike_streak >= self.consecutive_spikes

    # ------------------------------------------------------------------
    def rollback(self, engine,
                 data_skip_fn: Optional[Callable[[int], None]] = None) -> dict:
        """Restore the last good state and move the data stream past the
        offending window. Returns a summary dict for telemetry and logs."""
        if self.rollbacks >= self.max_rollbacks:
            raise GuardrailsError(
                f"guardrails: rollback budget exhausted "
                f"({self.max_rollbacks}) and loss is still spiking at step "
                f"{engine.global_steps}: the instability is not transient; "
                "aborting rather than training on poisoned state")
        self.rollbacks += 1
        self.spike_streak = 0
        snap = self.ring.newest()
        summary = {"rollbacks": self.rollbacks, "skipped_batches": 0,
                   "steps_rewound": 0, "source": None}
        if snap is not None:
            steps_rewound = restore_snapshot(engine, snap)
            # a second rollback must not restore this snapshot again (its
            # trajectory just spiked): fall back one deeper
            self.ring.drop_newest()
            summary.update(source="memory", steps_rewound=steps_rewound,
                           restored_step=int(engine.global_steps))
        elif self.escalate_to_disk and self._disk_dir(engine):
            from deepspeed_tpu_torch.resilience import restore

            path, _ = restore(engine, self._disk_dir(engine))
            if path is None:
                raise GuardrailsError(
                    "guardrails: spike streak with no in-memory snapshot "
                    "and no complete on-disk checkpoint to escalate to")
            # digest-valid is not numerics-valid: a checkpoint written
            # before guardrails were on could hold non-finite masters
            if not _params_finite(engine):
                raise GuardrailsError(
                    f"guardrails: escalated to on-disk checkpoint {path} "
                    "but its params are non-finite: the newest complete "
                    "checkpoint is itself poisoned; restore an older one "
                    "manually")
            summary.update(source="disk", path=path,
                           restored_step=int(engine.global_steps))
        else:
            raise GuardrailsError(
                "guardrails: spike streak with no in-memory snapshot and "
                "disk escalation unavailable (enable resilience "
                "checkpointing or increase guardrails.rollback.ring_size)")
        if self.lr_decay < 1.0:
            self.lr_scale *= self.lr_decay
            summary["lr_scale"] = self.lr_scale
        if data_skip_fn is not None and self.skip_batches:
            data_skip_fn(self.skip_batches)
            summary["skipped_batches"] = self.skip_batches
        elif self.skip_batches:
            logger.warning(
                "guardrails: no data-skip callback registered "
                "(engine.register_data_skip_fn): the loader replays from "
                "its current position; if the anomaly is data-borne the "
                "same window may spike again")
        logger.warning("guardrails: rolled back to step %s from %s "
                       "(rollback %d/%d, skipped %d batches)",
                       summary.get("restored_step"), summary["source"],
                       self.rollbacks, self.max_rollbacks,
                       summary["skipped_batches"])
        return summary

    @staticmethod
    def _disk_dir(engine) -> str:
        rcfg = getattr(engine.config, "resilience", None)
        if rcfg is not None and rcfg.enabled:
            return rcfg.checkpoint.dir
        return ""
