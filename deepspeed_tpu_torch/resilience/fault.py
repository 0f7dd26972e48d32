"""Deterministic fault injection: the port of
``deepspeed_tpu/resilience/fault.py``.

A :class:`FaultPlan` describes, deterministically, the faults a run must
survive. It comes from the config block (``resilience.fault_injection``)
with an environment override (``DSTPU_FAULT_PLAN``, a JSON object merged
over the block), and is active only while ``DSTPU_RESUME_ATTEMPT``
(default 0) is at most ``max_attempt`` (default 0), so a restarted
attempt sees it inert.

The plan is ported whole as data: every field of the reference parses and
is checked as there, so a plan written for the JAX package (training keys
included) means the same here. The serving hooks act:

- ``serve_decode_fault_at_step`` / ``serve_decode_fault_count``: the
  decode dispatch raises :class:`InjectedFault` (a ``RuntimeError``, as
  the reference raises) for a window of decode
  **dispatch attempts** (a monotonic count the serving engine keeps;
  retries advance it, so ``count=1`` heals under retry and ``count >
  max_retries + 1`` forces the rebuild);
- ``serve_slow_step_at_step`` / ``_seconds`` / ``_count``: straggler
  decode steps (a sleep inside the decode timing window);
- ``serve_storm_at_step`` / ``serve_storm_requests``: a burst of
  duplicates of the last submitted request at one step boundary, through
  the normal ``submit`` (and so through the shed gate).

The training hooks the engine and ``resilience/checkpoint.py`` act on:

- ``preempt_at_step``: after that global step's checkpoint is enqueued,
  SIGTERM to the process itself with the default disposition
  (:meth:`FaultPlan.preempt`);
- ``ckpt_write_errors``: that many shard writes raise ``OSError``
  (:meth:`FaultPlan.take_io_error`), each retried by the writer;
- ``corrupt_shard_at_step``: the checkpoint of that step is corrupted
  after its commit (:func:`corrupt_one_shard`), and a restore falls back
  past it.

The other training keys (NaN batches, hangs, slice preemption and its
grace, rejoin) belong to the guardrails and elasticity, which are not
ported: a training engine refuses a plan that sets one
(:func:`check_training_plan`).
"""

import json
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.config.constants import FAULT_PLAN_ENV
from deepspeed_tpu_torch.utils.logging import logger

RESUME_ATTEMPT_ENV = "DSTPU_RESUME_ATTEMPT"
# Training keys whose hooks belong to slices not ported yet (the
# guardrails: NaN batches, hangs; elasticity: slice preemption, rejoin).
TRAINING_UNPORTED_KEYS = ("nan_loss_at_step", "nan_loss_steps",
                          "hang_at_step", "hang_seconds",
                          "slice_preempt_at_step", "slice_preempt_slice",
                          "preempt_grace_seconds", "rejoin_after_steps")


class InjectedFault(RuntimeError):
    """A fault the plan injected. Serving recovery retries and rebuilds
    on it; a kernel's own error is another type and propagates."""


@dataclass
class FaultPlan:
    """Deterministic fault schedule for one incarnation."""

    preempt_at_step: Optional[int] = None
    ckpt_write_errors: int = 0
    corrupt_shard_at_step: Optional[int] = None
    nan_loss_at_step: Optional[int] = None
    nan_loss_steps: int = 1
    hang_at_step: Optional[int] = None
    hang_seconds: float = 3600.0
    slice_preempt_at_step: Optional[int] = None
    slice_preempt_slice: Optional[int] = None
    preempt_grace_seconds: float = 30.0
    rejoin_after_steps: Optional[int] = None
    serve_decode_fault_at_step: Optional[int] = None
    serve_decode_fault_count: int = 1
    serve_slow_step_at_step: Optional[int] = None
    serve_slow_step_seconds: float = 0.05
    serve_slow_step_count: int = 1
    serve_storm_at_step: Optional[int] = None
    serve_storm_requests: int = 8
    max_attempt: int = 0

    def __post_init__(self):
        if self.ckpt_write_errors < 0:
            raise ValueError("ckpt_write_errors must be >= 0")
        if self.nan_loss_steps < 1:
            raise ValueError("nan_loss_steps must be >= 1")
        if self.hang_seconds <= 0:
            raise ValueError("hang_seconds must be > 0")
        if self.preempt_grace_seconds <= 0:
            raise ValueError("preempt_grace_seconds must be > 0")
        if self.rejoin_after_steps is not None and self.rejoin_after_steps < 1:
            raise ValueError("rejoin_after_steps must be >= 1")
        if self.serve_decode_fault_count < 1:
            raise ValueError("serve_decode_fault_count must be >= 1")
        if self.serve_slow_step_seconds <= 0:
            raise ValueError("serve_slow_step_seconds must be > 0")
        if self.serve_slow_step_count < 1:
            raise ValueError("serve_slow_step_count must be >= 1")
        if self.serve_storm_requests < 1:
            raise ValueError("serve_storm_requests must be >= 1")
        self._io_errors_left = int(self.ckpt_write_errors)

    @classmethod
    def resolve(cls, config_block: Optional[Dict[str, Any]] = None,
                env: Optional[Dict[str, str]] = None) -> Optional["FaultPlan"]:
        """Config block + ``DSTPU_FAULT_PLAN`` override -> plan, or None
        when nothing is scheduled or a later restart attempt runs."""
        env = os.environ if env is None else env
        d = _plan_block(config_block, env)
        if not d:
            return None
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown fault_injection keys {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}")
        plan = cls(**d)
        attempt = int(env.get(RESUME_ATTEMPT_ENV, "0") or 0)
        if attempt > plan.max_attempt:
            logger.info("FaultPlan inert on resume attempt %d (max_attempt="
                        "%d): %s", attempt, plan.max_attempt, plan)
            return None
        return plan

    # -- training (runtime/engine.py, resilience/checkpoint.py) ---------
    def take_io_error(self) -> bool:
        """One checkpoint shard write is about to happen; True = inject."""
        if self._io_errors_left > 0:
            self._io_errors_left -= 1
            return True
        return False

    def should_preempt(self, global_step: int) -> bool:
        return (self.preempt_at_step is not None
                and global_step == self.preempt_at_step)

    def should_corrupt(self, global_step: int) -> bool:
        return (self.corrupt_shard_at_step is not None
                and global_step == self.corrupt_shard_at_step)

    def preempt(self, global_step: int) -> None:
        """Deliver the injected preemption: SIGTERM to self, default
        disposition (process death), like a real maintenance event."""
        logger.warning("FaultPlan: injecting preemption (SIGTERM) after "
                       "global step %d", global_step)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    # -- serving chaos (serving/resilience.py) --------------------------
    def should_serve_decode_fault(self, dispatch_attempt: int) -> bool:
        """Raise on this decode dispatch attempt? Active for the window
        ``[at_step, at_step + count)`` of the engine's monotonic
        dispatch-attempt count."""
        return (self.serve_decode_fault_at_step is not None
                and self.serve_decode_fault_at_step <= dispatch_attempt
                < self.serve_decode_fault_at_step
                + self.serve_decode_fault_count)

    def serve_decode_fault(self, dispatch_attempt: int) -> None:
        raise InjectedFault(
            f"FaultPlan: injected serving decode-dispatch fault "
            f"(dispatch attempt {dispatch_attempt})")

    def should_serve_slow_step(self, dispatch_attempt: int) -> bool:
        return (self.serve_slow_step_at_step is not None
                and self.serve_slow_step_at_step <= dispatch_attempt
                < self.serve_slow_step_at_step + self.serve_slow_step_count)

    def serve_slow_step(self) -> None:
        """Stall inside the decode timing window (a straggler step)."""
        logger.warning("FaultPlan: injecting slow serving step (%.3fs)",
                       self.serve_slow_step_seconds)
        time.sleep(self.serve_slow_step_seconds)

    def should_serve_storm(self, serve_step: int) -> bool:
        """Fire the request storm at this step boundary (exact match: the
        burst fires once)."""
        return (self.serve_storm_at_step is not None
                and serve_step == self.serve_storm_at_step)


def _plan_block(config_block: Optional[Dict[str, Any]],
                env: Dict[str, str]) -> Dict[str, Any]:
    """The config block with the ``DSTPU_FAULT_PLAN`` JSON merged over
    it."""
    d = dict(config_block or {})
    override = env.get(FAULT_PLAN_ENV)
    if override:
        try:
            d.update(json.loads(override))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"{FAULT_PLAN_ENV} is not a JSON object: {e}") from e
    return d


def check_training_plan(config_block: Optional[Dict[str, Any]] = None,
                        env: Optional[Dict[str, str]] = None) -> None:
    """Refuse a training plan (read as :meth:`FaultPlan.resolve` reads it)
    that sets a key whose hook is not ported
    (``TRAINING_UNPORTED_KEYS``)."""
    from deepspeed_tpu_torch.config.config import not_yet_ported

    keys = _plan_block(config_block, os.environ if env is None else env)
    bad = sorted(set(keys) & set(TRAINING_UNPORTED_KEYS))
    if bad:
        raise not_yet_ported(f"the training fault_injection keys {bad} "
                             f"(their hooks belong to the guardrails and "
                             f"elasticity slices)")


def corrupt_one_shard(ckpt_path: str, manifest: Dict[str, Any]) -> str:
    """Flip bytes in the first (name-sorted) shard of a committed
    checkpoint: the deterministic torn-write fault. Returns the file."""
    name = sorted(manifest["shards"])[0]
    fname = os.path.join(ckpt_path, manifest["shards"][name]["file"])
    with open(fname, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        # hit the payload: flip a run of bytes in the back half
        pos = max(size // 2, min(size - 1, 128))
        f.seek(pos)
        chunk = f.read(min(64, size - pos))
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))
    logger.warning("FaultPlan: corrupted shard %r in %s", name, fname)
    return fname
