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

The training hooks (preemption, checkpoint write errors, shard corruption,
NaN batches, hangs, slice preemption and rejoin) act in the training
resilience slice, which is not ported yet; their fields parse here but
nothing reads them.
"""

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.config.constants import FAULT_PLAN_ENV
from deepspeed_tpu_torch.utils.logging import logger

RESUME_ATTEMPT_ENV = "DSTPU_RESUME_ATTEMPT"


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

    @classmethod
    def resolve(cls, config_block: Optional[Dict[str, Any]] = None,
                env: Optional[Dict[str, str]] = None) -> Optional["FaultPlan"]:
        """Config block + ``DSTPU_FAULT_PLAN`` override -> plan, or None
        when nothing is scheduled or a later restart attempt runs."""
        env = os.environ if env is None else env
        d = dict(config_block or {})
        override = env.get(FAULT_PLAN_ENV)
        if override:
            try:
                d.update(json.loads(override))
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"{FAULT_PLAN_ENV} is not a JSON object: {e}") from e
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
