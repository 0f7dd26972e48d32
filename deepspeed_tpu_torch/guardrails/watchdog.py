"""Step watchdog: the port of ``deepspeed_tpu/guardrails/watchdog.py``.
Detect a hung training step and die loudly, with evidence.

The nastiest failure of an unattended run is not a crash but a hang: a
collective whose peer died, a stuck host callback, a kernel that never
returns. The process looks alive to the supervisor while it burns the
reservation. The watchdog turns that silence into a distinct, restartable
death:

- the engine brackets every step with :meth:`StepWatchdog.step_begin` /
  :meth:`StepWatchdog.step_end`;
- a daemon thread checks, every ``poll_interval``, whether an armed step
  has run longer than ``timeout`` (time between steps never counts: eval
  pauses and a slow dataset are not hangs);
- on a trip it writes a crash dump (``faulthandler`` stacks of every
  thread, the hung frame included; the telemetry trace's tail; the card's
  memory statistics; the tail of the metrics JSONL) and ends the process
  with a distinct exit code (113 by default), which the resilience
  supervisor restarts at once.

``os._exit`` on purpose: a hung step cannot be unwound by an exception
(the main thread is blocked in a wait), and atexit handlers may be the
hung parties themselves. The dump is flushed first; then the process must
go.

The clock is a seam (``clock=``): a test arms a step, moves its clock and
calls :meth:`StepWatchdog.check`, which trips without any sleep; with
``exit_fn`` replaced the dump is written and the test process lives.
"""

import json
import os
import threading
import time
from typing import Callable, Optional

from deepspeed_tpu_torch.config.constants import \
    GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT
from deepspeed_tpu_torch.utils.logging import logger


class StepWatchdog:
    """Deadline monitor for the training step. One per engine."""

    def __init__(self,
                 timeout: float,
                 crashdump_dir: str = "crashdumps",
                 exit_code: int = GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT,
                 poll_interval: Optional[float] = None,
                 telemetry=None,
                 metrics_tail_of: Optional[str] = None,
                 exit_fn: Callable[[int], None] = os._exit,
                 clock: Callable[[], float] = time.monotonic):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be > 0 seconds")
        if poll_interval is not None and poll_interval <= 0:
            raise ValueError("watchdog poll_interval must be > 0 seconds "
                             "(non-positive would busy-spin the thread)")
        self.timeout = float(timeout)
        self.crashdump_dir = crashdump_dir
        self.exit_code = int(exit_code)
        self.poll_interval = (float(poll_interval) if poll_interval
                              else max(0.05, min(1.0, self.timeout / 4.0)))
        self.telemetry = telemetry
        self.metrics_tail_of = metrics_tail_of
        self._exit_fn = exit_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._depth = 0            # re-entrant brackets: the outermost arms
        self._step = 0
        self._label = ""
        self.tripped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="guardrails-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------------
    def step_begin(self, step: int, label: str = "train_step") -> None:
        """Arm the deadline. Re-entrant: only the outermost bracket
        arms."""
        with self._lock:
            self._depth += 1
            if self._depth == 1:
                self._armed_at = self._clock()
                self._step = int(step)
                self._label = label

    def step_end(self) -> None:
        with self._lock:
            self._depth = max(0, self._depth - 1)
            if self._depth == 0:
                self._armed_at = None

    def suspend(self) -> None:
        """Disarm at any bracket depth. A rollback (a disk restore, a
        loader skip) runs inside the step's armed window but is not a
        step: the step deadline must not kill it. The enclosing
        ``step_end`` balances harmlessly (the depth clamps at 0) and the
        next ``step_begin`` arms again."""
        with self._lock:
            self._depth = 0
            self._armed_at = None

    # ------------------------------------------------------------------
    def check(self) -> bool:
        """One poll: trip if an armed step is past its deadline on the
        watchdog's clock. Returns whether it tripped."""
        with self._lock:
            armed_at, step, label = self._armed_at, self._step, self._label
        if armed_at is None:
            return False
        elapsed = self._clock() - armed_at
        if elapsed <= self.timeout:
            return False
        self.trip(step, elapsed, label)
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            if self.check():
                return

    def trip(self, step: int, elapsed: float, label: str = "") -> None:
        """Deadline exceeded: dump the diagnostics and exit with the
        distinct code (through ``exit_fn``, which a test replaces)."""
        self.tripped = True
        logger.error(
            "guardrails watchdog: %s for step %d exceeded the %.1fs "
            "deadline (%.1fs elapsed): dumping diagnostics and exiting "
            "rc=%d for supervisor restart", label or "step", step,
            self.timeout, elapsed, self.exit_code)
        try:
            dump = self.dump_diagnostics(step, elapsed, label)
            logger.error("guardrails watchdog: crashdump at %s", dump)
        except Exception as e:  # noqa: BLE001 - dying loudly beats dying twice
            logger.error("guardrails watchdog: diagnostics dump failed: %s", e)
        self._exit_fn(self.exit_code)

    # ------------------------------------------------------------------
    def dump_diagnostics(self, step: int, elapsed: float,
                         label: str = "") -> str:
        """Write the evidence a post-mortem needs into a fresh directory
        under ``crashdump_dir``; every artifact is best-effort."""
        out = os.path.join(self.crashdump_dir,
                           f"watchdog_step{step}_{os.getpid()}")
        os.makedirs(out, exist_ok=True)
        info: dict = {"step": step, "elapsed_sec": round(elapsed, 3),
                      "timeout_sec": self.timeout, "label": label,
                      "pid": os.getpid(), "exit_code": self.exit_code}

        # 1. every thread's stack: the hung frame
        try:
            import faulthandler
            with open(os.path.join(out, "stacks.txt"), "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            info["stacks"] = "stacks.txt"
        except Exception as e:  # noqa: BLE001
            info["stacks_error"] = repr(e)

        # 2. the recent trace events (the spans leading into the hang)
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            try:
                events = tel.tracer.events()[-200:]
                with open(os.path.join(out, "trace_tail.json"), "w") as f:
                    json.dump({"traceEvents": events}, f)
                info["trace_tail"] = "trace_tail.json"
            except Exception as e:  # noqa: BLE001
                info["trace_tail_error"] = repr(e)

        # 3. the card's memory statistics and headroom: a hang under
        # memory pressure looks like any other hang without them
        try:
            from deepspeed_tpu_torch.telemetry.memory import \
                collect_memory_snapshot
            with open(os.path.join(out, "memory.json"), "w") as f:
                json.dump(collect_memory_snapshot(), f, indent=1)
            info["memory"] = "memory.json"
        except Exception as e:  # noqa: BLE001
            info["memory_error"] = repr(e)

        # 4. the tail of the metrics JSONL: the trajectory into the hang
        try:
            from deepspeed_tpu_torch.telemetry.memory import \
                write_metrics_tail
            name = write_metrics_tail(out, self.metrics_tail_of)
            if name:
                info["metrics_tail"] = name
        except Exception as e:  # noqa: BLE001
            info["metrics_tail_error"] = repr(e)

        with open(os.path.join(out, "info.json"), "w") as f:
            json.dump(info, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        self._emit_trip_telemetry(step)
        return out

    def _emit_trip_telemetry(self, step: int) -> None:
        tel = self.telemetry
        if tel is None or not getattr(tel, "enabled", False):
            return
        try:
            tel.registry.counter("guardrails/watchdog_trips").inc(step=step)
            tel.instant("guardrails_watchdog_trip", step=step)
            tel.flush()
        except Exception:  # noqa: BLE001 - never block the exit on telemetry
            pass


def is_watchdog_exit(rc: Optional[int]) -> bool:
    """Did a child die by the watchdog? (The supervisor's immediate-restart
    test; a custom ``exit_code`` goes to the supervisor through
    ``immediate_restart_rcs``.)"""
    return rc == GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT
