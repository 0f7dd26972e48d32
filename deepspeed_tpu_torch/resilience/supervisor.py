"""Auto-resume supervisor: the port of
``deepspeed_tpu/resilience/supervisor.py``.

Run the training command; when it dies (a preemption, an injected
SIGTERM, an I/O crash), restart it up to ``max_restarts`` times after a
capped, jittered exponential delay. Each incarnation sees
``DSTPU_RESUME_ATTEMPT`` in its environment: the training side
(``engine.auto_resume``) resumes from the newest complete manifest, and
the ``FaultPlan`` stays inert after the restart it caused.

Exit codes fall into the reference's three classes, with its defaults:
``immediate_restart_rcs`` (the guardrails watchdog's 113) restart with no
delay, ``oom_rcs`` (the memory observatory's 114) end the loop at once,
and ``warned_rcs`` (live elasticity's 115) restart as any preemption.

``run_dir`` (the child's ``telemetry.dir``): after each attempt the
supervisor stamps the attempt's goodput run manifests with its exit code,
restart cause and end time (``telemetry/goodput.py``), and each child's
environment carries its spawn time, so its accountant books interpreter
start-up as ``init_restore``; ``tools/goodput_report.py`` merges the
attempts. Not ported: the fleet layer's straggler notes read from the run
dir and ``available_worlds`` (the elastic world), which raises "not yet
ported".
"""

import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

from deepspeed_tpu_torch.config.constants import (
    ELASTIC_PREEMPT_EXIT_CODE_DEFAULT, GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT,
    MEMORY_OOM_EXIT_CODE_DEFAULT)
from deepspeed_tpu_torch.guardrails.retry import backoff_delay
from deepspeed_tpu_torch.resilience.fault import RESUME_ATTEMPT_ENV
from deepspeed_tpu_torch.utils.logging import logger

# Cap on the exponential restart delay: past about a minute more waiting
# buys nothing, and the restart budget ends a crash loop.
MAX_RESTART_BACKOFF_DEFAULT = 60.0


class Supervisor:
    """Restarts one training command when it dies."""

    def __init__(self, cmd: List[str], max_restarts: int = 3,
                 env: Optional[Dict[str, str]] = None,
                 backoff: float = 0.5,
                 max_backoff: float = MAX_RESTART_BACKOFF_DEFAULT,
                 jitter: float = 0.25,
                 immediate_restart_rcs: Optional[Iterable[int]] = None,
                 oom_rcs: Optional[Iterable[int]] = None,
                 warned_rcs: Optional[Iterable[int]] = None,
                 ckpt_dir: Optional[str] = None,
                 run_dir: Optional[str] = None,
                 available_worlds: Optional[Callable[[int], int]] = None):
        from deepspeed_tpu_torch.config.config import not_yet_ported

        if available_worlds is not None:
            raise not_yet_ported("Supervisor(available_worlds=...) (the "
                                 "elastic world)")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.cmd = list(cmd)
        self.max_restarts = int(max_restarts)
        self.env = dict(env or {})
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.immediate_restart_rcs = set(
            immediate_restart_rcs if immediate_restart_rcs is not None
            else (GUARDRAILS_WATCHDOG_EXIT_CODE_DEFAULT,))
        self.oom_rcs = set(oom_rcs if oom_rcs is not None
                           else (MEMORY_OOM_EXIT_CODE_DEFAULT,))
        self.warned_rcs = set(warned_rcs if warned_rcs is not None
                              else (ELASTIC_PREEMPT_EXIT_CODE_DEFAULT,))
        self.run_dir = run_dir
        self.restarts = 0
        self.immediate_restarts = 0
        self.oom_exits = 0
        self.exit_codes: List[int] = []
        self.metrics = None
        if ckpt_dir:
            from deepspeed_tpu_torch.resilience.checkpoint import (
                METRICS_FILE, MetricsJSONL)
            self.metrics = MetricsJSONL(os.path.join(ckpt_dir, METRICS_FILE))

    def _child_env(self, attempt: int) -> Dict[str, str]:
        from deepspeed_tpu_torch.telemetry.goodput import \
            ATTEMPT_START_WALL_ENV

        return {**os.environ, **self.env, RESUME_ATTEMPT_ENV: str(attempt),
                ATTEMPT_START_WALL_ENV: repr(time.time())}

    def _finalize_attempt(self, attempt: int, rc: int,
                          start_wall: float) -> None:
        """Stamp the attempt's run manifests with its fate. Best effort:
        accounting must never take down the recovery loop."""
        if not self.run_dir:
            return
        from deepspeed_tpu_torch.telemetry.goodput import (
            classify_exit, finalize_attempt_manifests)
        try:
            finalize_attempt_manifests(
                self.run_dir, attempt, rc,
                classify_exit(rc, self.immediate_restart_rcs, self.oom_rcs,
                              self.warned_rcs),
                start_wall, time.time())
        except Exception as e:  # noqa: BLE001
            logger.warning("supervisor: manifest finalize failed: %s", e)

    def _metric(self, tag: str, value: float, step: int) -> None:
        if self.metrics is not None:
            self.metrics.add_scalar(tag, value, step)

    def run(self) -> int:
        """Run until a clean exit or the restart budget is spent; returns
        the final exit code (0 on success)."""
        attempt = 0
        while True:
            logger.info("supervisor: launching attempt %d: %s", attempt,
                        " ".join(self.cmd))
            start_wall = time.time()
            proc = subprocess.Popen(self.cmd, env=self._child_env(attempt))
            try:
                rc = proc.wait()
            except BaseException:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                raise
            self.exit_codes.append(rc)
            self._finalize_attempt(attempt, rc, start_wall)
            if rc == 0:
                self._metric("Train/Resilience/recovery_count",
                             self.restarts, attempt)
                return 0
            if rc in self.oom_rcs:
                # a deterministic OOM re-fires on every attempt
                self.oom_exits += 1
                logger.error("supervisor: attempt %d exited rc=%d "
                             "(cause=oom): not restarting", attempt, rc)
                self._metric("Train/Resilience/worker_exit_code", rc,
                             attempt)
                return rc
            if self.restarts >= self.max_restarts:
                logger.error(
                    "supervisor: attempt %d exited rc=%d and the restart "
                    "budget (%d) is exhausted: giving up", attempt, rc,
                    self.max_restarts)
                return rc
            self.restarts += 1
            attempt += 1
            if rc in self.immediate_restart_rcs:
                # a watchdog kill already sat through a step deadline
                self.immediate_restarts += 1
                delay = 0.0
            else:
                delay = backoff_delay(self.restarts - 1, self.backoff,
                                      max_delay=self.max_backoff,
                                      jitter=self.jitter)
            logger.warning(
                "supervisor: worker died rc=%d%s: restart %d/%d in %.2fs",
                rc, " (warned preemption)" if rc in self.warned_rcs else "",
                self.restarts, self.max_restarts, delay)
            self._metric("Train/Resilience/worker_exit_code", rc, attempt)
            if delay > 0.0:
                time.sleep(delay)


def supervise_main(argv: Optional[List[str]] = None) -> int:
    """``python -m deepspeed_tpu_torch.resilience.supervisor [opts] --
    cmd...``: the standalone auto-resume wrapper of one training
    command."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Auto-resume supervisor: restart a training command on "
                    "failure")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=0.5)
    ap.add_argument("--max_backoff", type=float,
                    default=MAX_RESTART_BACKOFF_DEFAULT)
    ap.add_argument("--immediate_rc", type=int, action="append",
                    default=None)
    ap.add_argument("--oom_rc", type=int, action="append", default=None)
    ap.add_argument("--warned_rc", type=int, action="append", default=None)
    ap.add_argument("--checkpoint_dir", type=str, default=None)
    ap.add_argument("--run_dir", type=str, default=None,
                    help="the child's telemetry.dir: each attempt's goodput "
                         "run manifests get its exit code and restart "
                         "cause")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="training command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    return Supervisor(cmd, max_restarts=args.max_restarts,
                      backoff=args.backoff, max_backoff=args.max_backoff,
                      immediate_restart_rcs=args.immediate_rc,
                      oom_rcs=args.oom_rc, warned_rcs=args.warned_rc,
                      ckpt_dir=args.checkpoint_dir,
                      run_dir=args.run_dir).run()


if __name__ == "__main__":
    sys.exit(supervise_main())
