"""Goodput accounting: the port of ``deepspeed_tpu/telemetry/goodput.py``.
Run-level wall-clock attribution and MFU.

:class:`GoodputAccountant` partitions every second of an attempt's wall
clock into one of :data:`CATEGORIES`: productive steps, the step path's
checkpoint snapshot and write stalls, rollback restore and replay, data
stalls (``put_batch``), recompiles (a step at an input signature not seen
before), process start to the first step (``init_restore``), and the
residual ``idle_other``. ``elastic_reshard`` and ``autotune_search`` keep
their places for the report's sake and stay 0: their subsystems are not
ported.

The accounting is mark-based: call sites mark phase boundaries and the
accountant attributes the interval since the last mark, so the categories
partition the timeline exactly. It reads only ``time.monotonic()``: no
device sync and no read by the host, enabled or not. Disabled, the engine
holds ``goodput = None`` and every hook is one attribute check.

MFU: the engine feeds the accountant, once, the model FLOPs of a step (the
port's copy of ``bench.py:train_flops_per_step``: 6 N per token plus the
attention products) and the card's peak for the compute dtype (989
TFLOP/s dense bf16 and fp16 on an H100, 67 fp32 with TF32 off);
``engine/mfu`` is FLOPs / (mean step time x peak). A card without a peak
in the table reports no MFU.

Run manifest: each attempt keeps ``run_manifest.aNNNN.<host>.json`` under
the telemetry dir (run id, attempt, host, start and end times, exit code,
restart cause, config hash, category totals, MFU, the peak and the card).
The engine writes it on start, refreshes it at every metrics flush and
finalises it at exit; :func:`finalize_attempt_manifests` lets the
supervisor stamp a dead child's exit code and cause.
``tools/goodput_report.py`` merges the manifests of every attempt.
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import threading
import time
from typing import Any, Dict, Optional

RUN_ID_ENV = "DSTPU_RUN_ID"
# the host name in every per-host telemetry file (the fleet layer's too)
TELEMETRY_HOST_ENV = "DSTPU_TELEMETRY_HOST"
# the spawn wall time the supervisor stamps into a child's environment:
# the accountant backdates the attempt to it, so interpreter start-up is
# booked as init_restore instead of vanishing
ATTEMPT_START_WALL_ENV = "DSTPU_ATTEMPT_START_WALL"

MANIFEST_PREFIX = "run_manifest."
MANIFEST_FORMAT = 1

CATEGORIES = (
    "productive_step",
    "ckpt_snapshot",
    "ckpt_write_stall",
    "rollback_restore",
    "rollback_replay",
    "data_stall",
    "recompile",
    "init_restore",
    "elastic_reshard",
    "autotune_search",
    "idle_other",
)

_STEP_CATEGORIES = ("productive_step", "rollback_replay")

# Dense peak TFLOP/s by card and compute dtype (fp32 outside the tensor
# cores: the engine runs with TF32 off).
PEAK_TFLOPS = {"H100": {"bfloat16": 989.0, "float16": 989.0,
                        "float32": 67.0}}

GOODPUT_METRIC_TAGS = frozenset(
    {f"goodput/{c}_sec" for c in CATEGORIES}
    | {"goodput/wall_sec", "goodput/goodput_frac",
       "goodput/steps_committed", "engine/mfu"})


def config_hash(param_dict: Optional[Dict[str, Any]]) -> str:
    """A stable short hash of a raw config dict (ties the manifests of one
    run's attempts together)."""
    blob = json.dumps(param_dict or {}, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def default_run_id(run_dir: Optional[str]) -> str:
    """``DSTPU_RUN_ID`` when set; else derived from the run dir, so every
    attempt of a supervised run agrees without coordination."""
    rid = os.environ.get(RUN_ID_ENV)
    if rid:
        return rid
    basis = os.path.abspath(run_dir) if run_dir else "unknown"
    return hashlib.sha1(basis.encode()).hexdigest()[:12]


def peak_tflops(device_name: str, dtype: str) -> Optional[float]:
    """The card's dense peak for ``dtype``, or None for a card the table
    does not hold (the CPU included)."""
    for kind, peaks in PEAK_TFLOPS.items():
        if kind in (device_name or ""):
            return peaks.get(dtype)
    return None


def card_info(device) -> str:
    """``name, power.limit`` as nvidia-smi prints them for a CUDA device
    (the name alone without nvidia-smi); ``cpu`` for the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    smi = shutil.which("nvidia-smi")
    if smi:
        try:
            out = subprocess.run(
                [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
                 "-i", str(device.index or 0)],
                capture_output=True, text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                return out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            pass
    return torch.cuda.get_device_name(device)


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> str:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


class _Measure:
    """Context manager carving a closed interval out of the timeline: the
    span goes to ``category`` and the mark cursor moves past it, so the
    enclosing phase's next mark never counts it again. Time pending before
    entry stays pending for the enclosing phase's own mark."""

    __slots__ = ("_acc", "_category", "_t0")

    def __init__(self, acc: "GoodputAccountant", category: str):
        self._acc = acc
        self._category = category
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._acc._clock()
        return self

    def __exit__(self, *exc):
        now = self._acc._clock()
        dur = now - self._t0
        with self._acc._lock:
            self._acc._attribute_locked(self._category, dur)
            self._acc._last = min(now, self._acc._last + dur)
        return False


class GoodputAccountant:
    """Wall-clock attribution and MFU for one attempt of one run.
    Thread-safe (the checkpoint writer's ``wait()`` attributes off the step
    thread); no device work."""

    def __init__(self,
                 registry=None,
                 run_dir: Optional[str] = None,
                 run_id: Optional[str] = None,
                 attempt: Optional[int] = None,
                 host: Optional[str] = None,
                 cfg_hash: str = "",
                 card: str = "",
                 clock=time.monotonic,
                 wall_clock=time.time,
                 env: Optional[Dict[str, str]] = None):
        env = os.environ if env is None else env
        self.registry = registry
        self.run_dir = run_dir
        self.run_id = run_id if run_id is not None else default_run_id(run_dir)
        if attempt is None:
            from deepspeed_tpu_torch.resilience.fault import \
                RESUME_ATTEMPT_ENV
            attempt = int(env.get(RESUME_ATTEMPT_ENV, "0") or 0)
        self.attempt = int(attempt)
        self.host = (host or env.get(TELEMETRY_HOST_ENV)
                     or socket.gethostname().replace(os.sep, "_"))
        self.cfg_hash = cfg_hash
        self.card = card
        self.pid = os.getpid()
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        now_mono, now_wall = clock(), wall_clock()
        # interpreter start-up happened before this object existed: when
        # the spawner stamped its wall time, backdate the attempt to it
        lag = 0.0
        spawn = env.get(ATTEMPT_START_WALL_ENV)
        if spawn:
            try:
                lag = max(0.0, now_wall - float(spawn))
            except ValueError:
                lag = 0.0
        self.start_wall = now_wall - lag
        self.start_monotonic = now_mono - lag
        self._totals["init_restore"] += lag
        self._last = now_mono
        self._saw_step = False
        self._first_step: Optional[int] = None
        self._steps_committed = 0
        self._step_time_sum = 0.0
        self._step_count = 0
        self._flops_per_step: Optional[float] = None
        self._n_chips = 1
        self._peak_tflops: Optional[float] = None
        self._flops_attempted = False
        self._finalized = False
        if run_dir:
            self.write_manifest()

    # -- attribution ----------------------------------------------------
    def _attribute_locked(self, category: str, seconds: float) -> None:
        if seconds > 0.0:
            self._totals[category] = self._totals.get(category, 0.0) + seconds

    def attribute(self, category: str, seconds: float) -> None:
        """Add ``seconds`` to a category without moving the cursor (time
        measured elsewhere); :meth:`mark` and :meth:`measure` keep the
        partition exact."""
        with self._lock:
            self._attribute_locked(category, seconds)

    def mark(self, category: str) -> float:
        """Attribute everything since the previous mark to ``category``
        and move the cursor. Returns the seconds attributed."""
        now = self._clock()
        with self._lock:
            dt = now - self._last
            self._last = now
            self._attribute_locked(category, dt)
        return dt

    def measure(self, category: str) -> _Measure:
        """``with goodput.measure("init_restore"): ...``: attribute a
        closed interval (see :class:`_Measure`)."""
        return _Measure(self, category)

    def mark_gap(self) -> float:
        """The between-steps mark: init_restore until the first step has
        run, idle_other after."""
        return self.mark("init_restore" if not self._saw_step
                         else "idle_other")

    def step_mark(self, category: str, committed_step: int) -> float:
        """End-of-step mark (productive_step, rollback_replay or
        recompile); productive and replay steps feed the MFU's step time
        (recompile steps are excluded)."""
        dt = self.mark(category)
        with self._lock:
            self._saw_step = True
            if self._first_step is None:
                self._first_step = int(committed_step)
            self._steps_committed = max(self._steps_committed,
                                        int(committed_step))
            if category in _STEP_CATEGORIES:
                self._step_time_sum += dt
                self._step_count += 1
        return dt

    # -- MFU ------------------------------------------------------------
    @property
    def wants_flops(self) -> bool:
        return not self._flops_attempted

    def flops_failed(self) -> None:
        self._flops_attempted = True

    def set_flops(self, flops_per_step: float, n_chips: int = 1,
                  peak_tflops_per_chip: Optional[float] = None) -> None:
        """The model FLOPs of one step, the cards it ran on and the peak
        of one card (None: no MFU), set once by the engine."""
        self._flops_attempted = True
        if flops_per_step and flops_per_step > 0:
            self._flops_per_step = float(flops_per_step)
            self._n_chips = max(int(n_chips), 1)
            self._peak_tflops = peak_tflops_per_chip

    def mean_step_time(self) -> Optional[float]:
        with self._lock:
            if self._step_count == 0:
                return None
            return self._step_time_sum / self._step_count

    def mfu(self) -> Optional[float]:
        """Model FLOPs utilisation of the measured (productive and replay)
        steps; None without FLOPs, a step time or the card's peak."""
        dt = self.mean_step_time()
        if (self._flops_per_step is None or dt is None or dt <= 0
                or not self._peak_tflops):
            return None
        return self._flops_per_step / (dt * self._n_chips
                                       * self._peak_tflops * 1e12)

    # -- readout / emission ----------------------------------------------
    def totals(self) -> Dict[str, float]:
        """Category seconds plus ``wall_sec``; the categories (the
        unmarked tail since the last mark in idle_other or init_restore)
        sum to ``wall_sec`` exactly."""
        now = self._clock()
        with self._lock:
            out = dict(self._totals)
            pending = max(0.0, now - self._last)
            gap_cat = "init_restore" if not self._saw_step else "idle_other"
            out[gap_cat] += pending
            out["wall_sec"] = now - self.start_monotonic
        return out

    def emit(self, step: int) -> None:
        """Emit the cumulative ``goodput/*`` gauges (tagged with the
        attempt) and ``engine/mfu`` when it is known."""
        reg = self.registry
        if reg is None:
            return
        t = self.totals()
        wall = t.pop("wall_sec")
        for cat in CATEGORIES:
            reg.gauge(f"goodput/{cat}_sec").set(t[cat], step=step,
                                                attempt=self.attempt)
        reg.gauge("goodput/wall_sec").set(wall, step=step,
                                          attempt=self.attempt)
        reg.gauge("goodput/goodput_frac").set(
            (t["productive_step"] / wall) if wall > 0 else 0.0,
            step=step, attempt=self.attempt)
        reg.gauge("goodput/steps_committed").set(
            self._steps_committed, step=step, attempt=self.attempt)
        m = self.mfu()
        if m is not None:
            reg.gauge("engine/mfu").set(m, step=step, attempt=self.attempt)

    # -- manifest -------------------------------------------------------
    def manifest_path(self) -> Optional[str]:
        if not self.run_dir:
            return None
        return os.path.join(self.run_dir,
                            f"{MANIFEST_PREFIX}a{self.attempt:04d}."
                            f"{self.host}.json")

    def manifest(self, exit_rc: Optional[int] = None,
                 restart_cause: Optional[str] = None,
                 final: bool = False) -> Dict[str, Any]:
        t = self.totals()
        wall = t.pop("wall_sec")
        return {
            "format": MANIFEST_FORMAT,
            "run_id": self.run_id,
            "attempt": self.attempt,
            "host": self.host,
            "pid": self.pid,
            "config_hash": self.cfg_hash,
            "start_wall": self.start_wall,
            "start_monotonic": self.start_monotonic,
            "end_wall": self._wall() if final else None,
            "end_monotonic": self._clock() if final else None,
            "exit_rc": exit_rc,
            "restart_cause": restart_cause,
            "wall_sec": wall,
            "categories": t,
            "aux": {},
            "first_step": self._first_step,
            "steps_committed": self._steps_committed,
            "mean_step_time_sec": self.mean_step_time(),
            "mfu": self.mfu(),
            "n_chips": self._n_chips,
            "flops_per_step": self._flops_per_step,
            "peak_tflops_per_chip": self._peak_tflops,
            "card": self.card,
        }

    def write_manifest(self, exit_rc: Optional[int] = None,
                       restart_cause: Optional[str] = None,
                       final: bool = False) -> Optional[str]:
        """Atomic manifest (re)write: at construction, at every metrics
        flush and from :meth:`finalize`."""
        path = self.manifest_path()
        if path is None:
            return None
        try:
            return _atomic_write_json(
                path, self.manifest(exit_rc=exit_rc,
                                    restart_cause=restart_cause, final=final))
        except OSError as e:  # a full disk must never kill the run
            from deepspeed_tpu_torch.utils.logging import logger
            logger.warning("goodput manifest write failed: %s", e)
            return None

    def finalize(self, exit_rc: Optional[int] = None) -> None:
        """End-of-attempt manifest (idempotent; wired to atexit by
        :func:`build_goodput`). The engine seldom knows its own exit code:
        the supervisor stamps it afterwards
        (:func:`finalize_attempt_manifests`)."""
        if self._finalized:
            return
        self._finalized = True
        self.write_manifest(exit_rc=exit_rc, final=True)


def build_goodput(tcfg, telemetry=None, cfg_hash: str = "", card: str = "",
                  register_atexit: bool = True
                  ) -> Optional[GoodputAccountant]:
    """``None`` unless the telemetry block and its ``goodput`` flag are
    on: the engine's hooks test ``is None``."""
    if tcfg is None or not tcfg.enabled or not getattr(tcfg, "goodput", False):
        return None
    registry = telemetry.registry if telemetry is not None else None
    acc = GoodputAccountant(registry=registry, run_dir=tcfg.dir,
                            cfg_hash=cfg_hash, card=card)
    if register_atexit:
        import atexit
        atexit.register(acc.finalize)
    return acc


# ---------------------------------------------------------------------------
# Supervisor-side manifest finalisation
# ---------------------------------------------------------------------------

def classify_exit(rc: int, immediate_restart_rcs=(), oom_rcs=(),
                  warned_rcs=()) -> str:
    """A readable restart cause from a child's exit code."""
    if rc == 0:
        return "clean"
    if rc in set(oom_rcs or ()):
        return "oom"
    if rc in set(immediate_restart_rcs or ()):
        return "watchdog"
    if rc in set(warned_rcs or ()):
        return "preemption_warned"
    if rc < 0 or rc in (128 + 15, 128 + 9):  # signal deaths (Popen: -sig)
        return "preemption"
    return "crash"


def finalize_attempt_manifests(run_dir: str, attempt: int, rc: int,
                               cause: str, start_wall: float,
                               end_wall: float) -> int:
    """Stamp exit code, restart cause and end time onto every host
    manifest of one attempt (the child may have died without its atexit).
    A child that died before building its engine left none: a stub keeps
    the attempt in the report. Returns the manifests touched."""
    prefix = f"{MANIFEST_PREFIX}a{attempt:04d}."
    touched = 0
    try:
        entries = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    except OSError:
        entries = []
    for name in entries:
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        path = os.path.join(run_dir, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        doc["exit_rc"] = rc
        doc["restart_cause"] = cause
        if doc.get("end_wall") is None:
            doc["end_wall"] = end_wall
            # the child's monotonic clock is gone: extend wall_sec to the
            # lifetime the supervisor saw, so the unattributed tail shows
            doc["wall_sec"] = max(float(doc.get("wall_sec") or 0.0),
                                  end_wall - float(doc.get("start_wall")
                                                   or start_wall))
        _atomic_write_json(path, doc)
        touched += 1
    if touched == 0 and run_dir:
        _atomic_write_json(
            os.path.join(run_dir, f"{prefix}unknown.json"),
            {"format": MANIFEST_FORMAT, "run_id": default_run_id(run_dir),
             "attempt": int(attempt), "host": "unknown", "pid": None,
             "config_hash": "", "start_wall": start_wall,
             "start_monotonic": None, "end_wall": end_wall,
             "end_monotonic": None, "exit_rc": rc, "restart_cause": cause,
             "wall_sec": max(0.0, end_wall - start_wall),
             "categories": {}, "steps_committed": 0,
             "mean_step_time_sec": None, "mfu": None, "n_chips": None,
             "flops_per_step": None})
        touched = 1
    return touched
