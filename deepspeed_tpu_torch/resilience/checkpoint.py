"""Preemption-safe checkpointing: the port of
``deepspeed_tpu/resilience/checkpoint.py``.

- **off the step path**: ``save()`` enqueues a device-to-host copy of
  every state leaf into host buffers (pinned on the card) and returns; a
  background writer thread waits for the copies, then serialises and
  writes;
- **double-buffered**: at most one snapshot is being written and one
  pending; a newer snapshot replaces the pending one (latest wins), so a
  slow disk skips intermediate checkpoints and never stalls training;
- **atomic commit**: shards and the manifest are written into a
  ``.tmp-`` directory which is ``os.replace``d to ``step_%08d``; a
  directory so named with a parseable manifest is a complete checkpoint;
- **verified**: the manifest records a sha256 per shard (with shape and
  dtype); a restore re-hashes and falls back past a damaged checkpoint;
- **retried**: a failed write retries with the shared jittered backoff;
  a write that fails after its retries is logged and counted, and
  training goes on;
- **garbage-collected**: keep-last-N after every commit.

The on-disk format is the JAX package's, file for file (``MANIFEST_FORMAT``
1, ``shard_%05d.bin`` raw C-order bytes, the same dtype strings, bf16
stored widened to fp32), so each package's reader opens the other's
directory; names are the port's (``models/convert.py`` maps a JAX-written
state's names).

The port updates the masters and moments in place where JAX arrays are
immutable, so a snapshot is taken with care: the copies are enqueued on
the current stream, which orders them before the next step's in-place
writes; the writer waits on an event recorded after them before it reads
the host buffers; and each pending or in-flight snapshot owns its buffer
set, so a snapshot that replaces another never reuses the buffers the
writer is reading (at most three sets exist).

With the engine's telemetry the manager traces ``ckpt_snapshot`` and
``ckpt_write`` spans and emits the ``ckpt/*`` gauges and counters beside
``resilience_metrics.jsonl``; with its goodput accountant the snapshot on
the step path is booked as ``ckpt_snapshot`` and a wait for the writer
(a synchronous write, ``wait()``) as ``ckpt_write_stall``.
"""

import atexit
import contextlib
import hashlib
import json
import os
import pickle
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.guardrails.retry import backoff_delay
from deepspeed_tpu_torch.resilience.fault import (RESUME_ATTEMPT_ENV,
                                                  FaultPlan,
                                                  corrupt_one_shard)
from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_FILE = "manifest.json"
CLIENT_STATE_FILE = "client_state.pkl"
METRICS_FILE = "resilience_metrics.jsonl"
MANIFEST_FORMAT = 1
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp-"


class ResilienceError(RuntimeError):
    pass


class MetricsJSONL:
    """Append-only ``{tag, value, step, [extra]}`` JSONL scalar log, the
    JAX package's ``utils/monitor.MetricsJSONL`` row format. Thread-safe
    and line-buffered."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int, **extra) -> None:
        with self._lock:
            if self._f.closed:
                return
            row = {"tag": tag, "value": float(value), "step": int(step)}
            row.update(extra)
            self._f.write(json.dumps(row) + "\n")

    def read(self, tag: Optional[str] = None) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return [r for r in rows if tag is None or r.get("tag") == tag]

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                      torch.float16: "float16", torch.float64: "float64",
                      torch.int32: "int32", torch.int64: "int64",
                      torch.uint8: "uint8", torch.bool: "bool"}


def _storable(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array, original dtype string) of a host leaf. bfloat16 has no
    numpy dtype: it is stored widened to fp32 (lossless) under the name
    "bfloat16", as the JAX package stores it."""
    if isinstance(leaf, torch.Tensor):
        orig = _TORCH_DTYPE_NAMES[leaf.dtype]
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy(), orig
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class _Snapshot:
    """A host-side copy of everything a resume needs. ``ready``: the CUDA
    event recorded after the copies (None when they were synchronous);
    ``buffers``: the buffer set the tensors live in, returned to its pool
    once written or dropped."""

    def __init__(self, step: int, arrays: List[Tuple[str, Any]],
                 meta: Dict[str, Any], client_state: Dict[str, Any],
                 ready=None, buffers=None):
        self.step = step
        self.arrays = arrays
        self.meta = meta
        self.client_state = client_state
        self.ready = ready
        self.buffers = buffers

    def wait(self) -> None:
        """Block until the device-to-host copies have landed."""
        if self.ready is not None:
            self.ready.synchronize()


class _BufferPool:
    """Host buffer sets for snapshots, reused across saves: a set is free
    once its snapshot was written or dropped."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._free: List[List[torch.Tensor]] = []
        self._lock = threading.Lock()
        self.allocated = 0

    def acquire(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        spec = [(t.shape, t.dtype) for t in leaves]
        with self._lock:
            for i, bufs in enumerate(self._free):
                if [(b.shape, b.dtype) for b in bufs] == spec:
                    return self._free.pop(i)
        self.allocated += 1
        return [torch.empty(s, dtype=d, pin_memory=self.pin)
                for s, d in spec]

    def release(self, bufs: Optional[List[torch.Tensor]]) -> None:
        if bufs is not None:
            with self._lock:
                self._free.append(bufs)


def snapshot_engine(engine, client_state: Optional[Dict] = None,
                    pool: Optional[_BufferPool] = None) -> _Snapshot:
    """Copy the engine's state to the host. Every tensor leaf's copy is
    enqueued (``non_blocking`` into pinned buffers from ``pool`` on the
    card) before anything waits; on the card an event after them is the
    snapshot's ``ready``. Without a pool the copies are synchronous."""
    named = engine._snapshot_state()
    tensors = [(i, leaf) for i, (_n, leaf) in enumerate(named)
               if isinstance(leaf, torch.Tensor)]
    on_card = any(leaf.is_cuda for _i, leaf in tensors)
    arrays: List[Tuple[str, Any]] = list(named)
    bufs, ready = None, None
    if pool is not None:
        bufs = pool.acquire([leaf for _i, leaf in tensors])
        for buf, (i, leaf) in zip(bufs, tensors):
            buf.copy_(leaf.detach(), non_blocking=on_card)
            arrays[i] = (named[i][0], buf)
        if on_card:
            ready = torch.cuda.Event()
            ready.record()
    else:
        for i, leaf in tensors:
            arrays[i] = (named[i][0], leaf.detach().to("cpu", copy=True))
    meta = {
        "format": MANIFEST_FORMAT,
        "step": int(engine.global_steps),
        "micro_steps": int(engine.micro_steps),
        "elastic_hash": "",
        "elastic_epoch": 0,
        "world_size": 1,
        "dp_world_size": 1,
        "zero_stage": int(engine.config.zero_config.stage),
        "ds_version": _version(),
        "lr_scheduler": (engine.lr_scheduler.state_dict()
                         if engine.lr_scheduler is not None else None),
    }
    return _Snapshot(meta["step"], arrays, meta, client_state or {},
                     ready=ready, buffers=bufs)


def _version() -> str:
    from deepspeed_tpu_torch.version import __version__

    return __version__


def _fsync_write(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_snapshot(snap: _Snapshot, directory: str,
                   fault_plan: Optional[FaultPlan] = None) -> None:
    """Write ``snap``'s shards, client state and manifest into
    ``directory`` (which must exist), each file fsynced; the manifest goes
    last. ``fault_plan.take_io_error`` can fail a shard write."""
    snap.wait()
    shards: Dict[str, Dict[str, Any]] = {}
    for i, (name, leaf) in enumerate(snap.arrays):
        stored, orig_dtype = _storable(leaf)
        fname = f"shard_{i:05d}.bin"
        # the raw C-order bytes, without a copy where the array allows
        data = memoryview(np.ascontiguousarray(stored).reshape(-1)
                          .view(np.uint8))
        if fault_plan is not None and fault_plan.take_io_error():
            raise OSError(f"injected checkpoint I/O error ({fname})")
        _fsync_write(os.path.join(directory, fname), data)
        shards[name] = {"file": fname,
                        "sha256": hashlib.sha256(data).hexdigest(),
                        "shape": list(stored.shape),
                        "stored_dtype": str(stored.dtype),
                        "dtype": orig_dtype}
    cs_blob = pickle.dumps(snap.client_state)
    _fsync_write(os.path.join(directory, CLIENT_STATE_FILE), cs_blob)
    manifest = dict(snap.meta)
    manifest["shards"] = shards
    manifest["client_state_sha256"] = hashlib.sha256(cs_blob).hexdigest()
    _fsync_write(os.path.join(directory, MANIFEST_FILE),
                 json.dumps(manifest, indent=1).encode())


class AsyncCheckpointManager:
    """Background double-buffered checkpoint writer. One per engine."""

    def __init__(self, ckpt_dir: str, interval: int = 1, keep_last: int = 3,
                 max_retries: int = 3, backoff: float = 0.05,
                 async_write: bool = True,
                 fault_plan: Optional[FaultPlan] = None, monitor=None,
                 telemetry=None, goodput=None):
        if interval < 1:
            raise ValueError("checkpoint interval must be >= 1")
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.telemetry = telemetry
        self.goodput = goodput
        self.ckpt_dir = ckpt_dir
        self.interval = int(interval)
        self.keep_last = int(keep_last)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.async_write = bool(async_write)
        self.fault_plan = fault_plan
        self.monitor = monitor
        self.stats = {"saved": 0, "dropped": 0, "retries": 0, "failed": 0}
        self.last_error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)
        self.metrics = MetricsJSONL(os.path.join(ckpt_dir, METRICS_FILE))
        self._pool = _BufferPool(pin=torch.cuda.is_available())
        self._cv = threading.Condition()
        self._pending: Optional[_Snapshot] = None
        self._writing = False
        self._closed = False
        # test hook: clear to hold the writer before it takes a snapshot
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._thread = None
        if self.async_write:
            self._thread = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._thread.start()
            # the writer is a daemon (it must never block a SIGTERM
            # teardown): a clean exit drains it first
            atexit.register(self._drain_at_exit)

    # ------------------------------------------------------------------
    def save(self, engine, client_state: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now; write in the background (or inline when
        ``async_write=False``). Never raises for write errors: the writer
        retries, and terminal failures land in ``stats['failed']`` /
        ``last_error`` and the log."""
        t0 = time.monotonic()
        with self._measure("ckpt_snapshot"), self._span(
                "ckpt_snapshot", step=int(engine.global_steps)):
            snap = snapshot_engine(engine, client_state=client_state,
                                   pool=self._pool)
        snap.meta["snapshot_sec"] = round(time.monotonic() - t0, 6)
        if not self.async_write:
            with self._measure("ckpt_write_stall"):
                self._write_with_retries(snap)
            return
        with self._cv:
            if self._closed:
                self._pool.release(snap.buffers)
                raise ResilienceError("AsyncCheckpointManager is closed")
            if self._pending is not None:
                # one writing + one pending; latest wins
                self.stats["dropped"] += 1
                self._counter("ckpt/dropped", step=snap.step)
                logger.warning(
                    "async checkpoint backlog: dropping pending step %d "
                    "snapshot in favour of step %d", self._pending.step,
                    snap.step)
                self._pool.release(self._pending.buffers)
            self._pending = snap
            self._cv.notify_all()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Returns once no snapshot is pending or being written (the
        caller blocks on checkpoint I/O: goodput's ``ckpt_write_stall``)."""
        with self._measure("ckpt_write_stall"), self._cv:
            self._cv.wait_for(
                lambda: self._pending is None and not self._writing)

    def _measure(self, category: str):
        """A goodput interval when the engine's accountant was handed in."""
        if self.goodput is not None:
            return self.goodput.measure(category)
        return contextlib.nullcontext()

    def _span(self, name: str, **args):
        """A tracer span when the engine's telemetry was handed in."""
        if self.telemetry is not None:
            return self.telemetry.span(name, **args)
        return contextlib.nullcontext()

    def _counter(self, name: str, step: int) -> None:
        if self.telemetry is not None:
            self.telemetry.registry.counter(name).inc(step=step)

    def _drain_at_exit(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 - never raise during teardown
            pass

    def close(self) -> None:
        if self._thread is not None:
            self.wait()
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._thread.join(timeout=30)
            self._thread = None
            atexit.unregister(self._drain_at_exit)
        self.metrics.close()

    # ------------------------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            self._unpaused.wait()
            with self._cv:
                self._cv.wait_for(
                    lambda: self._pending is not None or self._closed)
                if self._pending is None and self._closed:
                    return
                snap, self._pending = self._pending, None
                self._writing = True
                self._cv.notify_all()
            try:
                self._write_with_retries(snap)
            finally:
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()

    def _write_with_retries(self, snap: _Snapshot) -> None:
        t0 = time.monotonic()
        try:
            for attempt in range(self.max_retries + 1):
                try:
                    with self._span("ckpt_write", step=snap.step):
                        path = self._write_once(snap)
                    break
                except Exception as e:  # noqa: BLE001 - retry any fault
                    self.last_error = e
                    if attempt >= self.max_retries:
                        self.stats["failed"] += 1
                        self._counter("ckpt/failed", step=snap.step)
                        logger.error(
                            "checkpoint step %d failed after %d attempts: "
                            "%s", snap.step, attempt + 1, e)
                        return
                    self.stats["retries"] += 1
                    self._counter("ckpt/retries", step=snap.step)
                    delay = backoff_delay(attempt, self.backoff,
                                          max_delay=60.0, jitter=0.25)
                    logger.warning(
                        "checkpoint step %d write attempt %d failed (%s); "
                        "retrying in %.3fs", snap.step, attempt + 1, e,
                        delay)
                    time.sleep(delay)
        finally:
            self._pool.release(snap.buffers)
        latency = time.monotonic() - t0
        self.stats["saved"] += 1
        self.metrics.add_scalar("Train/Checkpoint/write_latency_sec",
                                latency, snap.step)
        self.metrics.add_scalar("Train/Checkpoint/snapshot_sec",
                                snap.meta.get("snapshot_sec", 0.0), snap.step)
        if self.telemetry is not None:
            reg = self.telemetry.registry
            reg.gauge("ckpt/write_latency_sec").set(latency, step=snap.step)
            reg.gauge("ckpt/snapshot_sec").set(
                snap.meta.get("snapshot_sec", 0.0), step=snap.step)
            self._counter("ckpt/saved", step=snap.step)
        elif self.monitor is not None:
            self.monitor.add_scalar("Train/Checkpoint/write_latency_sec",
                                    latency, snap.step)
        logger.info("checkpoint step %d committed to %s (%.3fs)",
                    snap.step, path, latency)
        if (self.fault_plan is not None
                and self.fault_plan.should_corrupt(snap.step)):
            corrupt_one_shard(path, _read_manifest(path))
        self._gc()

    def _write_once(self, snap: _Snapshot) -> str:
        final = os.path.join(self.ckpt_dir, f"step_{snap.step:08d}")
        tmp = os.path.join(self.ckpt_dir,
                           f"{_TMP_PREFIX}step_{snap.step:08d}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)   # left over from a failed earlier attempt
        os.makedirs(tmp)
        write_snapshot(snap, tmp, self.fault_plan)
        if os.path.isdir(final):
            shutil.rmtree(final)   # a re-save of the same step supersedes
        os.replace(tmp, final)     # the atomic commit
        return final

    def _gc(self) -> None:
        for _, path in list_checkpoints(self.ckpt_dir)[:-self.keep_last]:
            shutil.rmtree(path, ignore_errors=True)
            logger.info("checkpoint GC: removed %s", path)


# ---------------------------------------------------------------------------
# Load / resume side
# ---------------------------------------------------------------------------

def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """[(step, path)] of committed checkpoints, oldest first. A ``.tmp-``
    directory left by a death mid-write never matches."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for entry in os.listdir(ckpt_dir):
        m = _STEP_DIR_RE.match(entry)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, entry)))
    return sorted(out)


def _read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        return json.load(f)


def read_shards(path: str, manifest: Dict[str, Any],
                names: Optional[Callable[[str], bool]] = None
                ) -> Dict[str, np.ndarray]:
    """Read and digest-verify the shards of one checkpoint directory (those
    whose names ``names`` accepts, all by default). Raises
    ``ResilienceError`` on a mismatch. The arrays are writable."""
    if manifest.get("format") != MANIFEST_FORMAT:
        raise ResilienceError(
            f"unsupported manifest format {manifest.get('format')}")
    arrays: Dict[str, np.ndarray] = {}
    for name, rec in manifest["shards"].items():
        if names is not None and not names(name):
            continue
        fname = os.path.join(path, rec["file"])
        data = bytearray(os.path.getsize(fname))
        with open(fname, "rb") as f:
            f.readinto(data)
        digest = hashlib.sha256(data).hexdigest()
        if digest != rec["sha256"]:
            raise ResilienceError(
                f"shard {name!r} digest mismatch in {path} "
                f"({digest[:12]} != {rec['sha256'][:12]}): torn or corrupt")
        arr = np.frombuffer(data, dtype=np.dtype(rec["stored_dtype"]))
        arrays[name] = arr.reshape(rec["shape"])
    return arrays


def _load_verified(path: str):
    """Read and digest-verify every shard and the client state of one
    checkpoint. Raises on any mismatch: the caller falls back."""
    manifest = _read_manifest(path)
    arrays = read_shards(path, manifest)
    cs_path = os.path.join(path, CLIENT_STATE_FILE)
    client_state: Dict[str, Any] = {}
    if os.path.exists(cs_path):
        with open(cs_path, "rb") as f:
            blob = f.read()
        if (hashlib.sha256(blob).hexdigest()
                != manifest.get("client_state_sha256")):
            raise ResilienceError(f"client_state digest mismatch in {path}")
        client_state = pickle.loads(blob)
    return manifest, arrays, client_state


def find_restorable(ckpt_dir: str):
    """Newest complete, digest-verified checkpoint, falling back past any
    damaged one. Returns (path, manifest, arrays, client_state) or None
    when nothing usable exists."""
    for _step, path in reversed(list_checkpoints(ckpt_dir)):
        try:
            manifest, arrays, client_state = _load_verified(path)
            return path, manifest, arrays, client_state
        except Exception as e:  # noqa: BLE001 - any damage means fall back
            logger.warning("checkpoint %s unusable (%s); falling back to "
                           "previous", path, e)
    return None


def _shape(x) -> Tuple[int, ...]:
    """A leaf's shape, a tensor's (bf16 has no numpy form) or an array's."""
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(
        np.shape(x))


def install_state_arrays(engine, arrays: Dict[str, np.ndarray], *,
                         step: int, micro_steps: int,
                         lr_scheduler_state: Optional[Dict] = None,
                         keep_prefixes: Tuple[str, ...] = ()) -> None:
    """Copy named host arrays (numpy, or the host tensors of an in-memory
    snapshot) into ``engine``'s live state (in place: the masters stay the
    module's parameter tensors), then set the step
    counters and the scheduler state. Leaves named with one of
    ``keep_prefixes`` keep the engine's values. A missing leaf or a shape
    that differs raises ``ResilienceError``; a missing ``rng`` (a state
    the JAX package wrote: its key cannot seed a torch generator) keeps
    the engine's generator, with a logged line."""
    template = engine._snapshot_state()
    wanted = [(n, leaf) for n, leaf in template
              if not n.startswith(keep_prefixes)]
    missing = [n for n, _ in wanted if n not in arrays and n != "rng"]
    if missing:
        raise ResilienceError(
            f"snapshot lacks state leaves {missing[:5]}: was it written by "
            f"a different model/optimizer configuration?")
    if "rng" not in arrays:
        logger.warning("restore: the snapshot has no 'rng' leaf; the "
                       "engine's dropout-seed generator is kept")
    for name, leaf in wanted:
        if name in arrays and _shape(arrays[name]) != _shape(leaf):
            raise ResilienceError(
                f"leaf {name!r}: snapshot shape {_shape(arrays[name])} != "
                f"engine shape {_shape(leaf)}")
    engine._apply_restored_state({n: arrays[n] for n, _ in wanted
                                  if n in arrays})
    engine.global_steps = int(step)
    engine.micro_steps = int(micro_steps)
    if engine.lr_scheduler is not None and lr_scheduler_state:
        engine.lr_scheduler.load_state_dict(lr_scheduler_state)


def restore(engine, ckpt_dir: str, monitor=None,
            convert: Optional[Callable[[Dict[str, np.ndarray]],
                                       Dict[str, np.ndarray]]] = None):
    """Auto-resume: load the newest complete checkpoint under ``ckpt_dir``
    into ``engine``. ``convert`` maps the arrays' names first (e.g.
    ``models/convert.state_arrays_from_flax`` for a directory the JAX
    package wrote). Returns ``(path, client_state)``, or ``(None, {})``
    when there is nothing to resume from."""
    found = find_restorable(ckpt_dir)
    if found is None:
        logger.info("auto-resume: no usable checkpoint under %s: fresh "
                    "start", ckpt_dir)
        return None, {}
    path, manifest, arrays, client_state = found
    if convert is not None:
        arrays = convert(arrays)
    try:
        install_state_arrays(engine, arrays, step=int(manifest["step"]),
                             micro_steps=int(manifest["micro_steps"]),
                             lr_scheduler_state=manifest.get("lr_scheduler"))
    except ResilienceError as e:
        raise ResilienceError(f"checkpoint {path}: {e}") from e
    attempt = int(os.environ.get(RESUME_ATTEMPT_ENV, "0") or 0)
    engine.recovery_count = attempt
    if monitor is not None:
        monitor.add_scalar("Train/Resilience/recovery_count", attempt,
                           engine.global_steps)
    if getattr(engine, "ckpt_manager", None) is not None:
        engine.ckpt_manager.metrics.add_scalar(
            "Train/Resilience/recovery_count", attempt, engine.global_steps)
    logger.warning("auto-resume: restored %s at global step %d (attempt %d)",
                   path, engine.global_steps, attempt)
    return path, client_state
