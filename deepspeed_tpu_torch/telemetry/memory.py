"""The crash-dump helpers of ``deepspeed_tpu/telemetry/memory.py``.

The port's copy of the four functions the guardrails' dumps need:
:func:`is_resource_exhausted`, :func:`collect_memory_snapshot` (the
``memory.json`` of a watchdog dump, read from ``torch.cuda.memory_stats``
and ``torch.cuda.mem_get_info``), :func:`min_headroom_bytes` and
:func:`write_metrics_tail`. The memory observatory itself (the model-state
ledger, the capacity planner, the OOM guard and its exit code) is not
ported yet, and the config refuses ``telemetry.memory``.
"""

import os
from typing import Any, Dict, List, Optional

import torch


def is_resource_exhausted(err: BaseException) -> bool:
    """Is this exception a device allocation failure? PyTorch raises
    ``torch.cuda.OutOfMemoryError``; an error that carries an allocator's
    ``RESOURCE_EXHAUSTED`` status counts too. Narrow on purpose: a bare
    "out of memory" quoted inside some other error does not."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{err}".lower()
    return "resource_exhausted" in msg or "resource exhausted" in msg


def _cuda_row(i: int) -> Dict[str, Any]:
    stats = torch.cuda.memory_stats(i)
    free, total = torch.cuda.mem_get_info(i)
    peak = int(stats.get("reserved_bytes.all.peak", 0))
    return {
        "id": i, "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(i),
        "stats": {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "peak_bytes_reserved": peak,
            "bytes_limit": int(total), "bytes_free": int(free),
            "num_alloc_retries": int(stats.get("num_alloc_retries", 0)),
            "num_ooms": int(stats.get("num_ooms", 0)),
        },
        "headroom_bytes": int(total) - peak,
    }


def collect_memory_snapshot() -> Dict[str, Any]:
    """Every local card's memory statistics and headroom (the device's
    memory less the caching allocator's peak reservation): the
    ``memory.json`` of a crash dump. Best effort: a process that never
    used CUDA reports one CPU row without statistics, and never starts a
    CUDA context here."""
    devices: List[Dict[str, Any]] = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            try:
                devices.append(_cuda_row(i))
            except Exception as e:  # noqa: BLE001 - the card may be gone
                devices.append({"id": i, "platform": "gpu", "stats": None,
                                "error": repr(e)})
    else:
        devices.append({"id": 0, "platform": "cpu", "device_kind": "cpu",
                        "stats": None})
    headrooms = [d["headroom_bytes"] for d in devices
                 if "headroom_bytes" in d]
    return {"devices": devices,
            "min_headroom_bytes": min(headrooms) if headrooms else None}


def min_headroom_bytes() -> Optional[int]:
    """The tightest local card's headroom, or None without one."""
    return collect_memory_snapshot()["min_headroom_bytes"]


def write_metrics_tail(out_dir: str, metrics_path: Optional[str],
                       max_bytes: int = 64 * 1024,
                       max_lines: int = 100) -> Optional[str]:
    """Write the tail of a metrics JSONL into ``<out_dir>/
    metrics_tail.jsonl`` (the trajectory into the failure). Returns the
    file's name, or None when there is nothing to tail."""
    if not metrics_path or not os.path.exists(metrics_path):
        return None
    with open(metrics_path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - max_bytes))
        tail = f.read().decode("utf-8", errors="replace")
    name = "metrics_tail.jsonl"
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("\n".join(tail.splitlines()[-max_lines:]) + "\n")
    return name
