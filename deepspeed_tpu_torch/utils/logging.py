"""Logging: a package logger and the rank-filtered ``log_dist``.

The port's copy of ``deepspeed_tpu/utils/logging.py``. The rank comes from
the launcher's environment, or from ``torch.distributed`` once it is
initialised.
"""

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str, level: int) -> logging.Logger:
    log = logging.getLogger(name)
    log.setLevel(level)
    log.propagate = False
    if not log.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        # stderr, not stdout: scripts reserve stdout for machine-readable
        # output (chip_smoke.py's JSON lines).
        log.addHandler(handler)
    return log


logger = _create_logger(
    "deepspeed_tpu_torch",
    LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(),
                   logging.INFO))


def _process_index() -> int:
    """Current process rank without forcing distributed init."""
    for var in ("DSTPU_RANK", "RANK"):
        if var in os.environ:
            try:
                return int(os.environ[var])
            except ValueError:
                pass
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (``None`` / ``[-1]``
    = all)."""
    ranks = list(ranks) if ranks is not None else []
    my_rank = _process_index()
    if not ranks or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
