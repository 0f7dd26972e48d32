"""Host scoping of telemetry file names.

The port's copy of the host-scoping helpers of
``deepspeed_tpu/telemetry/fleet.py``; the fleet aggregator itself (the
cross-host gather and the straggler verdicts) is not ported yet, and the
config refuses ``telemetry.fleet``. A single-process run keeps the bare
file names (``metrics.jsonl``, ``trace.json``, ``requests.jsonl``), byte
for byte the reference's; a run that spans processes, or one that sets
``DSTPU_TELEMETRY_HOST``, gains a ``.<host>.`` component so processes on
shared storage never write one file.
"""

import os
import socket
from typing import Optional

# The variable that forces a host name into every telemetry file name.
TELEMETRY_HOST_ENV = "DSTPU_TELEMETRY_HOST"


def default_host() -> str:
    return (os.environ.get(TELEMETRY_HOST_ENV)
            or socket.gethostname().replace(os.sep, "_"))


def host_scoped_path(filename: str, host: Optional[str]) -> str:
    """Insert a ``.<host>.`` component before the extension; ``host=None``
    returns the name unchanged."""
    if not host:
        return filename
    root, ext = os.path.splitext(filename)
    return f"{root}.{host}{ext}" if ext else f"{filename}.{host}"


def telemetry_host_component() -> Optional[str]:
    """The ``.<host>.`` file-name component of this process: None on a
    single-process run, the host name when ``torch.distributed`` spans
    processes or ``DSTPU_TELEMETRY_HOST`` forces it."""
    forced = os.environ.get(TELEMETRY_HOST_ENV)
    if forced:
        return forced
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return default_host()
    return None
