"""The device-sync primitive of the port.

The port's copy of ``_device_synchronize`` from
``deepspeed_tpu/utils/timer.py``: the one place where telemetry waits for
the card. The step tracer's span boundaries call it (``sync_spans``), so a
test counts every telemetry-made sync by patching this one function.

Where the reference swallows every exception, this one raises: a CUDA fault
that surfaces at a span boundary must leave the step, not vanish into the
telemetry.
"""

import torch


def _device_synchronize(device) -> None:
    """Wait for all work queued on ``device``: ``torch.cuda.synchronize``
    on a CUDA device, nothing on the CPU (its work is done when the call
    returns). ``device``: a ``torch.device``, a string, or None for the
    CPU."""
    if device is None:
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
