"""Jittered exponential backoff: the port of
``deepspeed_tpu/guardrails/retry.py``.

A pure delay schedule (:func:`backoff_delay`) and a helper that retries a
whole callable (:func:`retry_call`). Jitter spreads a fleet's retries
after a shared dependency hiccups; the default +-25% keeps the expected
delay equal to the un-jittered schedule.
"""

import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger


def backoff_delay(attempt: int,
                  base: float,
                  factor: float = 2.0,
                  max_delay: Optional[float] = None,
                  jitter: float = 0.25,
                  rng: Optional[random.Random] = None) -> float:
    """Delay (seconds) before retry ``attempt`` (0-based):
    ``base * factor**attempt``, capped at ``max_delay`` before jitter (the
    cap bounds the expectation, and a huge attempt count never overflows),
    then scaled by a uniform factor in ``[1-jitter, 1+jitter]``. ``rng``
    makes the jitter deterministic."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    if base < 0:
        raise ValueError("base must be >= 0")
    delay = float(base)
    for _ in range(int(attempt)):
        delay *= factor
        if max_delay is not None and delay >= max_delay:
            break
    if max_delay is not None:
        delay = min(delay, float(max_delay))
    if jitter:
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        u = (rng.uniform if rng is not None else random.uniform)(
            1.0 - jitter, 1.0 + jitter)
        delay *= u
    return delay


def retry_call(fn: Callable,
               *args,
               max_retries: int = 3,
               base: float = 0.5,
               factor: float = 2.0,
               max_delay: Optional[float] = None,
               jitter: float = 0.25,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               describe: str = "",
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` failure sleep a
    jittered exponential delay and retry, up to ``max_retries`` retries
    (``max_retries + 1`` attempts). The last failure re-raises."""
    if max_retries < 0:
        raise ValueError("max_retries must be >= 0")
    what = describe or getattr(fn, "__name__", "call")
    for attempt in range(max_retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= max_retries:
                raise
            delay = backoff_delay(attempt, base, factor=factor,
                                  max_delay=max_delay, jitter=jitter, rng=rng)
            logger.warning("%s attempt %d/%d failed (%s); retrying in %.3fs",
                           what, attempt + 1, max_retries + 1, e, delay)
            sleep(delay)
