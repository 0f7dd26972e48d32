"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A package of its own beside the JAX package, held against it: same config
schema, same module paths, same outputs on the same weights. It imports
torch and numpy, never jax, flax or deepspeed_tpu. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``.

Ported so far: continuous-batching GPT serving (``init_serving``) over the
inference engine (``init_inference``), with the paged decode-attention
kernel written in CUDA for Hopper.
"""

import json
from typing import Any, Dict, Optional, Union

from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.version import __version__


def init_inference(model=None, **kwargs):
    """Inference engine entry: ``init_inference(model, params=state_dict,
    dtype=torch.bfloat16, device=None)``. ``device`` None means the CUDA
    device; the CPU only when asked for."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, **kwargs)


def init_serving(model=None,
                 config: Optional[Union[str, Dict[str, Any]]] = None,
                 **kwargs):
    """Serving engine entry: continuous batching over ``init_inference``.

    ``config``: a dict (or JSON path) whose ``serving`` block configures
    the engine (``ServingConfig`` keys). Keys the port has not ported yet
    raise ``ConfigError``. Other kwargs go to ``init_inference`` (params,
    dtype, device, ...). Returns a step-driven ``ServeEngine``.
    """
    from deepspeed_tpu_torch.config.config import (ServingConfig,
                                                   check_serving_blocks)
    from deepspeed_tpu_torch.serving.engine import ServeEngine

    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    config = dict(config or {})
    check_serving_blocks(config)
    scfg = ServingConfig.from_dict(config.get("serving"))
    return ServeEngine(init_inference(model, **kwargs), config=scfg)


__all__ = ["init_inference", "init_serving", "log_dist", "logger",
           "__version__"]
