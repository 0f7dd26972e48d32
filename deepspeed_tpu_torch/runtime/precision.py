"""Mixed precision and loss scaling.

The port of ``deepspeed_tpu/runtime/precision.py``. The loss-scale state
lives on the host: the engine reads the overflow flag once per optimizer
step where it is checked (fp16, or the non-finite gate), so the scaler
updates with plain Python numbers.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float         # current loss scale
    good_steps: int      # consecutive non-overflow steps
    hysteresis: int      # overflows still tolerated before backoff


class DynamicLossScaler:
    """Dynamic loss scaler. Growth: after ``scale_window`` consecutive good
    steps, scale *= scale_factor. Backoff: on overflow, hysteresis
    decrements; when exhausted scale /= factor (down to ``min_scale``)."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, hysteresis: int = 2):
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.hysteresis = int(hysteresis)

    def init(self) -> LossScaleState:
        return LossScaleState(scale=self.init_scale, good_steps=0,
                              hysteresis=self.hysteresis)

    def update(self, state: LossScaleState, overflow: bool
               ) -> LossScaleState:
        hys = max(state.hysteresis - 1, 0) if overflow else state.hysteresis
        backoff = overflow and hys == 0
        scale = (max(state.scale / self.scale_factor, self.min_scale)
                 if backoff else state.scale)
        good = 0 if overflow else state.good_steps + 1
        grow = not overflow and good >= self.scale_window
        if grow:
            scale *= self.scale_factor
            good = 0
        if backoff or not overflow:
            hys = self.hysteresis
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hys)


class StaticLossScaler:
    """A fixed loss scale."""

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)

    def init(self) -> LossScaleState:
        return LossScaleState(scale=self.scale, good_steps=0, hysteresis=0)

    def update(self, state: LossScaleState, overflow: bool
               ) -> LossScaleState:
        return state


def make_loss_scaler(fp16_enabled: bool, dynamic: bool, static_scale: float,
                     initial_scale_power: int, scale_window: int,
                     min_scale: float, hysteresis: int):
    if not fp16_enabled:
        return StaticLossScaler(1.0)
    if dynamic:
        return DynamicLossScaler(init_scale=2.0 ** initial_scale_power,
                                 scale_window=scale_window,
                                 min_scale=min_scale, hysteresis=hysteresis)
    return StaticLossScaler(static_scale)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class PrecisionPolicy:
    """Casting rules: the compute dtype for forward and backward, fp32
    masters for the update."""

    def __init__(self, dtype_name: str):
        if dtype_name not in _DTYPES:
            raise ValueError(f"unknown precision {dtype_name}")
        self.name = dtype_name
        self.dtype = _DTYPES[dtype_name]
        self.mixed = dtype_name != "float32"

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.mixed and t.is_floating_point():
            return t.to(self.dtype)
        return t

    def cast_params(self, params):
        """The params in the compute dtype (the masters themselves when
        nothing is mixed)."""
        return [self.cast(v) for v in params]
