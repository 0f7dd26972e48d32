"""LR schedules.

The port of ``deepspeed_tpu/runtime/lr_schedules.py``: ``LRRangeTest``,
``OneCycle``, ``WarmupLR`` and ``WarmupDecayLR``, each a pure
``step -> lr`` function with the ``get_lr()/step()`` surface of a torch
scheduler. The arithmetic is float32, as in the JAX package's traced
schedules: each constant becomes float32 where the JAX code meets a
float32 array, so both give the same learning rate for the same step.
"""

import math
from typing import Callable, Dict, Optional

import numpy as np

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR"]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"
WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"

f32 = np.float32


def _clip01(x):
    return f32(min(max(x, f32(0.0)), f32(1.0)))


class _Schedule:
    """Holds ``last_step``; mirrors the torch scheduler API."""

    def __init__(self, fn: Callable[[np.float32], np.float32]):
        self._fn = fn
        self.last_step = 0

    def lr_at(self, step) -> float:
        return float(self._fn(f32(step)))

    def step(self, increment: int = 1) -> None:
        self.last_step += increment

    def get_lr(self) -> float:
        return self.lr_at(self.last_step)

    def get_last_lr(self):
        return [self.get_lr()]

    def state_dict(self) -> Dict:
        return {"last_step": self.last_step}

    def load_state_dict(self, sd: Dict) -> None:
        self.last_step = int(sd["last_step"])


class WarmupLR(_Schedule):
    """Linear warmup from min_lr to max_lr, then constant."""

    def __init__(self, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        lo, hi = float(warmup_min_lr), float(warmup_max_lr)
        n = max(int(warmup_num_steps), 1)

        def fn(step):
            frac = _clip01(step / f32(n))
            return f32(lo) + f32(hi - lo) * frac

        super().__init__(fn)
        self.last_step = last_batch_iteration + 1


class WarmupDecayLR(_Schedule):
    """Warmup then linear decay to zero over total_num_steps."""

    def __init__(self, total_num_steps: int, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        lo, hi = float(warmup_min_lr), float(warmup_max_lr)
        n = max(int(warmup_num_steps), 1)
        total = max(int(total_num_steps), n + 1)

        def fn(step):
            warm = f32(lo) + f32(hi - lo) * _clip01(step / f32(n))
            decay = f32(hi) * _clip01((f32(total) - step) / f32(total - n))
            return warm if step < n else decay

        super().__init__(fn)
        self.last_step = last_batch_iteration + 1


class OneCycle(_Schedule):
    """Two-phase cycle then decay. Phase 1: first_step_size up from
    cycle_min_lr to cycle_max_lr; phase 2: back down; then decay_lr_rate
    per post-cycle step. ``momentum_at`` gives the cycled momentum."""

    def __init__(self, cycle_min_lr: float, cycle_max_lr: float,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 decay_step_size: int = 0, decay_lr_rate: float = 0.0,
                 cycle_min_mom: float = 0.85, cycle_max_mom: float = 0.99,
                 cycle_momentum: bool = True, decay_mom_rate: float = 0.0,
                 last_batch_iteration: int = -1):
        lo, hi = float(cycle_min_lr), float(cycle_max_lr)
        up = max(int(cycle_first_step_size), 1)
        down = int(cycle_second_step_size) if cycle_second_step_size else up
        cycle_len = up + down
        dr = float(decay_lr_rate)
        ds = max(int(decay_step_size), 1)

        def fn(step):
            pos_up = _clip01(step / f32(up))
            pos_down = _clip01((step - f32(up)) / f32(down))
            cyc = (f32(lo) + f32(hi - lo) * pos_up if step < up
                   else f32(hi) - f32(hi - lo) * pos_down)
            if step < cycle_len:
                return cyc
            post = max(step - f32(cycle_len), f32(0.0))
            if dr > 0:
                return f32(lo) * (f32(1.0) / (f32(1.0) + f32(dr) * post
                                              / f32(ds)))
            return f32(lo)

        super().__init__(fn)
        self.last_step = last_batch_iteration + 1
        m_lo, m_hi = float(cycle_min_mom), float(cycle_max_mom)
        dm = float(decay_mom_rate)

        def mom_fn(step):
            pos_up = _clip01(step / f32(up))
            pos_down = _clip01((step - f32(up)) / f32(down))
            if step < cycle_len:
                return (f32(m_hi) - f32(m_hi - m_lo) * pos_up if step < up
                        else f32(m_lo) + f32(m_hi - m_lo) * pos_down)
            post = max(step - f32(cycle_len), f32(0.0))
            decayed = (f32(m_hi) * (f32(1.0) + f32(dm) * post / f32(ds))
                       if dm > 0 else f32(m_hi))
            return min(decayed, f32(m_hi))

        self._mom_fn = mom_fn if cycle_momentum else None

    def momentum_at(self, step) -> Optional[float]:
        if self._mom_fn is None:
            return None
        return float(self._mom_fn(f32(step)))


class LRRangeTest(_Schedule):
    """LR range test: ramp lr by step_rate every step_size steps, linearly
    or staircase."""

    def __init__(self, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        lo = float(lr_range_test_min_lr)
        size = max(int(lr_range_test_step_size), 1)
        rate = float(lr_range_test_step_rate)

        def fn(step):
            interval = step / f32(size)
            if lr_range_test_staircase:
                interval = f32(math.floor(interval))
            return f32(lo) * (f32(1.0) + f32(rate) * interval)

        super().__init__(fn)
        self.last_step = last_batch_iteration + 1


SCHEDULE_REGISTRY = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "OneCycle": OneCycle,
    "LRRangeTest": LRRangeTest,
}


def build_lr_schedule(name: Optional[str], params: Dict
                      ) -> Optional[_Schedule]:
    if name is None:
        return None
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown scheduler '{name}'; valid: "
                         f"{VALID_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](**params)
