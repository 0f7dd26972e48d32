"""Per-step anomaly detection over loss and global grad norm: the port of
``deepspeed_tpu/guardrails/detector.py``, pure host code, line for line.

The fp16 engine already skips an overflowed update (the dynamic loss
scaler), but a bf16 run has no numeric guardrail of its own: a poisoned
batch or an instability NaNs the loss, the NaN gradients commit into the
masters, and every later step trains garbage, silently, because nothing on
the step path looks at the loss. This detector is the host-side watchpost:
it classifies every committed step as

- ``ok``    — finite and statistically unremarkable;
- ``skip``  — the engine itself skipped the update (fp16 overflow, or the
  config-gated bf16 nonfinite-grad check): state is untouched, nothing to
  learn from the garbage scalars, so the trackers ignore them;
- ``spike`` — non-finite loss/norm that DID commit, or a finite value whose
  z-score against an exponentially-weighted mean/variance exceeds the
  threshold. State is suspect; :mod:`~deepspeed_tpu_torch.guardrails.rollback`
  decides what to do about it.

EWMA/z-score rather than fixed thresholds: loss scales vary by orders of
magnitude across models and schedules, and the early-training descent is
steep — an absolute "loss > X" rule is either deaf or trigger-happy. The
exponentially-weighted tracker follows the trajectory with O(1) state and
no window buffer; spikes are *excluded* from the update so a genuine
anomaly cannot drag the baseline toward itself and mask its successors.
"""

import math
from dataclasses import dataclass
from typing import Optional

# Verdicts (string enum kept as plain constants: they travel into telemetry
# tags and log lines as-is).
OK = "ok"
SKIP = "skip"
SPIKE = "spike"


@dataclass
class Verdict:
    """One step's classification plus the evidence behind it."""

    kind: str                       # OK | SKIP | SPIKE
    reason: str = ""                # "", "overflow", "nonfinite", "zscore"
    loss_z: float = 0.0
    norm_z: float = 0.0

    def __bool__(self) -> bool:     # truthy == anomalous
        return self.kind == SPIKE


class EWMATracker:
    """Exponentially-weighted mean/variance with a sigma floor.

    Standard EW update (West 1979 form): ``diff = x - mean``;
    ``mean += alpha * diff``; ``var = (1-alpha) * (var + alpha * diff^2)``.
    The sigma floor (``abs_floor + rel_floor * |mean|``) keeps the z-score
    finite on flat-lined signals (a converged loss has sigma -> 0 and any
    wiggle would otherwise read as an infinite spike).
    """

    def __init__(self, alpha: float = 0.02, abs_floor: float = 1e-8,
                 rel_floor: float = 1e-3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.abs_floor = float(abs_floor)
        self.rel_floor = float(rel_floor)
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def sigma(self) -> float:
        return math.sqrt(max(self.var, 0.0)) + self.abs_floor + \
            self.rel_floor * abs(self.mean)

    def zscore(self, x: float) -> float:
        if self.count == 0:
            return 0.0
        return (x - self.mean) / self.sigma()

    def update(self, x: float) -> None:
        if self.count == 0:
            self.mean = x
            self.var = 0.0
        else:
            diff = x - self.mean
            self.mean += self.alpha * diff
            self.var = (1.0 - self.alpha) * (self.var +
                                             self.alpha * diff * diff)
        self.count += 1

    def state_dict(self) -> dict:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.mean = float(sd["mean"])
        self.var = float(sd["var"])
        self.count = int(sd["count"])


class AnomalyDetector:
    """Classify per-step (loss, grad_norm, overflow) host scalars.

    ``warmup_steps`` observations are absorbed before any z-score verdict —
    the early-training loss cliff would otherwise read as a run of spikes.
    Non-finite values are spikes at ANY step (warmup included): there is no
    baseline under which NaN is fine.
    """

    def __init__(self,
                 zscore_threshold: float = 6.0,
                 warmup_steps: int = 20,
                 ewma_alpha: float = 0.02,
                 track_grad_norm: bool = True):
        if zscore_threshold <= 0:
            raise ValueError("zscore_threshold must be > 0")
        if warmup_steps < 1:
            raise ValueError("warmup_steps must be >= 1")
        self.zscore_threshold = float(zscore_threshold)
        self.warmup_steps = int(warmup_steps)
        self.track_grad_norm = bool(track_grad_norm)
        self.loss_tracker = EWMATracker(alpha=ewma_alpha)
        self.norm_tracker = EWMATracker(alpha=ewma_alpha)
        self.stats = {OK: 0, SKIP: 0, SPIKE: 0}

    # ------------------------------------------------------------------
    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None,
                overflow: bool = False) -> Verdict:
        """One committed (or engine-skipped) step's scalars -> verdict."""
        if overflow:
            # The engine already refused the update; the scalars are the
            # garbage that triggered the refusal — do not learn from them.
            return self._count(Verdict(SKIP, reason="overflow"))
        loss = float(loss)
        nonfinite = not math.isfinite(loss)
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            nonfinite = nonfinite or not math.isfinite(grad_norm)
        if nonfinite:
            return self._count(Verdict(SPIKE, reason="nonfinite",
                                       loss_z=float("inf")))
        loss_z = self.loss_tracker.zscore(loss)
        norm_z = (self.norm_tracker.zscore(grad_norm)
                  if self.track_grad_norm and grad_norm is not None else 0.0)
        warm = self.loss_tracker.count >= self.warmup_steps
        if warm and max(loss_z, norm_z) > self.zscore_threshold:
            # Spikes are excluded from the EWMA so an anomaly cannot pull
            # the baseline toward itself.
            return self._count(Verdict(SPIKE, reason="zscore",
                                       loss_z=loss_z, norm_z=norm_z))
        self.loss_tracker.update(loss)
        if self.track_grad_norm and grad_norm is not None:
            self.norm_tracker.update(grad_norm)
        return self._count(Verdict(OK, loss_z=loss_z, norm_z=norm_z))

    def _count(self, v: Verdict) -> Verdict:
        self.stats[v.kind] += 1
        return v

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"loss": self.loss_tracker.state_dict(),
                "norm": self.norm_tracker.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.loss_tracker.load_state_dict(sd["loss"])
        self.norm_tracker.load_state_dict(sd["norm"])
