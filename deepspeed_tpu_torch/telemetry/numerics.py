"""Numerics observatory of training: the port of the engine half of
``deepspeed_tpu/telemetry/numerics.py``. Per-layer-group gradient, weight
and update statistics and the compute dtype's saturation and underflow
counts.

A :class:`NumericsPlan` groups the masters by their top-level name (the
flax tree's top-level key: ``wte``, ``h_0``, ``ln_f``, ...; a
``ModuleList`` index joins its parent with ``_``, so the port's
``h.0.attn...`` is group ``h_0``), in sorted order as the JAX tree
flattens, capped at ``max_groups`` (the tail collapses into ``_other``).
The engine's apply computes, on the device and once per step, a ``[groups,
5]`` fp32 array: per group the squared norms of the gradient (unscaled,
before clipping), the weights (before the update) and the committed update
(new minus old masters; 0 on a skipped step), and in a mixed-precision run
the elements whose finite fp32 gradient is not finite in the compute dtype
(saturated) or is non-zero there but rounds to zero (underflowed). With
numerics on, the engine's fp32 gradient buffers are views of one flat
buffer laid out group by group, so each statistic is one reduction a
group. Adam's fused update writes the masters in place, so the update
norm reads a flat copy of the old masters the engine keeps only while
numerics is on.

The array stays on the card; :meth:`NumericsObservatory.flush` reads it
back once, at the metrics flush (``_fetch`` is the one site, so a test
counts it), and emits the ``numerics/*`` gauges. A guardrails spike asks
:meth:`NumericsObservatory.worst_group` and
:meth:`NumericsObservatory.group_table`, as in the reference. The
quantization-error gauges of the reference's DCN all-reduce and ZeRO++
hops are not here: those paths are not ported (serving's int8 KV-cache
gauges are the serving engine's).
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

# the columns of the per-group statistics
GRAD_SQ, WEIGHT_SQ, UPDATE_SQ, SATURATED, UNDERFLOWED = range(5)
N_GROUP_STATS = 5

# the group the leaves past ``max_groups`` collapse into
OTHER_GROUP = "_other"

NUMERICS_METRIC_TAGS = frozenset({
    "numerics/grad_norm",
    "numerics/weight_norm",
    "numerics/update_ratio",
    "numerics/saturation_count",
    "numerics/underflow_count",
    "numerics/global_grad_norm",
})


def top_key(name: str) -> str:
    """The group of one parameter name: its first component, joined with
    the second when that is a ``ModuleList`` index (``h.0.attn.w`` ->
    ``h_0``)."""
    parts = name.split(".")
    if len(parts) > 1 and parts[1].isdigit():
        return f"{parts[0]}_{parts[1]}"
    return parts[0]


class NumericsPlan:
    """The grouping and the statistics of one step, on the device.

    The statistics run group by group over one flat fp32 buffer whose
    leaves lie group after group (:meth:`flat_like`): a dozen operations a
    group, where a pass per leaf would launch a dozen per tensor (GPT-2
    has 148) and make the host, not the card, the step's pace."""

    def __init__(self, param_names: Sequence[str], max_groups: int = 16,
                 compute_dtype: Optional[torch.dtype] = None):
        keys = [top_key(n) for n in param_names]
        ordered = sorted(set(keys))
        if len(ordered) > int(max_groups):
            # keep the first max_groups - 1 groups, the tail in _other
            self.group_names = ordered[:int(max_groups) - 1] + [OTHER_GROUP]
        else:
            self.group_names = ordered
        index = {n: i for i, n in enumerate(self.group_names)}
        other = index.get(OTHER_GROUP)
        self.leaf_group = [index.get(k, other) for k in keys]
        self.num_groups = len(self.group_names)
        # the leaves in the flat buffer's order: group by group
        self.order = sorted(range(len(keys)), key=self.leaf_group.__getitem__)
        # saturation and underflow are measured against the compute dtype;
        # None or fp32: the counts are 0
        self.compute_dtype = (None if compute_dtype in (None, torch.float32)
                              else compute_dtype)
        self._numels: Optional[List[int]] = None
        self._offsets: List[int] = []
        self._bounds: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------
    def _layout(self, tensors: Sequence[torch.Tensor]) -> None:
        numels = [t.numel() for t in tensors]
        if self._numels == numels:
            return
        self._numels = numels
        self._offsets = [0] * len(numels)
        self._bounds = [(0, 0)] * self.num_groups
        pos = 0
        for i in self.order:
            g = self.leaf_group[i]
            if self._bounds[g] == (0, 0):
                self._bounds[g] = (pos, pos)
            self._offsets[i] = pos
            pos += numels[i]
            self._bounds[g] = (self._bounds[g][0], pos)

    def flat_like(self, tensors: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One fp32 buffer for ``tensors`` laid out group by group, and a
        view of it shaped as each tensor (in their own order)."""
        self._layout(tensors)
        flat = torch.empty(sum(self._numels), dtype=torch.float32,
                           device=tensors[0].device)
        views = [flat[o:o + t.numel()].view(t.shape)
                 for o, t in zip(self._offsets, tensors)]
        return flat, views

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``tensors`` copied into a new buffer of :meth:`flat_like`."""
        flat, views = self.flat_like(tensors)
        torch._foreach_copy_(views, [t.float() for t in tensors])
        return flat

    def stats(self, grads: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[groups, 5]`` fp32 from flat buffers of :meth:`flat_like`'s
        layout: each group's gradient and weight sums of squares and its
        saturation and underflow counts (the update column 0).
        ``grads``: the unscaled fp32 gradients, before clipping."""
        zero = grads.new_zeros(())
        cdt = self.compute_dtype
        rows = []
        for a, b in self._bounds:
            g = grads[a:b]
            row = [torch.sum(torch.square(g)),
                   torch.sum(torch.square(weights[a:b]))
                   if weights is not None else zero, zero]
            if cdt is not None:
                gc = g.to(cdt)
                row.append(torch.count_nonzero(~torch.isfinite(gc)
                                               & torch.isfinite(g)).float())
                row.append(torch.count_nonzero((gc == 0)
                                               & (g != 0)).float())
            else:
                row += [zero, zero]
            rows.append(torch.stack(row))
        return torch.stack(rows)

    def update_sq(self, delta: torch.Tensor) -> torch.Tensor:
        """Each group's squared update norm from a flat buffer of ``new -
        old`` (or ``old - new``)."""
        return torch.stack([torch.sum(torch.square(delta[a:b]))
                            for a, b in self._bounds])

    def group_stats(self, grads: List[torch.Tensor],
                    params: Optional[List[torch.Tensor]] = None,
                    new_params: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """The ``[groups, 5]`` statistics of one step from its gradients,
        the masters before the update and (optional) after it: the
        reference's ``group_stats`` in one call."""
        weights = self.flatten(params) if params is not None else None
        out = self.stats(self.flatten(grads), weights)
        if weights is not None and new_params is not None:
            out[:, UPDATE_SQ] = self.update_sq(
                self.flatten(new_params).sub_(weights))
        return out


class NumericsObservatory:
    """Host-side facade: keeps each step's device array (no transfer),
    reads it once at the flush, emits the gauges, and answers the
    guardrails' "which layer group?"."""

    def __init__(self, cfg, plan: NumericsPlan, telemetry=None):
        self.cfg = cfg
        self.plan = plan
        self.telemetry = telemetry
        self._last: Optional[Dict[str, torch.Tensor]] = None
        self._last_step = -1
        self._host: Optional[Dict[str, np.ndarray]] = None

    def attach(self, telemetry) -> None:
        """Late telemetry binding (the engine builds the plan first)."""
        self.telemetry = telemetry

    # -- the step path's hook (no device work) ---------------------------
    def note_step(self, aux: Dict[str, torch.Tensor], step: int) -> None:
        """Keep this step's device arrays: a reference, no sync; a kept
        array never flushed is simply dropped."""
        self._last = aux
        self._last_step = int(step)
        self._host = None

    # -- the one device-to-host read --------------------------------------
    def _fetch(self) -> Optional[Dict[str, np.ndarray]]:
        """The flush-boundary read of this subsystem (one site, so a test
        counts every read numerics makes)."""
        if self._last is None:
            return None
        if self._host is None:
            self._host = {k: v.detach().cpu().numpy()
                          for k, v in self._last.items()}
        return self._host

    # -- the flush ----------------------------------------------------------
    def flush(self, step: int) -> None:
        tel = self.telemetry
        if tel is None or not getattr(tel, "enabled", False):
            return
        host = self._fetch()
        if host is None:
            return
        groups = np.asarray(host["groups"], np.float64)
        reg = tel.registry
        for gi, name in enumerate(self.plan.group_names):
            g_norm = float(np.sqrt(max(groups[gi, GRAD_SQ], 0.0))
                           if np.isfinite(groups[gi, GRAD_SQ])
                           else groups[gi, GRAD_SQ])
            w_norm = float(np.sqrt(max(groups[gi, WEIGHT_SQ], 0.0)))
            u_norm = float(np.sqrt(max(groups[gi, UPDATE_SQ], 0.0)))
            reg.gauge("numerics/grad_norm").set(g_norm, step=step,
                                                group=name)
            reg.gauge("numerics/weight_norm").set(w_norm, step=step,
                                                  group=name)
            # a ~zero-weight group (a zero-initialised bias) would report
            # a meaningless huge ratio
            reg.gauge("numerics/update_ratio").set(
                u_norm / w_norm if w_norm > 1e-8 else 0.0,
                step=step, group=name)
            reg.gauge("numerics/saturation_count").set(
                float(groups[gi, SATURATED]), step=step, group=name)
            reg.gauge("numerics/underflow_count").set(
                float(groups[gi, UNDERFLOWED]), step=step, group=name)
        total = float(np.sum(groups[:, GRAD_SQ]))
        reg.gauge("numerics/global_grad_norm").set(
            float(np.sqrt(total)) if np.isfinite(total) and total >= 0
            else 0.0, step=step)

    # -- guardrails -----------------------------------------------------------
    def worst_group(self) -> Optional[str]:
        """The layer group a spike should name: the first group with a
        non-finite gradient norm, else the largest grad-to-weight norm
        ratio (scale-aware: a raw argmax would name the biggest layer)."""
        host = self._fetch()
        if host is None:
            return None
        groups = np.asarray(host["groups"], np.float64)
        names = self.plan.group_names
        finite = np.isfinite(groups[:, GRAD_SQ])
        if not finite.all():
            return names[int(np.argmin(finite))]
        denom = np.sqrt(np.maximum(groups[:, WEIGHT_SQ], 1e-24))
        score = np.sqrt(np.maximum(groups[:, GRAD_SQ], 0.0)) / denom
        return names[int(np.argmax(score))]

    def group_table(self) -> List[Dict[str, Any]]:
        """Per-group rows for the spike dump (a non-finite value becomes
        the string "nonfinite")."""
        host = self._fetch()
        if host is None:
            return []
        groups = np.asarray(host["groups"], np.float64)

        def _f(x):
            x = float(x)
            return x if np.isfinite(x) else "nonfinite"

        rows = []
        for gi, name in enumerate(self.plan.group_names):
            g_sq = groups[gi, GRAD_SQ]
            rows.append({
                "group": name,
                "grad_norm": _f(np.sqrt(g_sq) if np.isfinite(g_sq)
                                and g_sq >= 0 else g_sq),
                "weight_norm": _f(np.sqrt(max(groups[gi, WEIGHT_SQ], 0.0))),
                "update_ratio": _f(
                    np.sqrt(max(groups[gi, UPDATE_SQ], 0.0))
                    / np.sqrt(groups[gi, WEIGHT_SQ])
                    if groups[gi, WEIGHT_SQ] > 1e-16 else 0.0),
                "saturated": int(groups[gi, SATURATED])
                if np.isfinite(groups[gi, SATURATED]) else -1,
                "underflowed": int(groups[gi, UNDERFLOWED])
                if np.isfinite(groups[gi, UNDERFLOWED]) else -1,
                "finite": bool(np.isfinite(g_sq)),
            })
        return rows

    @property
    def last_step(self) -> int:
        return self._last_step


def build_numerics(tcfg, param_names: Sequence[str],
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> Optional[NumericsObservatory]:
    """``None`` unless telemetry and its numerics block are on: the
    engine's hooks test ``is None``."""
    if tcfg is None or not tcfg.enabled or not tcfg.numerics.enabled:
        return None
    try:
        plan = NumericsPlan(param_names, max_groups=tcfg.numerics.max_groups,
                            compute_dtype=compute_dtype)
    except Exception as e:  # noqa: BLE001 - observability must never take
        # down the engine it observes
        logger.warning("numerics: plan construction failed: %s", e)
        return None
    return NumericsObservatory(tcfg.numerics, plan)
