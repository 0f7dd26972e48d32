"""Numeric helpers of the training step.

The port of ``deepspeed_tpu/runtime/utils.py``'s grad-norm, clipping and
overflow helpers, over lists (or dicts) of tensors. They stay on the
device: each returns a tensor, and nothing here synchronises with the host.
"""

from typing import Iterable, List, Mapping, Optional, Union

import torch

Tensors = Union[Iterable[torch.Tensor], Mapping[str, torch.Tensor]]


def _leaves(tree: Tensors) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def global_norm(tree: Tensors) -> torch.Tensor:
    """L2 norm over all the tensors, in fp32: the square root of the sum of
    the per-tensor sums of squares."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = torch.stack([torch.sum(torch.square(x.float())) for x in leaves])
    return torch.sqrt(torch.sum(sq))


def clip_coef(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))``, the factor clipping applies."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_grad_by_global_norm(tree: Tensors, max_norm: float,
                             norm: Optional[torch.Tensor] = None
                             ) -> List[torch.Tensor]:
    """Scale every tensor so that their global norm is at most
    ``max_norm``; returns new tensors in the input dtypes."""
    leaves = _leaves(tree)
    if norm is None:
        norm = global_norm(leaves)
    scale = clip_coef(max_norm, norm)
    return [(g.float() * scale).to(g.dtype) for g in leaves]


def has_inf_or_nan(tree: Tensors) -> torch.Tensor:
    """Overflow predicate: a bool tensor, True if any floating tensor holds
    an inf or a NaN. Each tensor is checked in its own dtype; integer
    tensors are finite by construction and skipped."""
    leaves = [x for x in _leaves(tree) if x.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    flags = torch.stack([~torch.isfinite(x).all() for x in leaves])
    return flags.any()
