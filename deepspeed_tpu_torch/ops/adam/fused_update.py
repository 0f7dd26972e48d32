"""Fused Adam(W) update over the whole parameter list in one kernel.

The port of ``deepspeed_tpu/ops/adam/fused_update.py``. One pass reads each
parameter's fp32 master, gradient and both moments once and writes the new
master and moments, and optionally the new master cast to the compute
dtype (the training engine's next forward reads that copy instead of
casting the masters again). The math is ``FusedAdam.update``'s leaf chain,
op for op.

- On CUDA tensors, :func:`fused_adam_apply` launches ``csrc/fused_adam.cu``
  once for the whole list: a device table of every tensor's pointers and
  size, split into chunks of ``CHUNK`` elements (the per-leaf launch of the
  JAX kernel is a TPU artifact). It launches it or raises.
- On CPU tensors it runs :func:`fused_adam_reference`, the plain PyTorch
  version, which ``chip_smoke.py`` also holds the kernel against, bit for
  bit.

Both update the params and moments in place (the JAX function returns new
arrays; in place saves the second copy of 16 bytes per parameter) and
return them. ``fused_adam_apply.launches`` counts kernel launches.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.adam.fused_adam import (AdamState, FusedAdam,
                                                     adam_leaf)

__all__ = ["fused_adam_apply", "fused_adam_reference", "fused_update_cost"]

CHUNK = 16384                    # elements per thread block
_G_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CAST_DTYPES = {None: 0, torch.bfloat16: 1, torch.float16: 2}
_FN = None
_TABLE = {"key": None, "table": None, "n_chunks": 0}


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("fused_adam")
        fn = lib.fused_adam_multi_tensor
        i32, f32 = ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ctypes.c_void_p, i32, i32, i32, ctypes.c_void_p]
                       + [f32] * 6 + [i32] * 3 + [ctypes.c_void_p])
        fn.restype = i32
        err = lib.fused_adam_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _FN = (fn, err)
    return _FN


def fused_adam_reference(optimizer: FusedAdam, grads, exp_avg, exp_avg_sq,
                         params, scalars: torch.Tensor, cast_dtype=None):
    """Plain version: the leaf chain per tensor with ``scalars`` = [lr,
    bc1, bc2]. Returns new (params, m, v[, casts]) lists."""
    lr, bc1, bc2 = scalars
    outs = [adam_leaf(p, g, m, v, lr, bc1, bc2, b1=optimizer.beta1,
                      b2=optimizer.beta2, eps=optimizer.eps,
                      weight_decay=optimizer.weight_decay,
                      adamw_mode=optimizer.adamw_mode)
            for p, g, m, v in zip(params, grads, exp_avg, exp_avg_sq)]
    res = tuple([o[i] for o in outs] for i in range(3))
    if cast_dtype is not None:
        res += ([o[0].to(cast_dtype) for o in outs],)
    return res


def _table(tensors: Sequence[Sequence[torch.Tensor]], casts, device):
    """The device table for these tensors, rebuilt only when a pointer or
    size changes (the engine keeps the same buffers from step to step)."""
    p = tensors[0]
    ptrs = [t.data_ptr() for ts in tensors for t in ts]
    ptrs += [c.data_ptr() for c in casts] if casts else [0] * len(p)
    sizes = [t.numel() for t in p]
    key = (tuple(ptrs), tuple(sizes), str(device))
    if _TABLE["key"] != key:
        chunk_t, chunk_s = [], []
        for i, n in enumerate(sizes):
            for s in range(0, n, CHUNK):
                chunk_t.append(i)
                chunk_s.append(s)
        host = torch.tensor(ptrs + sizes + chunk_t + chunk_s,
                            dtype=torch.int64).pin_memory()
        _TABLE.update(key=key, table=host.to(device, non_blocking=True),
                      n_chunks=len(chunk_t))
    return _TABLE["table"], _TABLE["n_chunks"]


def _check_cuda(grads, exp_avg, exp_avg_sq, params):
    n = len(params)
    if not (len(grads) == len(exp_avg) == len(exp_avg_sq) == n) or n == 0:
        raise ValueError("fused_adam_apply needs equal, non-empty lists of "
                         "params, grads and moments")
    g_dtype = grads[0].dtype
    if g_dtype not in _G_DTYPES:
        raise TypeError(f"fused_adam kernel takes float32 or bfloat16 "
                        f"grads, got {g_dtype}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, exp_avg,
                                         exp_avg_sq)):
        for name, t, dt in (("param", p, torch.float32),
                            ("grad", g, g_dtype),
                            ("exp_avg", m, torch.float32),
                            ("exp_avg_sq", v, torch.float32)):
            if t.dtype != dt or t.device != p.device \
                    or not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError(
                    f"fused_adam: {name} {i} must be a contiguous {dt} "
                    f"tensor of {p.numel()} elements on {p.device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if p.device != params[0].device:
            raise ValueError("fused_adam: all tensors on one device")


def fused_adam_apply(optimizer: FusedAdam, grads: Sequence[torch.Tensor],
                     state: AdamState, params: Sequence[torch.Tensor],
                     lr=None, cast_dtype: Optional[torch.dtype] = None,
                     cast_out: Optional[Sequence[torch.Tensor]] = None):
    """Drop-in for ``FusedAdam.update``, in place: ``params`` and the
    moment lists of ``state`` are updated where they lie. Returns
    ``(params, new_state)``, plus the params cast to ``cast_dtype`` when it
    is set: written into ``cast_out`` (one contiguous tensor per param, of
    that dtype; the engine keeps them from step to step) or into new
    tensors."""
    if cast_dtype not in _CAST_DTYPES:
        raise TypeError(f"fused_adam: cast_dtype {cast_dtype} is not one of "
                        f"bfloat16, float16 or None")
    step = state.step + 1
    device = params[0].device
    scalars = optimizer.step_scalars(step, lr, device)
    new_state = AdamState(step=step, exp_avg=state.exp_avg,
                          exp_avg_sq=state.exp_avg_sq)
    if cast_dtype is None:
        if cast_out is not None:
            raise ValueError("fused_adam: cast_out needs cast_dtype")
    elif cast_out is None:
        cast_out = [torch.empty(p.shape, dtype=cast_dtype, device=device)
                    for p in params]
    elif len(cast_out) != len(params) or any(
            c.dtype != cast_dtype or c.device != p.device
            or not c.is_contiguous() or c.numel() != p.numel()
            for c, p in zip(cast_out, params)):
        raise ValueError(f"fused_adam: cast_out must hold one contiguous "
                         f"{cast_dtype} tensor per param, of its size")
    if device.type == "cpu":
        res = fused_adam_reference(optimizer, grads, state.exp_avg,
                                   state.exp_avg_sq, params, scalars,
                                   cast_dtype)
        for dst, src in zip((params, state.exp_avg, state.exp_avg_sq)
                            + ((cast_out,) if cast_dtype else ()), res):
            for d, s in zip(dst, src):
                d.copy_(s)
    elif device.type == "cuda":
        _check_cuda(grads, state.exp_avg, state.exp_avg_sq, params)
        table, n_chunks = _table(
            (params, grads, state.exp_avg, state.exp_avg_sq), cast_out,
            device)
        fn, err = _kernel()
        o = optimizer
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(table.data_ptr(), len(params), n_chunks, CHUNK,
                    scalars.data_ptr(), o.beta1, 1.0 - o.beta1, o.beta2,
                    1.0 - o.beta2, o.eps, o.weight_decay, int(o.adamw_mode),
                    _G_DTYPES[grads[0].dtype], _CAST_DTYPES[cast_dtype],
                    stream)
        if rc != 0:
            raise RuntimeError(f"fused_adam kernel launch failed: "
                               f"{err(rc).decode()} (cudaError {rc})")
        fused_adam_apply.launches += 1
    else:
        raise ValueError(f"fused_adam_apply runs on CUDA or CPU tensors, "
                         f"got {device}")
    if cast_dtype is not None:
        return list(params), new_state, list(cast_out)
    return list(params), new_state


fused_adam_apply.launches = 0


def fused_update_cost(params: Sequence[torch.Tensor]
                      ) -> Tuple[float, float]:
    """Analytic ``(flops, bytes)`` of one fused update over ``params``: ~12
    flops (the Adam recurrence) and 28 bytes (read p/g/m/v, write p'/m'/v',
    fp32) per element."""
    n = sum(int(p.numel()) for p in params)
    return 12.0 * n, 28.0 * n
