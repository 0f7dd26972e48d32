"""Fused LayerNorm + projection: ``act(LayerNorm(x) @ W^T + b)``.

The port of ``deepspeed_tpu/ops/transformer/fused.py``. ``x`` is [..., D],
``gamma`` and ``beta`` [D], ``w`` [F, D] in torch's ``nn.Linear`` layout,
``bias`` [F]; ``activation`` is None or "gelu" (the tanh form). The dtype
discipline is the JAX function's: the LayerNorm in fp32 with a two-pass
variance, the normalized rows rounded to ``w``'s dtype, an fp32-summed
product, the bias added in fp32, the GELU in fp32, the output in ``x``'s
dtype. The backward recomputes the LayerNorm (and under GELU the
pre-activation) from what the forward saved, ``(x, gamma, beta, w,
bias)``, as the JAX VJP does.

- On CUDA tensors, :func:`ln_matmul` runs the Hopper kernels of
  ``csrc/fused_ln.cu`` (built at first use) through an
  ``autograd.Function``: :func:`ln_matmul_fwd`, then in the backward
  :func:`ln_matmul_bwd`. It launches them or raises; it never falls back
  to the plain versions.
- On CPU tensors the same Function runs :func:`ln_matmul_reference` and
  :func:`ln_matmul_bwd_reference`, the plain PyTorch versions that the CPU
  tests hold against the JAX kernels and ``chip_smoke.py`` holds the CUDA
  kernels against. The plain backward follows the TPU kernel's formulas
  and rounding points: ``dy`` rounded to ``w``'s dtype before both
  products, ``dbias`` summed from the fp32 ``dy``.

Each kernel wrapper counts its launches in ``.launches``. The JAX
package's ``LNParams`` / ``DenseParams`` (flax shadow modules that keep
the parameter tree of the unfused model) have no counterpart: the port's
GPT passes its ``nn.LayerNorm`` and ``nn.Linear`` tensors.
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import build

__all__ = ["ln_matmul", "ln_matmul_ok", "ln_matmul_reference",
           "ln_matmul_bwd_reference", "ln_matmul_fwd", "ln_matmul_bwd"]

_SQRT_2_OVER_PI = 0.7978845608028654
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PARAM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_COL_TILES = 65535            # the grid's second dimension, 128 a tile
_FN = None


def _gelu_tanh(x):
    """tanh-approximate GELU, fp32 (``F.gelu(approximate="tanh")``'s
    formula, written out as the JAX function writes it)."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                       * (x + 0.044715 * x * x * x)))


def _gelu_tanh_grad(x):
    """d/dx of the tanh-approximate GELU."""
    u = _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _layernorm_rows(xf, gamma, beta, eps):
    """fp32 LayerNorm over the last dim with a two-pass variance; returns
    (ln, xhat, rstd)."""
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    return xhat * gamma + beta, xhat, rstd


def ln_matmul_ok(n: int, d: int, f: int) -> bool:
    """Shape gate of the CUDA kernels: ``d`` and ``f`` multiples of 8 (16-
    byte vector loads of 8 elements), any number of rows ``n >= 1`` (a
    ragged last row tile is masked)."""
    return (n >= 1 and d >= 8 and d % 8 == 0 and f >= 8 and f % 8 == 0
            and -(-max(d, f) // 128) <= MAX_COL_TILES)


def ln_matmul_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = 1e-5,
                        activation: Optional[str] = None) -> torch.Tensor:
    """Plain version of the forward kernel, with its dtype discipline.
    ``w`` [F, D]; the product of ``w``-dtype values sums in fp32 (products
    of bf16 values are exact in fp32)."""
    ln, _, _ = _layernorm_rows(x.float(), gamma.float(), beta.float(), eps)
    y = ln.to(w.dtype).float() @ w.float().t() + bias.float()
    if activation == "gelu":
        y = _gelu_tanh(y)
    return y.to(x.dtype)


def ln_matmul_bwd_reference(x, gamma, beta, w, bias, dy, *,
                            eps: float = 1e-5,
                            activation: Optional[str] = None):
    """Plain version of the backward kernel on the same inputs (``x``
    [n, D], ``dy`` [n, F]), following the TPU kernel's formulas. Returns
    ``(dx, dgamma, dbeta, dw, dbias)``: dx in x's dtype, dgamma and dbeta
    in gamma's and beta's, dw [F, D] and dbias in w's and bias's."""
    ln, xhat, rstd = _layernorm_rows(x.float(), gamma.float(),
                                     beta.float(), eps)
    ln_c = ln.to(w.dtype).float()
    wf = w.float()
    g = dy.float()
    if activation == "gelu":
        g = g * _gelu_tanh_grad(ln_c @ wf.t() + bias.float())
    dy_c = g.to(w.dtype).float()
    dw = dy_c.t() @ ln_c
    dln = dy_c @ wf
    dxhat = dln * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (dln * xhat).sum(0).to(gamma.dtype),
            dln.sum(0).to(beta.dtype), dw.to(w.dtype),
            g.sum(0).to(bias.dtype))


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("fused_ln")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = lib.fused_ln_fwd
        fwd.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, i32,
                        i32, i32, f32, i32, i32, ptr]
        bwd = lib.fused_ln_bwd
        bwd.argtypes = ([ptr, ptr, ptr, i32, ptr, ptr, i32] + [ptr] * 7
                        + [i32, i32, i32, f32, i32, i32, ptr])
        for fn in (fwd, bwd):
            fn.restype = i32
        work = lib.fused_ln_bwd_workspace
        work.argtypes = [i32] * 5
        work.restype = ctypes.c_longlong
        err = lib.fused_ln_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _FN = (fwd, bwd, work, err)
    return _FN


def _check(rc, what):
    if rc != 0:
        err = _kernel()[3]
        raise RuntimeError(f"fused_ln {what} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (copied when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(x, gamma, beta, w, bias):
    """Checks the kernels rely on; returns the inputs as they read them:
    x, w, gamma and beta contiguous and 16-byte aligned (the kernels read
    them in vectors of 8), bias contiguous, beta in gamma's dtype."""
    n, d = x.shape
    f = w.shape[0]
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"fused_ln kernels take float32 or bfloat16 x and w "
                        f"of one dtype; got x {x.dtype}, w {w.dtype}")
    if gamma.dtype not in _PARAM_CODES or bias.dtype not in _PARAM_CODES:
        raise TypeError(f"fused_ln kernels take float32, bfloat16 or "
                        f"float16 gamma, beta and bias; got {gamma.dtype}, "
                        f"{bias.dtype}")
    if not ln_matmul_ok(n, d, f):
        raise ValueError(f"fused_ln kernels take D and F multiples of 8; got "
                         f"n={n}, D={d}, F={f}")
    for t in (gamma, beta, w, bias):
        if t.device != x.device:
            raise ValueError(f"fused_ln operands on {t.device} and "
                             f"{x.device}")
    return (_dense(x), _dense(gamma), _dense(beta.to(gamma.dtype)),
            _dense(w), bias.contiguous())


def ln_matmul_fwd(x, gamma, beta, w, bias, *, eps: float = 1e-5,
                  activation: Optional[str] = None) -> torch.Tensor:
    """Launch the forward kernel on x [n, D] (inputs as :func:`_prepare`
    returns them); returns y [n, F] in x's dtype. One call is one launch
    of the forward, whose two kernels (the rows' statistics, then the
    product) run on the current stream."""
    n, d = x.shape
    f = w.shape[0]
    y = torch.empty((n, f), dtype=x.dtype, device=x.device)
    stats = torch.empty(2 * n, dtype=torch.float32, device=x.device)
    fwd = _kernel()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 _PARAM_CODES[gamma.dtype], w.data_ptr(), bias.data_ptr(),
                 _PARAM_CODES[bias.dtype], y.data_ptr(), stats.data_ptr(), n,
                 d, f, float(eps), int(activation == "gelu"),
                 _DTYPE_CODES[x.dtype], stream)
    _check(rc, "forward")
    ln_matmul_fwd.launches += 1
    return y


def ln_matmul_bwd(x, gamma, beta, w, bias, dy, *, eps: float = 1e-5,
                  activation: Optional[str] = None):
    """Launch the backward kernels on x [n, D] and dy [n, F] (dy in x's
    dtype); returns ``(dx, dgamma, dbeta, dw, dbias)`` in the dtypes of
    :func:`ln_matmul_bwd_reference`. One call is one launch of the
    backward, whose six kernels run on the current stream; their scratch
    comes from PyTorch's caching allocator."""
    n, d = x.shape
    f = w.shape[0]
    if dy.dtype != x.dtype or tuple(dy.shape) != (n, f):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}, expected "
                         f"{(n, f)} {x.dtype}")
    dy = _dense(dy)
    gelu = int(activation == "gelu")
    _fwd, bwd, work, _err = _kernel()
    code = _DTYPE_CODES[x.dtype]
    ws = torch.empty(work(n, d, f, gelu, code), dtype=torch.uint8,
                     device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dbias = torch.empty_like(bias)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = bwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 _PARAM_CODES[gamma.dtype], w.data_ptr(), bias.data_ptr(),
                 _PARAM_CODES[bias.dtype], dy.data_ptr(), dx.data_ptr(),
                 dw.data_ptr(), dbias.data_ptr(), dgamma.data_ptr(),
                 dbeta.data_ptr(), ws.data_ptr(), n, d, f, float(eps), gelu,
                 code, stream)
    _check(rc, "backward")
    ln_matmul_bwd.launches += 1
    return dx, dgamma, dbeta, dw, dbias


ln_matmul_fwd.launches = 0
ln_matmul_bwd.launches = 0


class _LNMatmul(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors;
    saves ``(x, gamma, beta, w, bias)`` and recomputes the rest."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, activation):
        if x.is_cuda:
            x, gamma, beta, w, bias = _prepare(x, gamma, beta, w, bias)
            y = ln_matmul_fwd(x, gamma, beta, w, bias, eps=eps,
                              activation=activation)
        else:
            y = ln_matmul_reference(x, gamma, beta, w, bias, eps=eps,
                                    activation=activation)
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.eps, ctx.activation = eps, activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, bias = ctx.saved_tensors
        fn = ln_matmul_bwd if x.is_cuda else ln_matmul_bwd_reference
        grads = fn(x, gamma, beta, w, bias, dy, eps=ctx.eps,
                   activation=ctx.activation)
        return (*grads, None, None)


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5,
              activation: Optional[str] = None) -> torch.Tensor:
    """``act(LayerNorm(x; gamma, beta) @ w.T + bias)`` without the
    normalized rows in device memory. ``x`` [..., D] (leading dims
    flattened), ``w`` [F, D] (``nn.Linear.weight``), ``bias`` [F];
    differentiable in all five. Gate shapes with :func:`ln_matmul_ok`."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    d = x.shape[-1]
    f = w.shape[0]
    lead = x.shape[:-1]
    n = 1
    for s in lead:
        n *= s
    if tuple(w.shape) != (f, d) or tuple(gamma.shape) != (d,) or \
            tuple(beta.shape) != (d,) or tuple(bias.shape) != (f,):
        raise ValueError(f"ln_matmul shapes: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, "
                         f"w {tuple(w.shape)} (expected [F, {d}]), bias "
                         f"{tuple(bias.shape)}")
    if not ln_matmul_ok(n, d, f):
        raise ValueError(f"shapes (n={n}, d={d}, f={f}) not taken by the "
                         f"fused kernels: gate with ln_matmul_ok()")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ln_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    out = _LNMatmul.apply(x.reshape(n, d), gamma, beta, w, bias,
                          float(eps), activation)
    return out.reshape(*lead, f)
