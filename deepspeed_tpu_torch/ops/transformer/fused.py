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

- On CUDA tensors, :func:`ln_matmul` runs Hopper kernels (built at first
  use) through an ``autograd.Function``: :func:`ln_matmul_fwd`, then in
  the backward :func:`ln_matmul_bwd`. :func:`_route` picks the kernels of
  both: bfloat16 and float16 run the wgmma + TMA kernels of
  ``csrc/fused_ln_tc.cu`` at every D the kernels take
  (:func:`ln_matmul_fwd_tc`: one kernel a call up to ``TC_MAX_D``, two
  above; :func:`ln_matmul_bwd_tc`: five kernels a call under GELU up to
  ``TC_MAX_D``, six otherwise); float32 runs the 3xTF32 wgmma + TMA
  kernels of ``csrc/fused_ln_tf32.cu`` (:func:`ln_matmul_fwd_tf32`: two
  kernels a call; :func:`ln_matmul_bwd_tf32`: six). No route runs
  ``csrc/fused_ln.cu`` (``mma.sync`` in 16 bits, FMAs in fp32), the
  first version: ``chip_smoke.py`` holds and times it on the routes'
  inputs. It launches them or raises; it never falls back to the plain
  versions or from one kernel to another.
- On CPU tensors the same Function runs :func:`ln_matmul_reference` and
  :func:`ln_matmul_bwd_reference`, the plain PyTorch versions that the CPU
  tests hold against the JAX kernels and ``chip_smoke.py`` holds the CUDA
  kernels against. The plain backward follows the TPU kernel's formulas
  and rounding points: ``dy`` rounded to ``w``'s dtype before both
  products, ``dbias`` summed from the fp32 ``dy``.

Each route counts its calls in its own wrappers' ``.launches``, one per
call whatever the kernels a call runs: ``csrc/fused_ln.cu``'s in
``ln_matmul_fwd`` and ``ln_matmul_bwd``, ``csrc/fused_ln_tc.cu``'s in
``ln_matmul_fwd_tc`` and ``ln_matmul_bwd_tc``, ``csrc/fused_ln_tf32.cu``'s
in ``ln_matmul_fwd_tf32`` and ``ln_matmul_bwd_tf32``. A training step of
``make_gpt("gpt2", fused_ln=True)`` counts 2 sites x 12 layers x GAS in
each ``_tc`` wrapper in bf16 or fp16, in each ``_tf32`` wrapper in fp32,
and 0 in the others.
The JAX package's ``LNParams`` / ``DenseParams`` (flax shadow modules that
keep the parameter tree of the unfused model) have no counterpart: the
port's GPT passes its ``nn.LayerNorm`` and ``nn.Linear`` tensors.
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.config.config import not_yet_ported
from deepspeed_tpu_torch.ops import build

__all__ = ["ln_matmul", "ln_matmul_ok", "ln_matmul_reference",
           "ln_matmul_bwd_reference", "ln_matmul_fwd", "ln_matmul_bwd",
           "ln_matmul_fwd_tc", "ln_matmul_bwd_tc", "ln_matmul_fwd_tf32",
           "ln_matmul_bwd_tf32"]

_SQRT_2_OVER_PI = 0.7978845608028654
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PARAM_CODES = _DTYPE_CODES
MAX_COL_TILES = 65535            # the grid's second dimension, 128 a tile
# The widest resident panel of the wgmma forward: a block keeps 64
# normalised rows in shared memory (128 D bytes) beside at least two 8 KB
# stages of W and 136 bytes of barriers, within the 232,448 bytes a block
# may use on an H100: 128 D + 16,520 <= 232,448 holds up to D = 1664 (a
# multiple of 64), so every GPT-2 width (768, 1024, 1280, 1600) takes the
# panel. Above it csrc/fused_ln_tc.cu (which holds the same constant,
# TC_MAX_D; tests/test_torch_fused_ln_tc.py holds the two equal) writes
# T(ln) once and streams it through the product instead, and the
# forward's scratch holds T(ln) and the rows' statistics.
TC_MAX_D = 1664
_FN = {}


def _route(dtype: torch.dtype, d: int) -> str:
    """The library that computes #6 and #7 on CUDA: ``"fused_ln_tc"``
    (wgmma + TMA, ``csrc/fused_ln_tc.cu``) for bfloat16 and float16 with D
    a multiple of 8; ``"fused_ln_tf32"`` (3xTF32 on wgmma + TMA,
    ``csrc/fused_ln_tf32.cu``) for float32 with D a multiple of 8;
    ``"fused_ln"`` (``csrc/fused_ln.cu``) only for what
    :func:`ln_matmul_ok` refuses anyway."""
    if d % 8 or d < 8:
        return "fused_ln"
    if dtype == torch.float32:
        return "fused_ln_tf32"
    return ("fused_ln_tc" if dtype in (torch.bfloat16, torch.float16)
            else "fused_ln")


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


def _kernel(name: str = "fused_ln"):
    """The ctypes functions of ``csrc/<name>.cu`` (``fused_ln``,
    ``fused_ln_tc`` or ``fused_ln_tf32``, one C interface): forward,
    backward, the backward's workspace size and the error string, built
    and loaded at first use."""
    if name not in _FN:
        lib = build.load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = getattr(lib, f"{name}_fwd")
        fwd.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, i32,
                        i32, i32, f32, i32, i32, ptr]
        bwd = getattr(lib, f"{name}_bwd")
        bwd.argtypes = ([ptr, ptr, ptr, i32, ptr, ptr, i32] + [ptr] * 7
                        + [i32, i32, i32, f32, i32, i32, ptr])
        for fn in (fwd, bwd):
            fn.restype = i32
        work = getattr(lib, f"{name}_bwd_workspace")
        work.argtypes = [i32] * 5
        work.restype = ctypes.c_longlong
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _FN[name] = (fwd, bwd, work, err)
    return _FN[name]


def _check(rc, what, name="fused_ln"):
    if rc != 0:
        err = _kernel(name)[3]
        raise RuntimeError(f"{name} {what} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (copied when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(x, gamma, beta, w, bias):
    """Checks the kernels rely on; returns the inputs as they read them:
    x, w, gamma, beta and bias contiguous and 16-byte aligned (the kernels
    read them in vectors of 8), beta in gamma's dtype. A dtype the kernels
    do not take raises the port's "not yet ported" error."""
    n, d = x.shape
    f = w.shape[0]
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise not_yet_ported(
            f"fused_ln kernels for x {x.dtype} and w {w.dtype} (they take "
            f"float32, bfloat16 or float16 x and w of one dtype)")
    if gamma.dtype not in _PARAM_CODES or bias.dtype not in _PARAM_CODES:
        raise not_yet_ported(
            f"fused_ln kernels for gamma {gamma.dtype} and bias "
            f"{bias.dtype} (they take float32, bfloat16 or float16)")
    if not ln_matmul_ok(n, d, f):
        raise ValueError(f"fused_ln kernels take D and F multiples of 8; got "
                         f"n={n}, D={d}, F={f}")
    for t in (gamma, beta, w, bias):
        if t.device != x.device:
            raise ValueError(f"fused_ln operands on {t.device} and "
                             f"{x.device}")
    return (_dense(x), _dense(gamma), _dense(beta.to(gamma.dtype)),
            _dense(w), _dense(bias))


def _launch_fwd(name, x, gamma, beta, w, bias, eps, activation):
    """One call of ``csrc/<name>.cu``'s forward on inputs as
    :func:`_prepare` returns them; y [n, F] in x's dtype."""
    n, d = x.shape
    f = w.shape[0]
    y = torch.empty((n, f), dtype=x.dtype, device=x.device)
    # the forward's scratch, in fp32 words: fused_ln.cu's row statistics;
    # the 3xTF32 forward's W hi and lo ([F, D] each), gamma, beta and bias
    # in fp32, then its row statistics; the 16-bit wgmma forward's none up
    # to TC_MAX_D, above it T(ln) [n, D] in x's dtype, then the statistics
    size = {"fused_ln": 2 * n,
            "fused_ln_tf32": 2 * f * d + 2 * d + f + 2 * n,
            "fused_ln_tc": n * d // 2 + 2 * n if d > TC_MAX_D else None
            }.get(name)
    stats = (None if size is None else
             torch.empty(size, dtype=torch.float32, device=x.device))
    fwd = _kernel(name)[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 _PARAM_CODES[gamma.dtype], w.data_ptr(), bias.data_ptr(),
                 _PARAM_CODES[bias.dtype], y.data_ptr(),
                 None if stats is None else stats.data_ptr(), n, d, f,
                 float(eps), int(activation == "gelu"),
                 _DTYPE_CODES[x.dtype], stream)
    _check(rc, "forward", name)
    return y


def _launch_bwd(name, x, gamma, beta, w, bias, dy, eps, activation):
    """One call of ``csrc/<name>.cu``'s backward; ``(dx, dgamma, dbeta,
    dw, dbias)`` in the dtypes of :func:`ln_matmul_bwd_reference`."""
    n, d = x.shape
    f = w.shape[0]
    if dy.dtype != x.dtype or tuple(dy.shape) != (n, f):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}, expected "
                         f"{(n, f)} {x.dtype}")
    dy = _dense(dy)
    gelu = int(activation == "gelu")
    _fwd, bwd, work, _err = _kernel(name)
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
    _check(rc, "backward", name)
    return dx, dgamma, dbeta, dw, dbias


def _require_tc(x):
    if _route(x.dtype, x.shape[-1]) != "fused_ln_tc":
        raise ValueError(
            f"the wgmma fused_ln kernels take bfloat16 or float16 with D a "
            f"multiple of 8; got {x.dtype}, D {x.shape[-1]}")


def _require_tf32(x):
    if _route(x.dtype, x.shape[-1]) != "fused_ln_tf32":
        raise ValueError(
            f"the 3xTF32 fused_ln kernels take float32 with D a multiple of "
            f"8; got {x.dtype}, D {x.shape[-1]}")


def ln_matmul_fwd(x, gamma, beta, w, bias, *, eps: float = 1e-5,
                  activation: Optional[str] = None) -> torch.Tensor:
    """Launch the forward :func:`_route` picks on x [n, D] (inputs as
    :func:`_prepare` returns them); returns y [n, F] in x's dtype.
    ``csrc/fused_ln.cu``'s forward (two kernels: the rows' statistics,
    then the product) counts one launch here per call, for what no model
    reaches; the wgmma forward counts in :func:`ln_matmul_fwd_tc`, the
    3xTF32 one in :func:`ln_matmul_fwd_tf32`."""
    route = _route(x.dtype, x.shape[-1])
    if route == "fused_ln_tc":
        return ln_matmul_fwd_tc(x, gamma, beta, w, bias, eps=eps,
                                activation=activation)
    if route == "fused_ln_tf32":
        return ln_matmul_fwd_tf32(x, gamma, beta, w, bias, eps=eps,
                                  activation=activation)
    y = _launch_fwd("fused_ln", x, gamma, beta, w, bias, eps, activation)
    ln_matmul_fwd.launches += 1
    return y


def ln_matmul_fwd_tc(x, gamma, beta, w, bias, *, eps: float = 1e-5,
                     activation: Optional[str] = None) -> torch.Tensor:
    """The wgmma + TMA forward of ``csrc/fused_ln_tc.cu`` (bfloat16 or
    float16; anything else raises): up to ``TC_MAX_D`` one kernel that
    normalises a panel of rows once and walks W's column tiles against
    it; above, a rows kernel that writes T(ln) once and a product that
    streams it and W through a TMA ring. One call is one launch."""
    _require_tc(x)
    y = _launch_fwd("fused_ln_tc", x, gamma, beta, w, bias, eps, activation)
    ln_matmul_fwd_tc.launches += 1
    return y


def ln_matmul_fwd_tf32(x, gamma, beta, w, bias, *, eps: float = 1e-5,
                       activation: Optional[str] = None) -> torch.Tensor:
    """The 3xTF32 forward of ``csrc/fused_ln_tf32.cu`` (float32 with D a
    multiple of 8; anything else raises): a prologue that splits W into
    TF32 hi and lo and takes the rows' statistics, then the wgmma product
    that normalises x on its way into the A fragments. One call is one
    launch."""
    _require_tf32(x)
    y = _launch_fwd("fused_ln_tf32", x, gamma, beta, w, bias, eps,
                    activation)
    ln_matmul_fwd_tf32.launches += 1
    return y


def ln_matmul_bwd(x, gamma, beta, w, bias, dy, *, eps: float = 1e-5,
                  activation: Optional[str] = None):
    """Launch the backward :func:`_route` picks on x [n, D] and dy [n, F]
    (dy in x's dtype); returns ``(dx, dgamma, dbeta, dw, dbias)`` in the
    dtypes of :func:`ln_matmul_bwd_reference`. Its kernels run on the
    current stream, with scratch from PyTorch's caching allocator:
    ``csrc/fused_ln.cu``'s six count one launch here per call, the wgmma
    route's in :func:`ln_matmul_bwd_tc`, the 3xTF32 route's in
    :func:`ln_matmul_bwd_tf32`."""
    route = _route(x.dtype, x.shape[-1])
    if route == "fused_ln_tc":
        return ln_matmul_bwd_tc(x, gamma, beta, w, bias, dy, eps=eps,
                                activation=activation)
    if route == "fused_ln_tf32":
        return ln_matmul_bwd_tf32(x, gamma, beta, w, bias, dy, eps=eps,
                                  activation=activation)
    grads = _launch_bwd("fused_ln", x, gamma, beta, w, bias, dy, eps,
                        activation)
    ln_matmul_bwd.launches += 1
    return grads


def ln_matmul_bwd_tc(x, gamma, beta, w, bias, dy, *, eps: float = 1e-5,
                     activation: Optional[str] = None):
    """The backward of ``csrc/fused_ln_tc.cu`` (bfloat16 or float16;
    anything else raises): T(ln) once into the workspace (up to
    ``TC_MAX_D`` under GELU by the recompute's panel kernel; else by a
    rows kernel, then under GELU the streamed product recomputes), dln =
    dyc W and dW = dyc^T T(ln) on wgmma, the row pass and the fixed-order
    sums; five kernels under GELU up to ``TC_MAX_D``, six otherwise, one
    launch counted per call."""
    _require_tc(x)
    grads = _launch_bwd("fused_ln_tc", x, gamma, beta, w, bias, dy, eps,
                        activation)
    ln_matmul_bwd_tc.launches += 1
    return grads


def ln_matmul_bwd_tf32(x, gamma, beta, w, bias, dy, *, eps: float = 1e-5,
                       activation: Optional[str] = None):
    """The 3xTF32 backward of ``csrc/fused_ln_tf32.cu`` (float32 with D a
    multiple of 8; anything else raises): a prologue (W^T's and ln^T's
    TF32 hi and lo, K-major for wgmma, and the rows' statistics), under
    GELU the recompute that writes g = dy gelu'(pre), dln = g W and dW =
    g^T ln on wgmma, the row pass and the fixed-order sums; six kernels,
    one launch counted per call."""
    _require_tf32(x)
    grads = _launch_bwd("fused_ln_tf32", x, gamma, beta, w, bias, dy, eps,
                        activation)
    ln_matmul_bwd_tf32.launches += 1
    return grads


ln_matmul_fwd.launches = 0
ln_matmul_fwd_tc.launches = 0
ln_matmul_fwd_tf32.launches = 0
ln_matmul_bwd.launches = 0
ln_matmul_bwd_tc.launches = 0
ln_matmul_bwd_tf32.launches = 0


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
