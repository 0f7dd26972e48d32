"""Flash attention: the training attention, forward and backward.

The port of ``deepspeed_tpu/ops/transformer/flash_attention.py``. ``q``,
``k``, ``v`` are [B, S, H, D]; causality is aligned bottom-right (key ``j``
is visible to query ``i`` iff ``j <= i + Sk - Sq``); an optional key mask
``kv_mask`` [B, Sk] (1 = attend) multiplies the probabilities, so a row
whose keys are all masked gives zeros, not NaN. The forward saves ``out``
and the fp32 row logsumexp; the backward recomputes the probabilities.

- On CUDA tensors, :func:`flash_attention` runs Hopper kernels (built at
  first use) through an ``autograd.Function``: :func:`flash_attention_fwd`,
  then in the backward :func:`flash_attention_bwd_dq` and
  :func:`flash_attention_bwd_dkv`. :func:`_route` picks each one's kernel:
  bfloat16 and float16 with ``head_dim`` up to 128 run the tensor-core
  kernels of ``csrc/flash_attention_tc.cu`` (:func:`flash_attention_fwd_tc`,
  :func:`flash_attention_bwd_dq_tc`, :func:`flash_attention_bwd_dkv_tc`);
  float32 with ``head_dim`` up to 256 the 3xTF32 tensor-core kernels of
  ``csrc/flash_attention_tf32.cu`` (:func:`flash_attention_fwd_tf32`,
  :func:`flash_attention_bwd_dq_tf32`,
  :func:`flash_attention_bwd_dkv_tf32`); bfloat16 and float16 with
  ``head_dim`` in (128, 256] the forward, dq and dk/dv of
  ``csrc/flash_attention_tc256.cu`` (wgmma: :func:`flash_attention_fwd_tc256`,
  :func:`flash_attention_bwd_dq_tc256`,
  :func:`flash_attention_bwd_dkv_tc256`). No head dim that
  :func:`flash_ok` admits routes to the FMA kernels of
  ``csrc/flash_attention.cu``; they stay as the other kernels' first
  versions, which ``chip_smoke.py`` times on the same inputs. It
  launches them or raises; it never falls back to the plain version or
  from one kernel to another.
- On CPU tensors it runs :func:`flash_attention_reference`, the plain
  PyTorch version (materialised fp32 scores, differentiated by autograd)
  that the CPU tests hold against the JAX kernel and ``chip_smoke.py``
  holds the CUDA kernels against.

Attention dropout (``dropout_rate`` > 0 with an int ``dropout_seed``) is
the JAX function's: the keep-mask of score (row i, col j) of batch-head
``bh = b * H + h`` is :func:`dropout_keep_mask`, a counter hash of (seed,
bh, i, j) that the forward and both backward kernels regenerate, so no
[S, S] mask is ever stored. The forward's normaliser keeps the full
probability mass; only the accumulated probabilities are masked and
scaled by ``1 / (1 - rate)``; the backward masks and scales ``dp`` (and,
for dv, ``p``). The seed is the host int the JAX function derives from its
key (``kd[0] ^ (kd[-1] << 1)``); the kernels take it, and the integer
threshold and the fp32 ``1 / (1 - rate)`` the host computes, as
arguments. At rate 0 they run a variant compiled without the hash.

Each kernel counts its launches in its own wrapper's ``.launches``: the
FMA kernels in ``flash_attention_fwd``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``, the tensor-core ones in
``flash_attention_fwd_tc``, ``flash_attention_bwd_dq_tc`` and
``flash_attention_bwd_dkv_tc``, the 3xTF32 ones in
``flash_attention_fwd_tf32``, ``flash_attention_bwd_dq_tf32`` and
``flash_attention_bwd_dkv_tf32``, the wgmma ones at head dims above 128
in ``flash_attention_fwd_tc256``, ``flash_attention_bwd_dq_tc256`` and
``flash_attention_bwd_dkv_tc256``. The FMA wrappers also count, in
``.launches_wide``, their launches at head dims above 128 (the kernels'
widest branch, which no route takes).
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.dropout import MASK32, keep_threshold, mul32

__all__ = ["flash_attention", "flash_attention_reference", "flash_ok",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_tc",
           "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc",
           "flash_attention_fwd_tf32", "flash_attention_bwd_dq_tf32",
           "flash_attention_bwd_dkv_tf32", "flash_attention_fwd_tc256",
           "flash_attention_bwd_dq_tc256", "flash_attention_bwd_dkv_tc256",
           "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "dropout_keep_mask"]

MAX_HEAD_DIM = 256
TC_MAX_HEAD_DIM = 128            # the tensor-core kernels' widest head
MAX_BATCH_HEADS = 65535          # the FMA kernels' grid second dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FN = {}


def _route(dtype: torch.dtype, head_dim: int, which: str = "fwd") -> str:
    """Which kernel computes ``which`` (``"fwd"``, ``"dq"`` or ``"dkv"``) on
    CUDA: ``"tc"`` (the tensor cores, ``csrc/flash_attention_tc.cu``) for
    bfloat16 and float16 with ``head_dim`` a multiple of 8 in [8, 128] (a
    head dim that is not a multiple of 16 is zero-padded in shared
    memory); ``"tc256"`` (wgmma, ``csrc/flash_attention_tc256.cu``) for
    them with ``head_dim`` a multiple of 8 in (128, 256]; ``"tf32"``
    (3xTF32 on the tensor cores, ``csrc/flash_attention_tf32.cu``) for
    float32 with ``head_dim`` a multiple of 8 in [8, 256]; ``"fma"``
    (``csrc/flash_attention.cu``) for nothing that :func:`flash_ok`
    admits. The forward, dq and dk/dv of one dtype and head dim take the
    same route."""
    if which not in ("fwd", "dq", "dkv"):
        raise ValueError(f"which must be fwd, dq or dkv, got {which!r}")
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        return "fma"
    if dtype in (torch.bfloat16, torch.float16):
        return "tc" if head_dim <= TC_MAX_HEAD_DIM else "tc256"
    return "tf32" if dtype == torch.float32 else "fma"


def flash_ok(q: torch.Tensor, k: torch.Tensor, causal: bool) -> bool:
    """Whether the CUDA kernels take these inputs: float32, bfloat16 or
    float16; ``head_dim`` a multiple of 8 and at most 256; any sequence
    lengths, except more queries than keys under ``causal`` (rows with no
    visible key)."""
    b, sq, h, d = q.shape
    return (q.dtype in _DTYPE_CODES and d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM
            and b * h <= MAX_BATCH_HEADS and sq >= 1 and k.shape[1] >= 1
            and not (causal and sq > k.shape[1]))


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' murmur3-style finalizer (JAX ``flash_attention.
    _hash_u32``), over int64 holding uint32 values; not the splitmix32
    hash of ``ops/dropout.py``."""
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 16)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 13)
    x = mul32(x, 0x27D4EB2F)
    return x ^ (x >> 16)


def _dropout_bits(seed: int, bh, rows, cols) -> torch.Tensor:
    """uint32 hash bits (in int64) of absolute score coordinates: ``bh``,
    ``rows`` and ``cols`` int64 tensors (or ints) that broadcast."""
    x = (mul32(torch.as_tensor(rows, dtype=torch.int64), 0x9E3779B9)
         + mul32(torch.as_tensor(cols, dtype=torch.int64), 0x7FEB352D)
         ) & MASK32
    x = x ^ ((int(seed) + 0x165667B1) & MASK32)
    x = x ^ ((mul32(torch.as_tensor(bh, dtype=torch.int64), 0x58F633B5)
              + 1) & MASK32)
    return _hash_u32(x)


def dropout_keep_mask(seed: int, bh, rows, cols,
                      rate: float) -> torch.Tensor:
    """Boolean keep-mask of attention dropout: the top 24 hash bits of
    (seed, batch-head, absolute row, absolute col) against
    ``int(rate * 2**24)``, bit for bit the JAX function's and the
    kernels'. The port's plain attention (``attention.xla_attention``)
    drops out with this mask too."""
    return (_dropout_bits(seed, bh, rows, cols) >> 8) >= keep_threshold(
        rate)


def _keep_bhqk(seed: int, b: int, h: int, sq: int, sk: int, rate: float,
               device) -> torch.Tensor:
    """The keep-mask of every score, [B, H, Sq, Sk], ``bh = b * H + h``."""
    def i64(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    bh = (i64(b)[:, None] * h + i64(h)[None, :])[:, :, None, None]
    return dropout_keep_mask(seed, bh, i64(sq)[:, None], i64(sk)[None, :],
                             rate)


def _dropped(t: torch.Tensor, keep: Optional[torch.Tensor],
             rate: float) -> torch.Tensor:
    """``t`` (fp32) masked by ``keep`` and scaled by the fp32 ``1 / (1 -
    rate)``, as the kernels apply it; ``t`` itself when ``keep`` is
    None."""
    if keep is None:
        return t
    return torch.where(keep, t * (1.0 / (1.0 - rate)), 0.0)


def _check_dropout(rate: float, seed) -> None:
    if rate < 0.0 or rate >= 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")


def _scale_of(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return (softmax_scale if softmax_scale is not None
            else 1.0 / (q.shape[-1] ** 0.5))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              kv_mask: Optional[torch.Tensor] = None,
                              softmax_scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None
                              ) -> torch.Tensor:
    """Plain version: the same function as the kernels over materialised
    fp32 scores [B, H, Sq, Sk], differentiated by autograd. The row max is
    taken over the causally visible keys, masked ones included, and the
    mask multiplies ``exp(s - max)``, as in the kernels; dropout masks the
    normalised probabilities after the normaliser."""
    _check_dropout(dropout_rate, dropout_seed)
    scale = _scale_of(q, softmax_scale)
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    if kv_mask is not None:
        p = p * kv_mask.float()[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    # l = 0 only where every key is masked: there p = 0 and o = 0, and a
    # divisor of 1 keeps that row's gradient exactly 0
    l = torch.where(l == 0, torch.ones_like(l), l.clamp_min(1e-30))
    keep = (_keep_bhqk(dropout_seed, q.shape[0], q.shape[2], sq, sk,
                       dropout_rate, q.device)
            if dropout_rate > 0.0 else None)
    o = torch.einsum("bhqk,bkhd->bqhd", _dropped(p / l, keep, dropout_rate),
                     v.float())
    return o.to(q.dtype)


def _bwd_probs(q, k, v, dout, kv_mask, lse, delta, causal, scale,
               dropout_rate, dropout_seed):
    """Shared part of the backward kernels' plain versions: scale * q,
    p = exp(s - lse) * mask, dropped out (for dv), and ds = p (D(dO.v) -
    delta) with D the dropout's mask and scale, fp32, [B, H, Sq, Sk]."""
    _check_dropout(dropout_rate, dropout_seed)
    sq, sk = q.shape[1], k.shape[1]
    qs = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        p = p.masked_fill(~keep, 0.0)
    if kv_mask is not None:
        p = p * kv_mask.float()[:, None, None, :]
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    keep = (_keep_bhqk(dropout_seed, q.shape[0], q.shape[2], sq, sk,
                       dropout_rate, q.device)
            if dropout_rate > 0.0 else None)
    dp = _dropped(dp, keep, dropout_rate)
    return qs, _dropped(p, keep, dropout_rate), p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, dout, kv_mask, lse, delta, causal: bool,
                           scale: float, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain version of the dq kernel on the same inputs (``lse`` and
    ``delta`` fp32 [B, H, Sq])."""
    _qs, _p, ds = _bwd_probs(q, k, v, dout, kv_mask, lse, delta, causal,
                             scale, dropout_rate, dropout_seed)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, kv_mask, lse, delta,
                            causal: bool, scale: float,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None):
    """Plain version of the dk/dv kernel on the same inputs."""
    qs, p, ds = _bwd_probs(q, k, v, dout, kv_mask, lse, delta, causal,
                           scale, dropout_rate, dropout_seed)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _kernel(name: str = "flash_attention"):
    """The ctypes functions of ``csrc/<name>.cu`` (``flash_attention``,
    ``flash_attention_tc``, ``flash_attention_tf32``,
    ``flash_attention_tc256``: forward, dq, dk/dv), built and loaded at
    first use: those of the three that the library exports."""
    if name not in _FN:
        lib = build.load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, H, Sq, Sk, D, scale, causal, seed, thresh, inv_keep, dtype,
        # stream
        shape = [i32] * 5 + [f32, i32, ctypes.c_uint32, i32, f32, i32, ptr]
        fns = {"fwd": (f"{name}_fwd", 7), "dq": (f"{name}_bwd_dq", 9),
               "dkv": (f"{name}_bwd_dkv", 10)}
        out = {}
        for key, (sym, n_ptrs) in fns.items():
            if not hasattr(lib, sym):
                continue
            fn = getattr(lib, sym)
            fn.argtypes = [ptr] * n_ptrs + shape
            fn.restype = i32
            out[key] = fn
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        out["err"] = err
        _FN[name] = out
    return _FN[name]


def _aligned(t: torch.Tensor) -> bool:
    """16-byte vector loads of 8 elements: the data pointer, and the batch,
    sequence and head strides, in whole 8-element vectors."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def _prepare(q, k, v, kv_mask, causal):
    """Checks the kernels rely on; returns inputs the kernels can read
    through their strides (a misaligned view is copied first) and the
    mask as contiguous fp32 [B, Sk], or None."""
    if not flash_ok(q, k, causal):
        raise ValueError(
            f"flash_attention kernel takes float32, bfloat16 or float16, "
            f"head_dim a multiple of 8 in [8, {MAX_HEAD_DIM}], at most "
            f"{MAX_BATCH_HEADS} batch x heads and, when causal, no more "
            f"queries than keys; got {q.dtype}, q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.shape != (b, sk, h, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, sk, h, d)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != "
                             f"{(b, sk)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32)
        kv_mask = kv_mask.contiguous()
    return q, k, v, kv_mask


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                     for s in t.stride()[:3]))


def _check(rc, what, name="flash_attention"):
    if rc != 0:
        err = _kernel(name)["err"]
        raise RuntimeError(f"{name} {what} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _drop_args(rate: float, seed: Optional[int]):
    """The kernels' dropout arguments: the seed as uint32, the integer
    threshold (0 turns the hash off) and the fp32 ``1 / (1 - rate)``, all
    from the host."""
    _check_dropout(rate, seed)
    if rate <= 0.0:
        return 0, 0, 1.0
    return int(seed) & MASK32, keep_threshold(rate), 1.0 / (1.0 - rate)


def _launch_fwd(name, q, k, v, kv_mask, causal, scale, dropout_rate,
                dropout_seed):
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fwd = _kernel(name)["fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
                 out.data_ptr(), lse.data_ptr(), _strides(q, k, v), b, h, sq,
                 k.shape[1], d, float(scale), int(causal),
                 *_drop_args(dropout_rate, dropout_seed),
                 _DTYPE_CODES[q.dtype], stream)
    _check(rc, "forward", name)
    return out, lse


def _launch_dq(name, q, k, v, dout, kv_mask, lse, delta, causal, scale,
               dropout_rate, dropout_seed):
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel(name)["dq"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(kv_mask), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), _strides(q, k, v), b, h, sq, k.shape[1], d,
                float(scale), int(causal),
                *_drop_args(dropout_rate, dropout_seed),
                _DTYPE_CODES[q.dtype], stream)
    _check(rc, "dq", name)
    return dq


def _launch_dkv(name, q, k, v, dout, kv_mask, lse, delta, causal, scale,
                dropout_rate, dropout_seed):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    fn = _kernel(name)["dkv"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(kv_mask), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _strides(q, k, v), b, h, sq, sk,
                d, float(scale), int(causal),
                *_drop_args(dropout_rate, dropout_seed),
                _DTYPE_CODES[q.dtype], stream)
    _check(rc, "dkv", name)
    return dk, dv


def _require(q, which: str, route: str, takes: str):
    """Raises unless ``_route`` sends ``which`` of q's dtype and head dim
    to ``route`` and q is not a CPU tensor: a wrapper checks its own
    kernel's route, so widening one kernel's route widens no other
    wrapper."""
    if _route(q.dtype, q.shape[-1], which) != route or \
            q.device.type == "cpu":
        raise ValueError(f"{takes}; got {which} of {q.dtype}, head_dim "
                         f"{q.shape[-1]} on {q.device}")


def _require_tc(q, which: str):
    _require(q, which, "tc", f"the tensor-core flash kernels take CUDA "
             f"bfloat16 or float16 with head_dim a multiple of 8 in [8, "
             f"{TC_MAX_HEAD_DIM}]")


def _require_tc256(q, which: str):
    _require(q, which, "tc256", f"the wgmma flash kernels take CUDA "
             f"bfloat16 or float16 with head_dim a multiple of 8 in "
             f"({TC_MAX_HEAD_DIM}, {MAX_HEAD_DIM}]")


def _require_tf32(q, which: str):
    _require(q, which, "tf32", f"the 3xTF32 flash kernels take CUDA "
             f"float32 with head_dim a multiple of 8 in [8, "
             f"{MAX_HEAD_DIM}]")


def flash_attention_fwd(q, k, v, kv_mask, causal: bool, scale: float,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None):
    """Launch the forward kernel :func:`_route` picks: returns ``out``
    (contiguous [B, Sq, H, D] in q's dtype) and ``lse`` (fp32 [B, H, Sq],
    of the undropped probabilities). Inputs as :func:`_prepare` returns
    them. The FMA kernel's launches count here, the tensor-core kernels'
    in :func:`flash_attention_fwd_tc`, :func:`flash_attention_fwd_tf32`
    and :func:`flash_attention_fwd_tc256`."""
    route = _route(q.dtype, q.shape[-1])
    if route != "fma":
        fn = {"tc": flash_attention_fwd_tc, "tf32": flash_attention_fwd_tf32,
              "tc256": flash_attention_fwd_tc256}[route]
        return fn(q, k, v, kv_mask, causal, scale, dropout_rate,
                  dropout_seed)
    out, lse = _launch_fwd("flash_attention", q, k, v, kv_mask, causal,
                           scale, dropout_rate, dropout_seed)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_wide += q.shape[-1] > TC_MAX_HEAD_DIM
    return out, lse


def flash_attention_fwd_tc(q, k, v, kv_mask, causal: bool, scale: float,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None):
    """Launch the tensor-core forward kernel (bfloat16 or float16,
    ``head_dim`` a multiple of 8 up to 128; anything else raises). Inputs
    and outputs as :func:`flash_attention_fwd`."""
    _require_tc(q, "fwd")
    out, lse = _launch_fwd("flash_attention_tc", q, k, v, kv_mask, causal,
                           scale, dropout_rate, dropout_seed)
    flash_attention_fwd_tc.launches += 1
    return out, lse


def flash_attention_fwd_tc256(q, k, v, kv_mask, causal: bool, scale: float,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None):
    """Launch the wgmma forward kernel (CUDA bfloat16 or float16,
    ``head_dim`` a multiple of 8 in (128, 256]; anything else raises).
    Inputs and outputs as :func:`flash_attention_fwd`."""
    _require_tc256(q, "fwd")
    out, lse = _launch_fwd("flash_attention_tc256", q, k, v, kv_mask, causal,
                           scale, dropout_rate, dropout_seed)
    flash_attention_fwd_tc256.launches += 1
    return out, lse


def flash_attention_fwd_tf32(q, k, v, kv_mask, causal: bool, scale: float,
                             dropout_rate: float = 0.0,
                             dropout_seed: Optional[int] = None):
    """Launch the 3xTF32 forward kernel (CUDA float32, ``head_dim`` a
    multiple of 8 up to 256; anything else raises). Inputs and outputs as
    :func:`flash_attention_fwd`."""
    _require_tf32(q, "fwd")
    out, lse = _launch_fwd("flash_attention_tf32", q, k, v, kv_mask, causal,
                           scale, dropout_rate, dropout_seed)
    flash_attention_fwd_tf32.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, kv_mask, lse, delta, causal: bool,
                           scale: float, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None):
    """Launch the dq kernel :func:`_route` picks: ``dout`` contiguous [B,
    Sq, H, D]; ``lse`` and ``delta`` fp32 [B, H, Sq]. Returns dq,
    contiguous [B, Sq, H, D]. The FMA kernel's launches count here, the
    tensor-core kernels' in :func:`flash_attention_bwd_dq_tc`,
    :func:`flash_attention_bwd_dq_tf32` and
    :func:`flash_attention_bwd_dq_tc256`."""
    route = _route(q.dtype, q.shape[-1], "dq")
    if route != "fma":
        fn = {"tc": flash_attention_bwd_dq_tc,
              "tf32": flash_attention_bwd_dq_tf32,
              "tc256": flash_attention_bwd_dq_tc256}[route]
        return fn(q, k, v, dout, kv_mask, lse, delta, causal, scale,
                  dropout_rate, dropout_seed)
    dq = _launch_dq("flash_attention", q, k, v, dout, kv_mask, lse, delta,
                    causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_wide += q.shape[-1] > TC_MAX_HEAD_DIM
    return dq


def flash_attention_bwd_dq_tc(q, k, v, dout, kv_mask, lse, delta,
                              causal: bool, scale: float,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None):
    """Launch the tensor-core dq kernel (bfloat16 or float16, ``head_dim``
    a multiple of 8 up to 128; anything else raises). Inputs and output as
    :func:`flash_attention_bwd_dq`."""
    _require_tc(q, "dq")
    dq = _launch_dq("flash_attention_tc", q, k, v, dout, kv_mask, lse, delta,
                    causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dq_tc.launches += 1
    return dq


def flash_attention_bwd_dq_tc256(q, k, v, dout, kv_mask, lse, delta,
                                 causal: bool, scale: float,
                                 dropout_rate: float = 0.0,
                                 dropout_seed: Optional[int] = None):
    """Launch the wgmma dq kernel (CUDA bfloat16 or float16, ``head_dim`` a
    multiple of 8 in (128, 256]; anything else raises). Inputs and output
    as :func:`flash_attention_bwd_dq`."""
    _require_tc256(q, "dq")
    dq = _launch_dq("flash_attention_tc256", q, k, v, dout, kv_mask, lse,
                    delta, causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dq_tc256.launches += 1
    return dq


def flash_attention_bwd_dq_tf32(q, k, v, dout, kv_mask, lse, delta,
                                causal: bool, scale: float,
                                dropout_rate: float = 0.0,
                                dropout_seed: Optional[int] = None):
    """Launch the 3xTF32 dq kernel (CUDA float32, ``head_dim`` a multiple
    of 8 up to 256; anything else raises). Inputs and output as
    :func:`flash_attention_bwd_dq`."""
    _require_tf32(q, "dq")
    dq = _launch_dq("flash_attention_tf32", q, k, v, dout, kv_mask, lse,
                    delta, causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dq_tf32.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, kv_mask, lse, delta,
                            causal: bool, scale: float,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None):
    """Launch the dk/dv kernel :func:`_route` picks. Returns dk, dv,
    contiguous [B, Sk, H, D]. The FMA kernel's launches count here, the
    tensor-core kernels' in :func:`flash_attention_bwd_dkv_tc`,
    :func:`flash_attention_bwd_dkv_tf32` and
    :func:`flash_attention_bwd_dkv_tc256`."""
    route = _route(q.dtype, q.shape[-1], "dkv")
    if route != "fma":
        fn = {"tc": flash_attention_bwd_dkv_tc,
              "tf32": flash_attention_bwd_dkv_tf32,
              "tc256": flash_attention_bwd_dkv_tc256}[route]
        return fn(q, k, v, dout, kv_mask, lse, delta, causal, scale,
                  dropout_rate, dropout_seed)
    dk, dv = _launch_dkv("flash_attention", q, k, v, dout, kv_mask, lse,
                         delta, causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_wide += q.shape[-1] > TC_MAX_HEAD_DIM
    return dk, dv


def flash_attention_bwd_dkv_tc(q, k, v, dout, kv_mask, lse, delta,
                               causal: bool, scale: float,
                               dropout_rate: float = 0.0,
                               dropout_seed: Optional[int] = None):
    """Launch the tensor-core dk/dv kernel (bfloat16 or float16,
    ``head_dim`` a multiple of 8 up to 128; anything else raises). Inputs
    and outputs as :func:`flash_attention_bwd_dkv`."""
    _require_tc(q, "dkv")
    dk, dv = _launch_dkv("flash_attention_tc", q, k, v, dout, kv_mask, lse,
                         delta, causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dkv_tc.launches += 1
    return dk, dv


def flash_attention_bwd_dkv_tc256(q, k, v, dout, kv_mask, lse, delta,
                                  causal: bool, scale: float,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None):
    """Launch the wgmma dk/dv kernel (CUDA bfloat16 or float16,
    ``head_dim`` a multiple of 8 in (128, 256]; anything else raises).
    Inputs and outputs as :func:`flash_attention_bwd_dkv`."""
    _require_tc256(q, "dkv")
    dk, dv = _launch_dkv("flash_attention_tc256", q, k, v, dout, kv_mask,
                         lse, delta, causal, scale, dropout_rate,
                         dropout_seed)
    flash_attention_bwd_dkv_tc256.launches += 1
    return dk, dv


def flash_attention_bwd_dkv_tf32(q, k, v, dout, kv_mask, lse, delta,
                                 causal: bool, scale: float,
                                 dropout_rate: float = 0.0,
                                 dropout_seed: Optional[int] = None):
    """Launch the 3xTF32 dk/dv kernel (CUDA float32, ``head_dim`` a
    multiple of 8 up to 256; anything else raises). Inputs and outputs as
    :func:`flash_attention_bwd_dkv`."""
    _require_tf32(q, "dkv")
    dk, dv = _launch_dkv("flash_attention_tf32", q, k, v, dout, kv_mask, lse,
                         delta, causal, scale, dropout_rate, dropout_seed)
    flash_attention_bwd_dkv_tf32.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd_tc.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq_tc.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv_tc.launches = 0
flash_attention_fwd_tf32.launches = 0
flash_attention_bwd_dq_tf32.launches = 0
flash_attention_bwd_dkv_tf32.launches = 0
flash_attention_fwd_tc256.launches = 0
flash_attention_bwd_dq_tc256.launches = 0
flash_attention_bwd_dkv_tc256.launches = 0
flash_attention_fwd.launches_wide = 0
flash_attention_bwd_dq.launches_wide = 0
flash_attention_bwd_dkv.launches_wide = 0


class _FlashAttention(torch.autograd.Function):
    """The CUDA kernels with their gradient: the forward saves ``out`` and
    ``lse`` (and keeps the dropout's rate and seed); the backward takes
    ``delta = rowsum(dO * out)`` in fp32, then launches the dq and dk/dv
    kernels of their routes (which regenerate the forward's keep-mask) or
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, rate, seed):
        q, k, v, kv_mask = _prepare(q, k, v, kv_mask, causal)
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale,
                                       rate, seed)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale, ctx.rate, ctx.seed = causal, scale, rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()                       # [B, H, Sq]
        drop = (ctx.rate, ctx.seed)
        dq = flash_attention_bwd_dq(q, k, v, dout, kv_mask, lse, delta,
                                    ctx.causal, ctx.scale, *drop)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, kv_mask, lse, delta,
                                         ctx.causal, ctx.scale, *drop)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors; ``kv_mask`` [B, Sk]
    (1/True = attend). Returns [B, Sq, H, D] in q's dtype; differentiable
    in q, k and v. Causal attention takes no more queries than keys (a
    query row with no visible key has no defined output).
    ``dropout_rate`` > 0 drops attention probabilities with the keep-mask
    :func:`dropout_keep_mask` of the host int ``dropout_seed``."""
    dropout_rate = float(dropout_rate)
    _check_dropout(dropout_rate, dropout_seed)
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal flash_attention needs Sq <= Sk, got Sq "
                         f"{q.shape[1]}, Sk {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=kv_mask,
                                         softmax_scale=softmax_scale,
                                         dropout_rate=dropout_rate,
                                         dropout_seed=dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                 float(_scale_of(q, softmax_scale)),
                                 dropout_rate, dropout_seed)
