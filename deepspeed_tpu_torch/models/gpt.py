"""GPT-2 family as PyTorch modules.

The port of ``deepspeed_tpu/models/gpt.py``: pre-LN blocks with a combined
QKV projection, LayerNorm in fp32, the tanh-GELU MLP and a tied (or
untied) head. A forward without a cache is the training/eval form: it
returns the token-mean next-token loss (through the fused CE head when the
head is tied) and attention goes through ``ops/transformer/attention``
(the flash kernels on the card). A forward with a cache takes one of three
cache forms, as the JAX model does:

- a per-layer ``(k, v)`` tuple of dense [B, max_len, H, D] tensors
  (prefill, ``generate``), written at the scalar ``pos``;
- a paged layer cache (``serving/kv_cache.PagedLayerCache``) with
  ``attn_impl == "gather"``: write through the block table, gather the
  window, masked dense attention;
- the same with ``attn_impl == "kernel"``: write, then the paged
  decode-attention kernel straight over the pools;
- a chunked layer cache (``serving/kv_cache.ChunkedLayerCache``,
  ``attn_impl == "chunked"``): the flat ragged token batch of a mixed
  step as one row [1, T], written per token, then the chunked-prefill
  kernel over the pools.

Parameter names follow torch (``h.0.c_attn.weight`` [out, in]);
``models/convert.py`` maps them to and from the flax tree. The config's
defaults are the JAX package's. Dropout (``dropout_rate > 0``) acts in a
training forward (``deterministic=False``, no cache) at the JAX model's
four sites: the attention probabilities (inside the flash kernels, or
the plain attention with the same mask), the attention output after
``c_proj``, the MLP output and the embeddings; ``ops/dropout.py`` drops
the activations (``fast_dropout``: the counter hash, bit-equal to JAX's
for one seed). Such a forward takes ``dropout_seed``, a host int, and
each site's seed is ``fold_seed(dropout_seed, layer + 1, site)`` (sites
0, 1, 2: probabilities, attention output, MLP output; the embeddings are
``fold_seed(dropout_seed, 0, 0)``): the port's own fold, since flax's
``make_rng`` path folds cannot be reproduced without jax. Inference,
serving and eval are deterministic and ignore dropout, as in JAX. Under
``sparse_attention`` the probabilities get no dropout, as in JAX; the
three activation sites still apply. A ``sparse_attention`` block
(the DeepSpeed config block: mode, block, ...) routes the training
forward's attention through ``ops/sparse_attention`` (its kernels on the
card); a forward with a cache stays dense, as in JAX. ``fused_ln`` fuses
the pre-LN sites (LN1 + QKV, LN2 + fc + GELU) through
``ops/transformer/fused.ln_matmul`` (its kernels on the card), in every
forward form, as in JAX. ``remat`` recomputes each block whole in the
backward of a training forward (``runtime/activation_checkpointing.
module_checkpoint``: non-reentrant, no policy, as JAX's
``nn.remat(GPTBlock)``); the dropout masks come
back from the same folded seeds, so losses and gradients equal those
without it. MoE and the sparse embedding gradient are refused at
construction until a later slice ports them.
"""

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.config.config import not_yet_ported
from deepspeed_tpu_torch.ops.dropout import dropout_module, fold_seed
from deepspeed_tpu_torch.ops.embedding import embedding_lookup, vocab_pad_mask
from deepspeed_tpu_torch.ops.sparse_attention.utils import \
    get_sparse_self_attention
from deepspeed_tpu_torch.ops.transformer.attention import (attention,
                                                           xla_attention)
from deepspeed_tpu_torch.ops.transformer.fused import ln_matmul, ln_matmul_ok
from deepspeed_tpu_torch.ops.xent import fused_cross_entropy
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    module_checkpoint


def _fused_ln_sites(mode) -> Tuple[str, ...]:
    """The sites a ``fused_ln`` value asks for; raises ValueError on a
    value the JAX model refuses (anything but False, None, True, "auto",
    "qkv" and "mlp")."""
    if mode is False or mode is None:
        return ()
    if mode is not True and mode not in ("auto", "qkv", "mlp"):
        raise ValueError(f"unknown fused_ln value {mode!r}: expected False, "
                         "True, 'auto', 'qkv', or 'mlp'")
    return ("qkv", "mlp") if mode is True or mode == "auto" else (mode,)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    attention_impl: str = "auto"
    remat: bool = False
    tie_embeddings: bool = True
    layer_norm_epsilon: float = 1e-5
    fused_ce: bool = True                    # ops/xent.py fused CE head
    fused_ce_fp32_logits: bool = False       # fp32 logits inside it
    attention_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)
    vocab_pad_multiple: int = 0
    embed_grad_matmul: bool = False          # fp32-summed embedding grad
    sparse_embedding_grad: Any = None
    fast_dropout: bool = True
    # Block-sparse attention config dict (the DeepSpeed `sparse_attention`
    # block: mode/block/num_local_blocks/...); None = dense attention.
    sparse_attention: Any = None
    # Fused LayerNorm + projection at the two pre-LN sites (LN1 + QKV and
    # LN2 + fc + GELU): True = both, "qkv" / "mlp" = one, "auto" = both
    # when the input is on CUDA, False / None = unfused.
    fused_ln: Any = False
    # Training option of the JAX GPTConfig, accepted off only.
    moe_experts: int = 0

    def __post_init__(self):
        _fused_ln_sites(self.fused_ln)
        for key, off in (("moe_experts", 0),
                         ("sparse_embedding_grad", None)):
            if getattr(self, key) not in (off, None, 0, False):
                raise not_yet_ported(f"GPTConfig.{key}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        if m <= 1:
            return self.vocab_size
        return (self.vocab_size + m - 1) // m * m


# Named configurations (sizes follow the public GPT-2 family).
GPT_CONFIGS: Dict[str, GPTConfig] = {
    "tiny": GPTConfig(vocab_size=512, max_seq_len=128, hidden_size=64,
                      num_layers=2, num_heads=4, dropout_rate=0.0),
    "gpt2": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": GPTConfig(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt2-xl": GPTConfig(hidden_size=1600, num_layers=48, num_heads=25),
}


def _use_fused_ln(cfg: GPTConfig, x: torch.Tensor) -> frozenset:
    """The fused sites of this forward (``deepspeed_tpu/models/gpt.py:
    _use_fused_ln``): "auto" takes both sites on a CUDA input and none on
    the CPU; each asked-for site is then gated on its own shapes by
    ``ln_matmul_ok``."""
    want = _fused_ln_sites(cfg.fused_ln)
    if cfg.fused_ln == "auto" and x.device.type != "cuda":
        return frozenset()
    n = x.shape[0] * x.shape[1]
    out_dim = {"qkv": 3 * cfg.hidden_size,
               "mlp": cfg.mlp_ratio * cfg.hidden_size}
    return frozenset(s for s in want
                     if ln_matmul_ok(n, cfg.hidden_size, out_dim[s]))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm, as flax's ``LayerNorm(dtype=float32)``. flax takes
    the variance as E[x^2] - E[x]^2; torch's two-pass form differs from it
    by rounding only (the tests' 1e-4 logits bound covers it)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def _dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)``: input and weights in ``dt``."""
    bias = lin.bias.to(dt) if lin.bias is not None else None
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


class GPTBlock(nn.Module):
    """Pre-LN transformer block: LN -> QKV -> attention -> proj, then
    LN -> fc -> tanh-GELU -> proj, each with a residual; under ``fused_ln``
    a site's LN and projection (and GELU) are one ``ln_matmul``."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(d, eps=eps)
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d, eps=eps)
        self.c_fc = nn.Linear(d, cfg.mlp_ratio * d)
        self.mlp_proj = nn.Linear(cfg.mlp_ratio * d, d)
        self.drop = dropout_module(cfg)(cfg.dropout_rate)

    def forward(self, x: torch.Tensor, attn_mask=None, kv_cache=None,
                pos: Optional[int] = None,
                seeds: Optional[Tuple[int, int, int]] = None):
        """``kv_cache``: None, a dense ``(k, v)`` tuple, or a paged layer
        cache. Returns ``(x, cache)`` in cache mode, ``x`` otherwise. The
        dense cache is written in place at ``pos`` (the JAX model returns
        an updated copy). ``seeds``: the dropout seeds of the layer's three
        sites (probabilities, attention output, MLP output), or None for
        no dropout."""
        cfg = self.cfg
        dt = cfg.dtype
        attn_seed, proj_seed, mlp_seed = seeds or (None, None, None)
        fused = _use_fused_ln(cfg, x)
        if "qkv" in fused:
            qkv = ln_matmul(x, self.ln_1.weight, self.ln_1.bias,
                            self.c_attn.weight.to(dt),
                            self.c_attn.bias.to(dt), eps=self.ln_1.eps)
        else:
            h = _layer_norm(self.ln_1, x).to(dt)
            qkv = _dense(self.c_attn, h, dt)
        b, s = x.shape[0], x.shape[1]
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in qkv.split(cfg.hidden_size, -1))
        scale = cfg.attention_scale
        if kv_cache is None and cfg.sparse_attention is not None:
            # The block-sparse path: the layout of this sequence length,
            # shared by every layer (get_sparse_self_attention caches it).
            ssa = get_sparse_self_attention(cfg.sparse_attention,
                                            cfg.num_heads)
            km = attn_mask[:, 0, 0, :] if attn_mask is not None else None
            o = ssa(q, k, v, causal=True, key_mask=km, softmax_scale=scale)
        elif kv_cache is None:
            o = attention(q, k, v, causal=True, mask=attn_mask,
                          dropout_rate=cfg.dropout_rate,
                          dropout_seed=attn_seed,
                          deterministic=seeds is None, softmax_scale=scale,
                          impl=cfg.attention_impl)
        elif isinstance(kv_cache, tuple):
            ck, cv = kv_cache
            ck[:, pos:pos + s] = k.to(ck.dtype)
            cv[:, pos:pos + s] = v.to(cv.dtype)
            # Key j is visible to query i iff j <= pos + i: the cached past
            # plus the causal prefix of this chunk.
            qpos = pos + torch.arange(s, device=x.device)
            kpos = torch.arange(ck.shape[1], device=x.device)
            mask = (kpos[None, :] <= qpos[:, None])[None, None]
            if attn_mask is not None:
                mask = mask & attn_mask
            o = xla_attention(q, ck, cv, mask=mask, softmax_scale=scale)
        elif kv_cache.attn_impl in ("kernel", "chunked") \
                and attn_mask is None:
            # "chunked": the ragged mixed step (ChunkedLayerCache), its
            # flat token batch riding as one row [1, T].
            kv_cache, o = kv_cache.update_attend(q, k, v,
                                                 softmax_scale=scale)
        else:
            # Rows of a continuous batch sit at different positions: the
            # paged cache writes at its per-row positions and hands back
            # the gathered window and its visibility mask.
            kv_cache, ck, cv, mask = kv_cache.update(k, v)
            if attn_mask is not None:
                mask = mask & attn_mask
            o = xla_attention(q, ck, cv, mask=mask, softmax_scale=scale)
        o = _dense(self.c_proj, o.reshape(b, s, cfg.hidden_size), dt)
        x = x + self.drop(o, proj_seed)
        if "mlp" in fused:
            h = ln_matmul(x, self.ln_2.weight, self.ln_2.bias,
                          self.c_fc.weight.to(dt), self.c_fc.bias.to(dt),
                          eps=self.ln_2.eps, activation="gelu")
        else:
            h = _layer_norm(self.ln_2, x).to(dt)
            h = F.gelu(_dense(self.c_fc, h, dt), approximate="tanh")
        h = _dense(self.mlp_proj, h, dt)
        x = x + self.drop(h, mlp_seed)
        return (x, kv_cache) if kv_cache is not None else x


class GPT(nn.Module):
    """Causal LM. ``forward(input_ids, labels=None, attention_mask=None,
    deterministic=False, dropout_seed=None)`` returns ``{"loss",
    "logits"}``; in cache mode ``{"logits", "cache"}``."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.wte = nn.Parameter(torch.empty(cfg.padded_vocab, d))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d))
        nn.init.normal_(self.wte, std=0.02)
        nn.init.normal_(self.wpe, std=0.01)
        self.h = nn.ModuleList(GPTBlock(cfg) for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon)
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Linear(d, cfg.vocab_size, bias=False))
        self.drop = dropout_module(cfg)(cfg.dropout_rate)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = False,
                position_ids: Optional[torch.Tensor] = None,
                cache: Optional[List[Any]] = None,
                pos: Optional[int] = None,
                dropout_seed: Optional[int] = None) -> Dict[str, Any]:
        """``input_ids``: [B, S]. ``labels``: [B, S] next-token targets
        (-100 = ignore), or None for ``input_ids`` shifted left.
        ``attention_mask``: [B, S] (1 = keep), or in cache mode a full
        [B, cache_len] key-validity mask (the JAX model also places a
        [B, S] chunk mask at ``pos``; nothing in the port needs that).
        ``deterministic``: False is a training forward. ``position_ids``:
        optional per-row positions [B, S] (left-padded prompts re-base
        theirs to start at 0). ``cache``: per-layer caches (see the module
        docstring); ``pos``: the dense cache's write offset.
        ``dropout_seed``: the host int a training forward at
        ``dropout_rate > 0`` drops out with (the engine draws one per
        micro-batch); the sites' seeds fold from it (module docstring).

        A training forward through the fused CE head returns
        ``"logits": None``: eagerly, the fp32 [B, S, V] logits would cost
        their matmul and 1.6 GB at GPT-2's bench shape for nothing, where
        the JAX step's compiler drops them unused."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s = input_ids.shape
        drop = cache is None and not deterministic and cfg.dropout_rate > 0
        if drop and dropout_seed is None:
            raise ValueError(
                f"a training forward at dropout_rate={cfg.dropout_rate} "
                f"needs dropout_seed (or deterministic=True)")
        if position_ids is not None:
            pe = self.wpe[position_ids]
        elif pos is None:
            pe = self.wpe[:s][None]
        else:
            pe = self.wpe[pos:pos + s][None]
        tok = embedding_lookup(self.wte, input_ids,
                               matmul_grad=cfg.embed_grad_matmul)
        x = tok.to(dt) + pe.to(dt)
        if drop:
            x = self.drop(x, fold_seed(dropout_seed, 0, 0))

        attn_mask = None
        if attention_mask is not None:
            am = attention_mask.bool()
            if cache is not None:
                lmax = (cache[0][0].shape[1] if isinstance(cache[0], tuple)
                        else cache[0].key_len)
                if am.shape[1] != lmax:
                    raise ValueError(
                        f"cache mode takes a full [B, {lmax}] key-validity "
                        f"attention_mask; got {tuple(am.shape)}")
            attn_mask = am[:, None, None, :]

        new_cache = []
        for i, block in enumerate(self.h):
            if cache is not None:
                x, layer_kv = block(x, attn_mask, cache[i], pos)
                new_cache.append(layer_kv)
            else:
                seeds = (tuple(fold_seed(dropout_seed, i + 1, site)
                               for site in range(3)) if drop else None)
                if cfg.remat and torch.is_grad_enabled():
                    # (x, attn_mask, kv_cache, pos, seeds)
                    x = module_checkpoint(block, block, x, attn_mask, None,
                                          None, seeds)
                else:
                    x = block(x, attn_mask, seeds=seeds)

        x = _layer_norm(self.ln_f, x)
        fused = cfg.tie_embeddings and cfg.fused_ce
        logits = None
        if cache is not None or deterministic or not fused:
            logits = self._head(x)
        if cache is not None:
            return {"logits": logits, "cache": new_cache}
        # Loss through the fused CE head (ops/xent.py): compute-dtype
        # logits, lse-only residual, backward recompute.
        tgt = shift_labels({"input_ids": input_ids, "labels": labels})
        if fused:
            mask = (vocab_pad_mask(cfg.padded_vocab, cfg.vocab_size,
                                   device=x.device)
                    if cfg.padded_vocab != cfg.vocab_size else None)
            loss = fused_cross_entropy(x.to(dt), self.wte.to(dt), tgt,
                                       bias=mask, bias_grad=False,
                                       logits_fp32=cfg.fused_ce_fp32_logits)
        else:
            loss = cross_entropy_with_ignore(logits, tgt)
        return {"loss": loss, "logits": logits}

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        if self.lm_head is None:
            # The JAX head is a ``dt`` matmul with fp32 output: round both
            # operands to ``dt``, then multiply in fp32. Products of bf16
            # values are exact in fp32 (and in TF32), so the logits carry
            # fp32 sums, not a bf16 rounding of them.
            logits = x.to(dt).float() @ self.wte.to(dt).float().t()
            if cfg.padded_vocab != cfg.vocab_size:
                logits = logits[..., :cfg.vocab_size]
            return logits
        return _dense(self.lm_head, x, dt).float()


def shift_labels(batch: Dict[str, Any]) -> torch.Tensor:
    """Next-token labels: explicit ``labels`` or ``input_ids`` shifted left
    with the trailing position ignored (-100)."""
    labels = batch.get("labels")
    if labels is None:
        ids = batch["input_ids"]
        labels = F.pad(ids[:, 1:], (0, 1), value=-100)
    return labels


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = -100) -> torch.Tensor:
    """Token-mean cross entropy, fp32, ignoring ``ignore_index``
    positions."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


def init_kv_cache(cfg: GPTConfig, batch_size: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer dense ``(k, v)`` caches [B, max_len, H, D], zeroed."""
    dtype = dtype if dtype is not None else cfg.dtype
    shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


def make_gpt(name_or_cfg="tiny", **overrides) -> Tuple[GPT, GPTConfig]:
    cfg = (GPT_CONFIGS[name_or_cfg] if isinstance(name_or_cfg, str)
           else name_or_cfg)
    if overrides:
        cfg = replace(cfg, **overrides)
    return GPT(cfg), cfg
