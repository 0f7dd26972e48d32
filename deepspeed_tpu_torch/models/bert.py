"""BERT family as PyTorch modules.

The port of ``deepspeed_tpu/models/bert.py``: the encoder in pre-LN (the
reference's ``modelingpreln.py``, the default) or post-LN (the original
BERT, with an embedding LayerNorm ``ln_emb``) form, the MLM head
(``mlm_transform`` -> tanh-GELU -> ``mlm_ln`` -> the tied ``wte`` plus the
fp32 ``mlm_bias``) and, when the model is built with it, the NSP head
(``pooler`` -> tanh -> ``nsp_head``). Attention is non-causal under the
key-padding ``attention_mask``: through ``ops/transformer/attention`` (the
flash kernels on the card), or with ``cfg.sparse_attention`` through the
block-sparse executor (its kernels on the card).

Dtypes follow the JAX model step by step: the embedding sum in the
parameters' dtype, then cast to ``cfg.dtype``; the residual sums in
``cfg.dtype``; every LayerNorm in fp32, then cast; the head a product of
``cfg.dtype`` operands with an fp32 result, plus ``mlm_bias``. A training
forward through the fused CE head returns ``"logits": None``, as
``models/gpt.py`` explains.

Dropout (``dropout_rate > 0`` in a training forward) takes the host int
``dropout_seed``; the sites' seeds fold from it with
``ops/dropout.fold_seed`` as in the GPT: the embeddings ``(0, 0)``, layer
i's attention probabilities, attention output and MLP output ``(i + 1,
0)``, ``(i + 1, 1)``, ``(i + 1, 2)``. The sparse path drops no
probabilities, as in JAX.

Departures from the JAX model:
- flax creates ``pooler`` / ``nsp_head`` when the init batch carries
  ``next_sentence_label``; here the model is built with or without them
  (``make_bert(..., nsp=...)``), so that it holds exactly a given tree's
  parameters. A forward with ``next_sentence_label`` on a model built
  without the head raises ValueError.
- ``remat``, ``sparse_embedding_grad`` and a batch carrying ``pld_theta``
  (progressive layer drop) raise "not yet ported".
- ``comm.overlap.marked_block`` is left out: it is the identity unless
  the overlapped grad sync (not ported) is on.
"""

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.config.config import not_yet_ported
from deepspeed_tpu_torch.models.gpt import (_dense, _layer_norm,
                                            cross_entropy_with_ignore)
from deepspeed_tpu_torch.ops.dropout import dropout_module, fold_seed
from deepspeed_tpu_torch.ops.embedding import embedding_lookup
from deepspeed_tpu_torch.ops.sparse_attention.utils import \
    get_sparse_self_attention
from deepspeed_tpu_torch.ops.transformer.attention import attention
from deepspeed_tpu_torch.ops.xent import fused_cross_entropy


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    attention_impl: str = "auto"
    pre_layer_norm: bool = True              # reference fused-kernel default
    remat: bool = False
    layer_norm_epsilon: float = 1e-12
    fused_ce: bool = True                    # ops/xent.py fused CE head
    fused_ce_fp32_logits: bool = False       # fp32 logits inside it
    # Block-sparse attention config dict (the DeepSpeed `sparse_attention`
    # block); None = dense attention.
    sparse_attention: Any = None
    fast_dropout: bool = True
    sparse_embedding_grad: Any = None

    def __post_init__(self):
        for key, off in (("remat", False), ("sparse_embedding_grad", None)):
            if getattr(self, key) not in (off, None, 0, False):
                raise not_yet_ported(f"BertConfig.{key}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_CONFIGS: Dict[str, BertConfig] = {
    "tiny": BertConfig(vocab_size=512, max_seq_len=128, hidden_size=64,
                       num_layers=2, num_heads=4, dropout_rate=0.0),
    "bert-base": BertConfig(hidden_size=768, num_layers=12, num_heads=12),
    "bert-large": BertConfig(hidden_size=1024, num_layers=24, num_heads=16),
}


class BertLayer(nn.Module):
    """One encoder layer: attention (``c_attn`` -> non-causal attention ->
    ``c_proj``) and the tanh-GELU MLP (``c_fc`` -> ``mlp_proj``), each with
    a residual, pre-LN (``ln_attn``, ``ln_mlp`` before each) or post-LN
    (after each residual sum). ``intermediate_size`` (default
    ``mlp_ratio`` x hidden) and ``attn_dropout_rate`` (default
    ``dropout_rate``) are the fused layer op's own widths and rates.

    ``recompute`` names the pieces whose activations the backward
    recomputes instead of saving (``torch.utils.checkpoint``,
    non-reentrant): ``"norm"`` (the two LayerNorms), ``"attn"`` (the
    attention block) and ``"mlp"`` (the MLP block). The dropout masks are
    regenerated from the same seeds, so outputs and gradients are
    bit-equal to no recomputation. ``BertModel`` recomputes nothing."""

    recompute: frozenset = frozenset()

    def __init__(self, cfg: BertConfig,
                 intermediate_size: Optional[int] = None,
                 attn_dropout_rate: Optional[float] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        f = intermediate_size or cfg.mlp_ratio * d
        eps = cfg.layer_norm_epsilon
        self.attn_dropout_rate = (cfg.dropout_rate if attn_dropout_rate
                                  is None else attn_dropout_rate)
        self.ln_attn = nn.LayerNorm(d, eps=eps)
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_mlp = nn.LayerNorm(d, eps=eps)
        self.c_fc = nn.Linear(d, f)
        self.mlp_proj = nn.Linear(f, d)
        self.drop = dropout_module(cfg)(cfg.dropout_rate)

    def _piece(self, name: str, fn):
        """``fn`` of one tensor, recomputed in the backward when ``name``
        is in ``recompute``."""
        if name not in self.recompute:
            return fn

        def run(h):
            if torch.is_grad_enabled():
                return checkpoint(fn, h, use_reentrant=False)
            return fn(h)
        return run

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                seeds: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
        """``attn_mask``: bool [B, 1, 1, S] key padding (True = attend), or
        None. ``seeds``: the dropout seeds of the layer's three sites
        (probabilities, attention output, MLP output), or None for no
        dropout."""
        cfg = self.cfg
        dt = cfg.dtype
        attn_seed, proj_seed, mlp_seed = seeds or (None, None, None)

        def attn(h):
            qkv = _dense(self.c_attn, h, dt)
            b, s = h.shape[0], h.shape[1]
            shape = (b, s, cfg.num_heads, cfg.head_dim)
            q, k, v = (t.reshape(shape)
                       for t in qkv.split(cfg.hidden_size, -1))
            if cfg.sparse_attention is not None:
                ssa = get_sparse_self_attention(cfg.sparse_attention,
                                                cfg.num_heads)
                km = attn_mask[:, 0, 0, :] if attn_mask is not None else None
                o = ssa(q, k, v, causal=False, key_mask=km)
            else:
                o = attention(q, k, v, causal=False, mask=attn_mask,
                              dropout_rate=self.attn_dropout_rate,
                              dropout_seed=attn_seed,
                              deterministic=seeds is None,
                              impl=cfg.attention_impl)
            o = _dense(self.c_proj, o.reshape(b, s, cfg.hidden_size), dt)
            return self.drop(o, proj_seed)

        def mlp(h):
            h = F.gelu(_dense(self.c_fc, h, dt), approximate="tanh")
            return self.drop(_dense(self.mlp_proj, h, dt), mlp_seed)

        attn, mlp = self._piece("attn", attn), self._piece("mlp", mlp)
        norm1 = self._piece("norm", lambda h: _layer_norm(self.ln_attn, h))
        norm2 = self._piece("norm", lambda h: _layer_norm(self.ln_mlp, h))
        if cfg.pre_layer_norm:
            x = x + attn(norm1(x).to(dt))
            x = x + mlp(norm2(x).to(dt))
        else:   # post-LN original BERT
            x = norm1(x + attn(x)).to(dt)
            x = norm2(x + mlp(x)).to(dt)
        return x


class BertModel(nn.Module):
    """Pretraining model: the encoder, the MLM head and, with ``nsp``, the
    NSP head. ``forward(input_ids, attention_mask=None,
    token_type_ids=None, labels=None, next_sentence_label=None,
    deterministic=False, dropout_seed=None)`` returns ``{"loss",
    "logits"[, "nsp_logits"]}``."""

    def __init__(self, cfg: BertConfig, nsp: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        eps = cfg.layer_norm_epsilon
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d))
        self.tte = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        for table in (self.wte, self.wpe, self.tte):
            nn.init.normal_(table, std=0.02)
        self.ln_emb = (None if cfg.pre_layer_norm
                       else nn.LayerNorm(d, eps=eps))
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(d, eps=eps) if cfg.pre_layer_norm else None
        self.mlm_transform = nn.Linear(d, d)
        self.mlm_ln = nn.LayerNorm(d, eps=eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.pooler = nn.Linear(d, d) if nsp else None
        self.nsp_head = nn.Linear(d, 2) if nsp else None
        self.drop = dropout_module(cfg)(cfg.dropout_rate)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                next_sentence_label: Optional[torch.Tensor] = None,
                deterministic: bool = False,
                dropout_seed: Optional[int] = None,
                pld_theta=None) -> Dict[str, Any]:
        """``input_ids`` [B, S]; ``attention_mask`` [B, S] (1 = keep);
        ``token_type_ids`` [B, S], or None for type 0 everywhere;
        ``labels`` [B, S] MLM targets (-100 = unmasked), or None for no MLM
        loss; ``next_sentence_label`` [B], or None for no NSP loss.
        ``deterministic``: False is a training forward, which at
        ``dropout_rate > 0`` needs ``dropout_seed``. ``pld_theta`` (the JAX
        engine's progressive-layer-drop key) raises: not yet ported."""
        if pld_theta is not None:
            raise not_yet_ported("progressive layer drop (a batch carrying "
                                 "pld_theta)")
        cfg = self.cfg
        dt = cfg.dtype
        s = input_ids.shape[1]
        drop = not deterministic and cfg.dropout_rate > 0
        if drop and dropout_seed is None:
            raise ValueError(
                f"a training forward at dropout_rate={cfg.dropout_rate} "
                f"needs dropout_seed (or deterministic=True)")
        if next_sentence_label is not None and self.nsp_head is None:
            raise ValueError("next_sentence_label given to a BertModel "
                             "built without the NSP head (make_bert(..., "
                             "nsp=True))")
        tt = (self.tte[token_type_ids] if token_type_ids is not None
              else self.tte[0][None, None])
        x = (embedding_lookup(self.wte, input_ids) + self.wpe[:s][None]
             + tt).to(dt)
        if self.ln_emb is not None:
            x = _layer_norm(self.ln_emb, x).to(dt)
        if drop:
            x = self.drop(x, fold_seed(dropout_seed, 0, 0))

        attn_mask = (attention_mask.bool()[:, None, None, :]
                     if attention_mask is not None else None)
        for i, layer in enumerate(self.layer):
            seeds = (tuple(fold_seed(dropout_seed, i + 1, site)
                           for site in range(3)) if drop else None)
            x = layer(x, attn_mask, seeds=seeds)
        if self.ln_f is not None:
            x = _layer_norm(self.ln_f, x).to(dt)

        # MLM head: transform + tied decoder (original BERT head shape)
        h = F.gelu(_dense(self.mlm_transform, x, dt), approximate="tanh")
        h = _layer_norm(self.mlm_ln, h)
        fused = cfg.fused_ce and labels is not None
        logits = None
        if deterministic or not fused:
            # the JAX head: dt operands, fp32 products and sums
            logits = (h.to(dt).float() @ self.wte.to(dt).float().t()
                      + self.mlm_bias)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if fused:
            loss = fused_cross_entropy(h.to(dt), self.wte.to(dt), labels,
                                       bias=self.mlm_bias, bias_grad=True,
                                       logits_fp32=cfg.fused_ce_fp32_logits)
        elif labels is not None:
            loss = cross_entropy_with_ignore(logits, labels)
        out: Dict[str, Any] = {"logits": logits}
        if next_sentence_label is not None:
            pooled = torch.tanh(_dense(self.pooler, x[:, 0], dt))
            nsp_logits = _dense(self.nsp_head, pooled, dt)
            nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            loss = loss - nsp_logp.gather(
                -1, next_sentence_label.long()[:, None]).mean()
            out["nsp_logits"] = nsp_logits
        out["loss"] = loss
        return out


def make_bert(name_or_cfg="tiny", nsp: bool = False,
              **overrides) -> Tuple[BertModel, BertConfig]:
    """A named (or given) configuration with ``overrides``; ``nsp`` builds
    the NSP head (``pooler``, ``nsp_head``)."""
    cfg = (BERT_CONFIGS[name_or_cfg] if isinstance(name_or_cfg, str)
           else name_or_cfg)
    if overrides:
        cfg = replace(cfg, **overrides)
    return BertModel(cfg, nsp=nsp), cfg
