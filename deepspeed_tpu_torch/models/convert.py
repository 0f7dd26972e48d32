"""GPT and BERT weights between the flax trees of the JAX package and the
port.

The flax tree (as ``GPT.init`` prints it): ``wte`` [V, D], ``wpe`` [P, D],
``ln_f/{scale,bias}``, ``h_i/{ln_1,ln_2}/{scale,bias}``,
``h_i/{c_attn,c_proj,c_fc,mlp_proj}/{kernel,bias}`` and, untied,
``lm_head/kernel``. A Dense ``kernel`` is [in, out]; the port's
``nn.Linear.weight`` is [out, in], so it is transposed both ways. Padded
vocab rows are kept. Both directions copy values exactly.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from deepspeed_tpu_torch.models.bert import BertConfig
from deepspeed_tpu_torch.models.gpt import GPTConfig

_LN = ("ln_1", "ln_2")
_DENSE = ("c_attn", "c_proj", "c_fc", "mlp_proj")


def _from_numpy(x, transpose=False) -> torch.Tensor:
    a = np.asarray(x)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def gpt_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT param tree (numpy or anything ``np.asarray`` takes) ->
    the port's ``state_dict``."""
    t = _from_numpy
    sd = {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
          "ln_f.weight": t(tree["ln_f"]["scale"]),
          "ln_f.bias": t(tree["ln_f"]["bias"])}
    layers = sorted((k for k in tree if k.startswith("h_")),
                    key=lambda k: int(k[2:]))
    for i, name in enumerate(layers):
        if name != f"h_{i}":
            raise ValueError(f"flax GPT tree has layers {layers}; expected "
                             f"h_0..h_{len(layers) - 1}")
        blk = tree[name]
        for ln in _LN:
            sd[f"h.{i}.{ln}.weight"] = t(blk[ln]["scale"])
            sd[f"h.{i}.{ln}.bias"] = t(blk[ln]["bias"])
        for dense in _DENSE:
            sd[f"h.{i}.{dense}.weight"] = t(blk[dense]["kernel"], True)
            sd[f"h.{i}.{dense}.bias"] = t(blk[dense]["bias"])
    if "lm_head" in tree:
        sd["lm_head.weight"] = t(tree["lm_head"]["kernel"], True)
    return sd


def flax_params_from_gpt(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the flax GPT param tree (numpy)."""
    def n(key, transpose=False):
        a = state_dict[key].detach().cpu().numpy()
        return np.ascontiguousarray(a.T) if transpose else a.copy()

    tree: Dict[str, Any] = {
        "wte": n("wte"), "wpe": n("wpe"),
        "ln_f": {"scale": n("ln_f.weight"), "bias": n("ln_f.bias")}}
    i = 0
    while f"h.{i}.c_attn.weight" in state_dict:
        blk = {ln: {"scale": n(f"h.{i}.{ln}.weight"),
                    "bias": n(f"h.{i}.{ln}.bias")} for ln in _LN}
        for dense in _DENSE:
            blk[dense] = {"kernel": n(f"h.{i}.{dense}.weight", True),
                          "bias": n(f"h.{i}.{dense}.bias")}
        tree[f"h_{i}"] = blk
        i += 1
    if "lm_head.weight" in state_dict:
        tree["lm_head"] = {"kernel": n("lm_head.weight", True)}
    return tree


def _lecun_normal(rng: np.random.Generator, fan_in: int,
                  shape) -> np.ndarray:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in (the 0.8796... divisor is the
    standard deviation of the unit normal truncated at +-2)."""
    x = rng.standard_normal(shape, dtype=np.float32)
    flat = x.reshape(-1)
    bad = np.flatnonzero(np.abs(flat) > 2.0)
    while bad.size:      # redraw only the rejected values, in index order
        flat[bad] = rng.standard_normal(bad.size, dtype=np.float32)
        bad = bad[np.abs(flat[bad]) > 2.0]
    return x * np.float32(np.sqrt(1.0 / fan_in) / 0.87962566103423978)


def init_flax_gpt_params(cfg: GPTConfig, seed: int = 0) -> Dict[str, Any]:
    """Random GPT weights in the flax tree layout, from numpy, with the
    distributions of flax's initialisers in the JAX model: normal(0.02)
    ``wte``, normal(0.01) ``wpe``, LayerNorm ones/zeros, Dense
    lecun-normal kernels and zero biases. Not bit-equal to ``jax.random``;
    the same seed gives the same weights in both packages' tests."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size

    def ln():
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    def dense(fan_in, fan_out):
        return {"kernel": _lecun_normal(rng, fan_in, (fan_in, fan_out)),
                "bias": np.zeros(fan_out, np.float32)}

    tree: Dict[str, Any] = {
        "wte": rng.standard_normal((cfg.padded_vocab, d), dtype=np.float32)
        * np.float32(0.02),
        "wpe": rng.standard_normal((cfg.max_seq_len, d), dtype=np.float32)
        * np.float32(0.01),
    }
    for i in range(cfg.num_layers):
        tree[f"h_{i}"] = {"ln_1": ln(), "c_attn": dense(d, 3 * d),
                          "c_proj": dense(d, d), "ln_2": ln(),
                          "c_fc": dense(d, f), "mlp_proj": dense(f, d)}
    tree["ln_f"] = ln()
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": _lecun_normal(rng, d,
                                                   (d, cfg.vocab_size))}
    return tree


def init_gpt_params(cfg: GPTConfig, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Random full-width weights without a download: the port's
    ``state_dict`` of :func:`init_flax_gpt_params`."""
    return gpt_params_from_flax(init_flax_gpt_params(cfg, seed))


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------
#
# The flax tree (``BertModel.init``): ``wte`` [V, D], ``wpe`` [P, D],
# ``tte`` [T, D], ``ln_emb`` (post-LN) or ``ln_f`` (pre-LN)
# ``{scale,bias}``, ``layer_i/{ln_attn,ln_mlp}/{scale,bias}``,
# ``layer_i/{c_attn,c_proj,c_fc,mlp_proj}/{kernel,bias}``,
# ``mlm_transform/{kernel,bias}``, ``mlm_ln/{scale,bias}``, ``mlm_bias``
# [V] and, when the init batch carried ``next_sentence_label``,
# ``pooler`` and ``nsp_head`` ``{kernel,bias}``. The port's names are the
# same with ``layer.i.`` for ``layer_i/``, ``weight`` for ``scale`` and
# the transposed ``weight`` for ``kernel``.

_BERT_LN = ("ln_attn", "ln_mlp")
_BERT_TOP_LN = ("ln_emb", "ln_f", "mlm_ln")
_BERT_TOP_DENSE = ("mlm_transform", "pooler", "nsp_head")


def bert_params_from_flax(tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """Flax BERT param tree (numpy or anything ``np.asarray`` takes) -> the
    port's ``state_dict``. It holds ``pooler.*`` and ``nsp_head.*``
    exactly when the tree does: build the model with ``make_bert(...,
    nsp="pooler" in tree)``."""
    t = _from_numpy
    sd = {k: t(tree[k]) for k in ("wte", "wpe", "tte", "mlm_bias")}
    for ln in _BERT_TOP_LN:
        if ln in tree:
            sd[f"{ln}.weight"] = t(tree[ln]["scale"])
            sd[f"{ln}.bias"] = t(tree[ln]["bias"])
    for dense in _BERT_TOP_DENSE:
        if dense in tree:
            sd[f"{dense}.weight"] = t(tree[dense]["kernel"], True)
            sd[f"{dense}.bias"] = t(tree[dense]["bias"])
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k[6:]))
    for i, name in enumerate(layers):
        if name != f"layer_{i}":
            raise ValueError(f"flax BERT tree has layers {layers}; expected "
                             f"layer_0..layer_{len(layers) - 1}")
        sd.update({f"layer.{i}.{k}": v for k, v in
                   bert_layer_params_from_flax(tree[name]).items()})
    return sd


def bert_layer_params_from_flax(block: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """One layer's flax subtree (``BertLayer`` or
    ``DeepSpeedTransformerLayer``: the same names) -> the ``state_dict``
    of the port's ``BertLayer`` or ``DeepSpeedTransformerLayer``."""
    t = _from_numpy
    sd = {}
    for ln in _BERT_LN:
        sd[f"{ln}.weight"] = t(block[ln]["scale"])
        sd[f"{ln}.bias"] = t(block[ln]["bias"])
    for dense in _DENSE:
        sd[f"{dense}.weight"] = t(block[dense]["kernel"], True)
        sd[f"{dense}.bias"] = t(block[dense]["bias"])
    return sd


def flax_params_from_bert(state_dict: Mapping[str, torch.Tensor]
                          ) -> Dict[str, Any]:
    """The port's BERT ``state_dict`` -> the flax param tree (numpy)."""
    def n(key, transpose=False):
        a = state_dict[key].detach().cpu().numpy()
        return np.ascontiguousarray(a.T) if transpose else a.copy()

    tree: Dict[str, Any] = {k: n(k) for k in ("wte", "wpe", "tte",
                                              "mlm_bias")}
    for ln in _BERT_TOP_LN:
        if f"{ln}.weight" in state_dict:
            tree[ln] = {"scale": n(f"{ln}.weight"), "bias": n(f"{ln}.bias")}
    for dense in _BERT_TOP_DENSE:
        if f"{dense}.weight" in state_dict:
            tree[dense] = {"kernel": n(f"{dense}.weight", True),
                           "bias": n(f"{dense}.bias")}
    i = 0
    while f"layer.{i}.c_attn.weight" in state_dict:
        blk = {ln: {"scale": n(f"layer.{i}.{ln}.weight"),
                    "bias": n(f"layer.{i}.{ln}.bias")} for ln in _BERT_LN}
        for dense in _DENSE:
            blk[dense] = {"kernel": n(f"layer.{i}.{dense}.weight", True),
                          "bias": n(f"layer.{i}.{dense}.bias")}
        tree[f"layer_{i}"] = blk
        i += 1
    return tree


def init_flax_bert_params(cfg: BertConfig, seed: int = 0,
                          nsp: bool = False) -> Dict[str, Any]:
    """Random BERT weights in the flax tree layout, from numpy, with the
    distributions of flax's initialisers in the JAX model: normal(0.02)
    ``wte``, ``wpe`` and ``tte``, LayerNorm ones/zeros, Dense lecun-normal
    kernels and zero biases, a zero ``mlm_bias``; ``nsp`` adds ``pooler``
    and ``nsp_head``. Not bit-equal to
    ``jax.random``; the same seed gives the same weights in both
    packages' tests."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size

    def ln():
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    def dense(fan_in, fan_out):
        return {"kernel": _lecun_normal(rng, fan_in, (fan_in, fan_out)),
                "bias": np.zeros(fan_out, np.float32)}

    def table(rows):
        return (rng.standard_normal((rows, d), dtype=np.float32)
                * np.float32(0.02))

    tree: Dict[str, Any] = {"wte": table(cfg.vocab_size),
                            "wpe": table(cfg.max_seq_len),
                            "tte": table(cfg.type_vocab_size)}
    if not cfg.pre_layer_norm:
        tree["ln_emb"] = ln()
    for i in range(cfg.num_layers):
        tree[f"layer_{i}"] = {"ln_attn": ln(), "c_attn": dense(d, 3 * d),
                              "c_proj": dense(d, d), "ln_mlp": ln(),
                              "c_fc": dense(d, f), "mlp_proj": dense(f, d)}
    if cfg.pre_layer_norm:
        tree["ln_f"] = ln()
    tree["mlm_transform"] = dense(d, d)
    tree["mlm_ln"] = ln()
    tree["mlm_bias"] = np.zeros(cfg.vocab_size, np.float32)
    if nsp:
        tree["pooler"] = dense(d, d)
        tree["nsp_head"] = dense(d, 2)
    return tree


def init_bert_params(cfg: BertConfig, seed: int = 0,
                     nsp: bool = False) -> Dict[str, torch.Tensor]:
    """Random full-width BERT weights without a download: the port's
    ``state_dict`` of :func:`init_flax_bert_params`."""
    return bert_params_from_flax(init_flax_bert_params(cfg, seed, nsp))
