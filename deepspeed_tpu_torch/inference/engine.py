"""Inference engine: weights on the device in the compute dtype, a
deterministic forward, and KV-cache generation.

The port of ``deepspeed_tpu/inference/engine.py`` for one device. The
engine runs on the card unless the caller passes ``device="cpu"``; with no
card and no device it raises rather than fall back to the CPU.
``checkpoint``: a training checkpoint (``runtime/checkpointing``) whose
fp32 masters become the weights. Tensor-parallel inference (``mp_size >
1``) and int8 weights (``quantize``) are not ported yet and are refused
by name.

Telemetry: ``recompile_detector`` flags a ``forward`` or ``generate`` call
at an input signature the engine has not run before (and the serving
engine's steps share it); a ``tracer`` (the run's ``StepTracer``) brackets
every call in an ``inference_forward`` or ``generate`` span, and without
one the span is the reusable no-op.
"""

from typing import Any, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import not_yet_ported
from deepspeed_tpu_torch.models.gpt import init_kv_cache
from deepspeed_tpu_torch.telemetry import RecompileDetector, StepTracer

# Smallest prompt bucket: shorter prompts share it.
MIN_PROMPT_BUCKET = 8


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when the card asked for (or
    implied) is absent: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: deepspeed_tpu_torch runs on the "
            "GPU unless the caller asks for the CPU (device='cpu')")
    return dev


def bucket_length(t: int, floor: int = MIN_PROMPT_BUCKET,
                  cap: Optional[int] = None) -> int:
    """Round ``t`` up to its prompt bucket: the next power of two, at least
    ``floor``, clamped to ``cap`` but never below ``t`` itself."""
    b = max(floor, 1 << max(0, (t - 1).bit_length()))
    if cap is not None:
        b = min(b, cap)
    return max(b, t)


def sample_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Greedy (``temperature == 0``, first index on ties as ``argmax`` in
    both packages) or temperature/top-k sampling over [B, V] fp32 logits.
    Sampling draws from ``generator`` and is not bit-equal to
    ``jax.random``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class InferenceEngine:
    """A GPT module on ``device`` in ``dtype``, with ``forward`` and
    ``generate``.

    ``model``: the port's GPT (``models/gpt.py``). ``params``: a
    ``state_dict`` (tensors or numpy arrays; ``models/convert.py`` makes one
    from a flax tree or from a seed), or None to keep the module's own
    weights. ``checkpoint``: a directory ``save_checkpoint`` wrote (its
    ``latest`` tag, or a tag directory), read through
    ``load_module_params`` when ``params`` is None. The engine owns the module: its weights are cast and moved in
    place. ``tracer``: the run's ``StepTracer`` (None: no spans).
    """

    def __init__(self, model, params: Optional[Mapping[str, Any]] = None,
                 dtype: Optional[torch.dtype] = None, device=None,
                 mp_size: int = 1, quantize: bool = False,
                 checkpoint: Optional[str] = None, tracer=None):
        if mp_size != 1:
            raise not_yet_ported(f"mp_size={mp_size} (tensor-parallel "
                                 f"inference)")
        if quantize:
            raise not_yet_ported("quantize (int8 weights)")
        if not hasattr(model, "cfg"):
            raise ValueError(f"InferenceEngine needs the port's GPT family; "
                             f"{type(model).__name__} is not")
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else torch.bfloat16
        if checkpoint is not None and params is None:
            from deepspeed_tpu_torch.runtime.checkpointing import \
                load_module_params
            params = load_module_params(checkpoint)
        if params is not None:
            model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) if not isinstance(
                    v, torch.Tensor) else v for k, v in params.items()},
                strict=True)
        model.to(device=self.device, dtype=self.dtype)
        model.eval()
        model.requires_grad_(False)
        self.module = model
        self.model_cfg = model.cfg
        self._generate_calls = 0
        self.recompile_detector = RecompileDetector()
        self.tracer = tracer if tracer is not None else \
            StepTracer(enabled=False)

    @torch.no_grad()
    def forward(self, input_ids, **kwargs):
        """Deterministic forward; returns the module's output dict."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        kwargs.setdefault("deterministic", True)
        self.recompile_detector.check("inference.forward", ids)
        with self.tracer.span("inference_forward"):
            return self.module(ids, **kwargs)

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None, attention_mask=None
                 ) -> torch.Tensor:
        """Autoregressive generation with a dense KV cache.

        ``input_ids``: [B, T0] prompts. Ragged prompts are **left-padded**
        to T0 with ``attention_mask`` [B, T0] (1 = real token, pads
        leading): pads are masked out of every attention step and positions
        are re-based per row so each row's content starts at 0. Prompts are
        left-padded further to a power-of-two bucket, as in the JAX engine
        (token-identical to the unpadded call). Greedy when ``temperature
        == 0``, else sampling from a generator seeded with ``seed`` (when
        None, with a count of the engine's sampled calls, so that repeated
        calls draw fresh samples).
        Returns [B, T0 + max_new_tokens] on the engine's device.
        """
        cfg = self.model_cfg
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long)
        b, t0 = ids.shape
        new = int(max_new_tokens)
        limit = cfg.max_seq_len
        if t0 + new > limit:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({new}) = {t0 + new} "
                f"exceeds the usable context of {limit} (model "
                f"max_seq_len)")
        if attention_mask is None:
            mask = np.ones((b, t0), np.int64)
        else:
            mask = np.asarray(attention_mask)
            if mask.shape != (b, t0):
                raise ValueError(f"attention_mask shape {mask.shape} != "
                                 f"{(b, t0)}")
            if not (np.diff(mask.astype(np.int8), axis=1) >= 0).all():
                raise ValueError("attention_mask must be left-padded "
                                 "(0s before 1s in every row)")
            if (mask.sum(axis=1) == 0).any():
                raise ValueError("attention_mask has a fully-padded row: "
                                 "every prompt needs at least one real "
                                 "token")
        # Left-pad to the prompt bucket: the masked pads and re-based
        # positions keep the padded call token-identical to the unpadded
        # one, and the pads are stripped from the result.
        t_pad = bucket_length(t0, cap=limit - new) - t0
        dev = self.device
        ids = torch.nn.functional.pad(ids, (t_pad, 0)).to(dev)
        mask = torch.nn.functional.pad(
            torch.as_tensor(mask, dtype=torch.long), (t_pad, 0)).to(dev)
        gen = None
        if temperature > 0.0:
            if seed is None:
                seed = self._generate_calls
                self._generate_calls += 1
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))

        tb = ids.shape[1]
        self.recompile_detector.check(
            "inference.generate", ids, mask,
            {"static": f"max_new_tokens={new},"
                       f"temperature={float(temperature)},"
                       f"top_k={int(top_k)}"})
        with self.tracer.span("generate", prompt_len=t0, bucket=tb,
                              new_tokens=new):
            full = self._generate(ids, mask, b, tb, new, temperature,
                                  top_k, gen)
        return full[:, t_pad:]

    def _generate(self, ids, mask, b, tb, new, temperature, top_k, gen):
        cfg, dev = self.model_cfg, self.device
        cache = init_kv_cache(cfg, b, tb + new, dtype=self.dtype,
                              device=dev)
        # One fixed [B, tb + new] key-validity mask: pads never visible,
        # generated positions always; positions re-based per row.
        n_pads = tb - mask.sum(dim=1)                               # [B]
        km = torch.cat([mask, torch.ones((b, new), dtype=torch.long,
                                         device=dev)], dim=1)
        pos_ids = (torch.arange(tb, device=dev)[None]
                   - n_pads[:, None]).clamp(min=0)
        out = self.module(ids, position_ids=pos_ids, attention_mask=km,
                          cache=cache, pos=0)
        nxt = sample_logits(out["logits"][:, -1].float(), temperature,
                            top_k, gen)
        toks = [nxt]
        for pos in range(tb, tb + new - 1):
            out = self.module(
                nxt[:, None], attention_mask=km,
                position_ids=(pos - n_pads).clamp(min=0)[:, None],
                cache=out["cache"], pos=pos)
            nxt = sample_logits(out["logits"][:, -1].float(), temperature,
                                top_k, gen)
            toks.append(nxt)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
