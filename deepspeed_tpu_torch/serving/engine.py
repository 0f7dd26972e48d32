"""ServeEngine: continuous batching over the inference engine.

The port of ``deepspeed_tpu/serving/engine.py`` on its default admission
path. Each ``step()``:

- **admits and prefills** up to ``max_prefills_per_step`` waiting requests:
  one sequence's prompt, right-padded to a power-of-two bucket of whole
  blocks, runs the dense-cache forward, its first token is sampled, and
  its K/V are packed into the paged pools;
- **decodes** one token for every running sequence: the whole slot batch
  goes through the paged cache with per-row positions, and inactive slots
  point at the scratch block;
- samples greedily (or with temperature/top-k from a seeded generator).

Scheduling between steps is host Python (``serving/scheduler.py``). Where
the JAX package compiles one program per prompt bucket and per decode
window, the port runs eagerly, and the pools are written in place.

``decode_attention``: "gather" gathers the full table window each step;
"kernel" caps the window at the longest active row (a power-of-two block
count) and attends through the paged decode-attention kernel; "auto" is
"kernel" on a CUDA device (raising where the kernel does not take the
pool) and "gather" on the CPU.

Not ported yet, and refused by ``ServingConfig``: the prefix cache,
speculative decoding, chunked prefill, the int8 KV pool, resilience and
telemetry.
"""

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  bucket_length,
                                                  sample_logits)
from deepspeed_tpu_torch.models.gpt import init_kv_cache
from deepspeed_tpu_torch.ops.transformer.paged_attention import \
    paged_decode_ok
from deepspeed_tpu_torch.serving.kv_cache import (BlockPool, PagedLayerCache,
                                                  init_paged_pools,
                                                  pack_prefill)
from deepspeed_tpu_torch.serving.scheduler import Scheduler, Sequence
from deepspeed_tpu_torch.utils.logging import log_dist


def resolve_decode_attention(mode: str, device_type: str, head_dim: int,
                             dtype: torch.dtype) -> str:
    """The decode attention impl for ``serving.decode_attention``.

    On a CUDA device "auto" is "kernel", and a pool the kernel does not
    take raises: the decode never drops to the gather path behind the
    caller's back. On the CPU "auto" is "gather"."""
    if mode == "auto":
        mode = "kernel" if device_type == "cuda" else "gather"
    if mode == "kernel" and device_type == "cuda" \
            and not paged_decode_ok(head_dim, dtype):
        raise ValueError(
            f"serving.decode_attention='kernel': the CUDA kernel takes "
            f"float32 or bfloat16 pools and head_dim a multiple of 8 up "
            f"to 256, not {dtype} / {head_dim}")
    return mode


class ServeEngine:
    """Continuous-batching serving engine over an :class:`InferenceEngine`.

    ``engine``: an InferenceEngine wrapping the port's GPT. ``config``: a
    ``ServingConfig`` (None for defaults). Drive it with ``submit()`` and
    ``step()`` / ``run_until_complete()``.
    """

    def __init__(self, engine: InferenceEngine,
                 config: Optional[ServingConfig] = None):
        self.engine = engine
        self.module = engine.module
        self.model_cfg = engine.model_cfg
        self.device = engine.device
        self.scfg = config if config is not None else ServingConfig()

        model_max = int(self.model_cfg.max_seq_len)
        self.max_model_len = min(self.scfg.max_model_len or model_max,
                                 model_max)
        bs = self.scfg.kv_block_size
        self.block_size = bs
        self.max_blocks = -(-self.max_model_len // bs)   # ceil
        # Prompt buckets are whole blocks whose positions exist in the
        # model (wpe rows) and in the block table.
        self.bucket_cap = min(self.max_blocks * bs, (model_max // bs) * bs)
        if self.bucket_cap < bs:
            raise ValueError(
                f"serving.kv_block_size={bs} exceeds the usable context "
                f"({model_max}): no prompt bucket fits")

        self.pool = BlockPool(self.scfg.kv_num_blocks)
        self.sched = Scheduler(self.scfg.max_batch_size, self.pool, bs)
        self._dtype = engine.dtype
        self._pools = init_paged_pools(self.model_cfg,
                                       self.scfg.kv_num_blocks, bs,
                                       dtype=self._dtype, device=self.device)
        self._fast_path = self.scfg.decode_attention != "gather"
        self._attn_impl = resolve_decode_attention(
            self.scfg.decode_attention, self.device.type,
            self.model_cfg.head_dim, self._dtype)
        self._generator = None
        if self.scfg.temperature > 0.0:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.scfg.seed)
        self._step_count = 0
        self.results: Dict[int, Dict[str, Any]] = {}
        # ``gathered_positions``: key positions the decode steps covered
        # per row (window width x steps); ``full_positions``: the same for
        # an uncapped window.
        self.stats = {"decode_steps": 0,
                      "slot_assignments": {}, "kernel_steps": 0,
                      "gathered_positions": 0, "full_positions": 0}
        log_dist(
            f"serving: {self.scfg.max_batch_size} slots, KV pool "
            f"{self.pool.capacity}x{bs} positions ({self._dtype}) on "
            f"{self.device}, decode attention {self._attn_impl}, "
            f"max_model_len {self.max_model_len}", ranks=[0])

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None) -> int:
        """Queue one request; returns its request id. Admission happens at
        the next ``step()`` boundary."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) > self.bucket_cap:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the largest prefill "
                f"bucket ({self.bucket_cap})")
        if len(prompt) + int(max_new_tokens) > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")
        vocab = self.model_cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        bs = self.block_size
        # Lifetime KV need: the LAST sampled token's KV is never written,
        # so the highest write position is prompt + max_new_tokens - 2.
        need = max(self._bucket_of(len(prompt)) // bs,
                   -(-(len(prompt) + int(max_new_tokens) - 1) // bs))
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds "
                f"{self.pool.capacity}: it could never be admitted; raise "
                f"serving.kv_num_blocks")
        eos = eos_token_id if eos_token_id is not None \
            else self.scfg.eos_token_id
        return self.sched.submit(prompt, int(max_new_tokens), eos)

    def idle(self) -> bool:
        return self.sched.idle()

    # ------------------------------------------------------------------
    # the serving step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> Dict[str, Any]:
        """One engine iteration: admit + prefill (bounded), then advance
        the whole decode batch one token. Returns a step report
        (``finished`` / ``prefilled`` request ids, ``active`` count)."""
        info: Dict[str, Any] = {"step": self._step_count, "prefilled": [],
                                "finished": [], "active": 0}
        for _ in range(self.scfg.max_prefills_per_step):
            seq = self.sched.try_admit(self._bucket_of, self._step_count)
            if seq is None:
                break
            self._prefill(seq)
            info["prefilled"].append(seq.request.rid)
            self.stats["slot_assignments"].setdefault(seq.slot, 0)
            self.stats["slot_assignments"][seq.slot] += 1
            if seq.finished():      # max_new_tokens == 1 / instant EOS
                self._finish(seq, info)

        for seq in self.sched.active:
            if self.sched.running.get(seq.slot) is seq:
                self.sched.ensure_capacity(seq)
        active = self.sched.active          # preemption may have evicted
        info["active"] = len(active)
        if active:
            toks = self._decode(active)
            for seq, tok in zip(active, toks):
                seq.tokens.append(tok)
                seq.pos += 1
                if seq.finished():
                    self._finish(seq, info)
            self.stats["decode_steps"] += 1
        self._step_count += 1
        return info

    def run_until_complete(self, max_steps: int = 100_000
                           ) -> Dict[int, Any]:
        """Drive ``step()`` until every submitted request has finished;
        returns the results map (rid -> record)."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving did not drain in {max_steps} steps "
                    f"(queue={self.sched.queue_depth}, "
                    f"running={len(self.sched.running)})")
        return self.results

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _bucket_of(self, t: int) -> int:
        b = bucket_length(t, cap=self.bucket_cap)
        b = -(-b // self.block_size) * self.block_size   # whole blocks
        return min(max(b, -(-t // self.block_size) * self.block_size),
                   self.bucket_cap)

    def _result_record(self, seq: Sequence, status: str) -> Dict[str, Any]:
        req = seq.request
        now = time.monotonic()
        return {
            "tokens": list(seq.tokens),
            "prompt_len": len(req.prompt),
            "status": status,
            "slot": seq.slot,
            "finish_step": self._step_count,
            "ttft_ms": (req.first_token_time - req.arrival) * 1e3
            if req.first_token_time else None,
            "finish_time": now,
            "e2e_ms": (now - req.arrival) * 1e3,
            "queue_wait_ms": (req.admitted_time - req.arrival) * 1e3
            if req.admitted_time is not None else None,
            "preempted_count": req.preempted_count,
        }

    def _finish(self, seq: Sequence, info: Dict[str, Any]) -> None:
        rid = seq.request.rid
        self.sched.finish(seq)
        self.results[rid] = self._result_record(seq, "finished")
        info["finished"].append(rid)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self.scfg.temperature,
                             self.scfg.top_k, self._generator)

    # -- prefill --------------------------------------------------------
    def _prefill(self, seq: Sequence) -> None:
        t = len(seq.request.prompt)
        ids = torch.zeros((1, seq.bucket), dtype=torch.long)
        ids[0, :t] = torch.tensor(seq.request.prompt)  # right-pad: causal
        tok, k_stack, v_stack = self._prefill_impl(ids.to(self.device), t)
        blocks = torch.tensor(seq.block_table, dtype=torch.long,
                              device=self.device)
        pack_prefill(self._pools, blocks, k_stack, v_stack)
        first = int(tok)                     # host fetch = first token
        seq.tokens.append(first)
        if seq.request.first_token_time is None:   # not on a restart
            seq.request.first_token_time = time.monotonic()

    def _prefill_impl(self, ids: torch.Tensor, length: int):
        cache = init_kv_cache(self.model_cfg, 1, ids.shape[1],
                              dtype=self._dtype, device=self.device)
        out = self.module(ids, cache=cache, pos=0)
        # Right-padded prompt: causality alone keeps pad positions out of
        # every real token's attention, so the last REAL position's logits
        # are exact; pad-position K/V are garbage the position mask hides.
        last = out["logits"][:, length - 1].float()              # [1, V]
        tok = self._sample(last)[0]
        k_stack = torch.stack([c[0][0] for c in out["cache"]])  # [L,Tb,H,D]
        v_stack = torch.stack([c[1][0] for c in out["cache"]])
        return tok, k_stack, v_stack

    # -- decode ---------------------------------------------------------
    def _batch_inputs(self, active: List[Sequence]):
        """Host-side decode batch matrices (inactive rows -> scratch)."""
        nb, mb = self.scfg.max_batch_size, self.max_blocks
        bt = np.zeros((nb, mb), np.int32)
        pos = np.zeros((nb,), np.int32)
        toks = np.zeros((nb,), np.int64)
        for seq in active:
            s = seq.slot
            bt[s, :len(seq.block_table)] = seq.block_table
            pos[s] = seq.pos
            toks[s] = seq.tokens[-1]
        return bt, pos, toks

    def _window_blocks(self, active: List[Sequence]) -> int:
        """Capped key window: enough table columns for the longest active
        row's reads and this step's write, ceiled to a power of two."""
        need_pos = max(seq.pos for seq in active) + 1
        need = -(-need_pos // self.block_size)
        wb = 1
        while wb < need:
            wb *= 2
        return min(wb, self.max_blocks)

    def _dispatch_batch(self, active: List[Sequence]):
        """Decode batch tensors on the device, the window cut under the
        fast path, and the attention impl; keeps the window accounting."""
        mb = self.max_blocks
        bt, pos, toks = self._batch_inputs(active)
        if self._fast_path:
            wb, impl = self._window_blocks(active), self._attn_impl
            bt = np.ascontiguousarray(bt[:, :wb])
        else:
            wb, impl = mb, "gather"
        self.stats["gathered_positions"] += wb * self.block_size
        self.stats["full_positions"] += mb * self.block_size
        if impl == "kernel":
            self.stats["kernel_steps"] += 1
        dev = self.device
        return (torch.from_numpy(bt).to(dev), torch.from_numpy(pos).to(dev),
                torch.from_numpy(toks).to(dev), impl)

    def _decode(self, active: List[Sequence]) -> List[int]:
        bt, pos, toks, impl = self._dispatch_batch(active)
        logits = self._decode_impl(bt, pos, toks, impl)
        tok_host = self._sample(logits).cpu().numpy()   # host fetch
        return [int(tok_host[s.slot]) for s in active]

    def _decode_impl(self, bt, pos, toks, impl: str) -> torch.Tensor:
        cache = [PagedLayerCache(*self._pools[i], bt, pos, self.block_size,
                                 impl)
                 for i in range(self.model_cfg.num_layers)]
        out = self.module(toks[:, None], position_ids=pos.long()[:, None],
                          cache=cache)
        return out["logits"][:, -1].float()
