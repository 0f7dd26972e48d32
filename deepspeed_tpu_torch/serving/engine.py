"""ServeEngine: continuous batching over the inference engine.

The port of ``deepspeed_tpu/serving/engine.py``. Each ``step()``:

- **admits** up to ``max_prefills_per_step`` waiting requests. On the
  bucketed path (the default) each admitted prompt is prefilled at once:
  right-padded to a power-of-two bucket of whole blocks, it runs the
  dense-cache forward, its first token is sampled, and its K/V are packed
  into the paged pools; a prompt whose head was adopted from the prefix
  cache prefills only its tail, through the paged cache. Under
  ``serving.chunked_prefill`` admission only allocates: the prompt enters
  the mixed step in chunks;
- **decodes** one token for every running sequence: the whole slot batch
  goes through the paged cache with per-row positions, and inactive slots
  point at the scratch block. Under chunked prefill this is the **mixed
  step** instead: one ragged token batch of every decoding sequence's
  token plus prompt chunks (FCFS, up to ``token_budget`` tokens), padded
  to the budget, through the chunked-prefill kernel; a prompt whose last
  chunk lands takes its first token from that chunk's last row;
- samples greedily (or with temperature/top-k from a seeded generator; the
  chunked path is greedy only).

Scheduling between steps is host Python (``serving/scheduler.py``). Where
the JAX package compiles one program per prompt bucket and per decode
window, the port runs eagerly, and the pools are written in place.

``decode_attention``: "gather" gathers the full table window each step;
"kernel" caps the window at the longest active row (a power-of-two block
count) and attends through the paged decode-attention kernel; "auto" is
"kernel" on a CUDA device (raising where the kernel does not take the
pool) and "gather" on the CPU. ``int8_kv_cache`` stores the pools as int8
with per-(token, head) scales on every path.

Not ported yet, and refused by ``ServingConfig``: speculative decoding,
resilience and telemetry.
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
from deepspeed_tpu_torch.ops.transformer.chunked_prefill import chunked_runs
from deepspeed_tpu_torch.ops.transformer.paged_attention import \
    paged_decode_ok
from deepspeed_tpu_torch.serving.kv_cache import (BlockPool,
                                                  ChunkedLayerCache,
                                                  PagedLayerCache,
                                                  init_paged_pools,
                                                  pack_prefill)
from deepspeed_tpu_torch.serving.scheduler import (PrefixCache, Scheduler,
                                                   Sequence)
from deepspeed_tpu_torch.utils.logging import log_dist


def _check_kernel_takes(what: str, head_dim: int, dtype: torch.dtype,
                        pool_dtype: Optional[torch.dtype]) -> None:
    if not paged_decode_ok(head_dim, dtype, pool_dtype):
        raise ValueError(
            f"{what}: the CUDA kernel takes float32 or bfloat16 queries, "
            f"pools of their dtype or int8, and head_dim a multiple of 8 "
            f"up to 256, not {dtype} over {pool_dtype or dtype} pools / "
            f"{head_dim}")


def resolve_decode_attention(mode: str, device_type: str, head_dim: int,
                             dtype: torch.dtype,
                             pool_dtype: Optional[torch.dtype] = None
                             ) -> str:
    """The decode attention impl for ``serving.decode_attention``.

    ``dtype``: the queries' dtype at the kernel; ``pool_dtype``: the
    pools' (None: the same; int8 for the int8 pool). On a CUDA device
    "auto" is "kernel", and operands the kernel does not take raise: the
    decode never drops to the gather path behind the caller's back. On
    the CPU "auto" is "gather"."""
    if mode == "auto":
        mode = "kernel" if device_type == "cuda" else "gather"
    if mode == "kernel" and device_type == "cuda":
        _check_kernel_takes("serving.decode_attention='kernel'", head_dim,
                            dtype, pool_dtype)
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
        self.prefix_cache = (PrefixCache(self.pool, bs)
                             if self.scfg.prefix_cache else None)
        self.sched = Scheduler(self.scfg.max_batch_size, self.pool, bs,
                               prefix_cache=self.prefix_cache)
        self._dtype = engine.dtype
        int8 = self.scfg.int8_kv_cache
        self._pools = init_paged_pools(self.model_cfg,
                                       self.scfg.kv_num_blocks, bs,
                                       int8=int8, dtype=self._dtype,
                                       device=self.device)
        # What the kernels see: an fp pool gets q cast to its dtype, an
        # int8 pool q in the model's compute dtype.
        pool_dtype = torch.int8 if int8 else self._dtype
        q_dtype = self.model_cfg.dtype if int8 else self._dtype
        self._fast_path = self.scfg.decode_attention != "gather"
        self._attn_impl = resolve_decode_attention(
            self.scfg.decode_attention, self.device.type,
            self.model_cfg.head_dim, q_dtype, pool_dtype)
        # Chunked prefill: every token of a mixed step goes through the
        # chunked-prefill kernel on CUDA (no head_dim % 128 gate: that is
        # the TPU's lane tiling).
        self._chunked = self.scfg.chunked_prefill
        self._chunk_budget = self.scfg.chunked_token_budget
        if self._chunked and self.device.type == "cuda":
            _check_kernel_takes("serving.chunked_prefill",
                                self.model_cfg.head_dim, q_dtype,
                                pool_dtype)
        self._generator = None
        if self.scfg.temperature > 0.0:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.scfg.seed)
        self._step_count = 0
        self.results: Dict[int, Dict[str, Any]] = {}
        # ``gathered_positions``: key positions the decode steps covered
        # per row (window width x steps); ``full_positions``: the same for
        # an uncapped window. ``mixed_steps``: chunked mixed dispatches;
        # ``chunk_tokens_last``: real tokens in the last one.
        self.stats = {"decode_steps": 0,
                      "slot_assignments": {}, "kernel_steps": 0,
                      "gathered_positions": 0, "full_positions": 0,
                      "prefix_hits": 0, "mixed_steps": 0,
                      "chunk_tokens_last": 0}
        admission = (f"chunked prefill, token budget {self._chunk_budget}"
                     if self._chunked else "bucketed prefill")
        log_dist(
            f"serving: {self.scfg.max_batch_size} slots, KV pool "
            f"{self.pool.capacity}x{bs} positions "
            f"({'int8' if int8 else self._dtype}) on {self.device}, "
            f"{admission}, decode attention {self._attn_impl}, prefix "
            f"cache {'on' if self.prefix_cache else 'off'}, max_model_len "
            f"{self.max_model_len}", ranks=[0])

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
        """One engine iteration: admit (+ prefill on the bucketed path,
        bounded), then advance the whole decode batch one token (under
        chunked prefill: one mixed step). Returns a step report
        (``finished`` / ``prefilled`` request ids, ``active`` count)."""
        info: Dict[str, Any] = {"step": self._step_count, "prefilled": [],
                                "finished": [], "active": 0}
        for _ in range(self.scfg.max_prefills_per_step):
            seq = self.sched.try_admit(self._bucket_of, self._step_count)
            if seq is None:
                break
            self.stats["slot_assignments"].setdefault(seq.slot, 0)
            self.stats["slot_assignments"][seq.slot] += 1
            if self._chunked:
                # No prefill here: the prompt enters the mixed step in
                # chunks from its adopted head; its first token and prefix
                # registration come with its last chunk (_mixed_round).
                seq.pos = seq.prefilled = seq.shared_len
                continue
            self._prefill(seq)
            self.sched.register_prefix(seq, self._step_count)
            info["prefilled"].append(seq.request.rid)
            if seq.finished():      # max_new_tokens == 1 / instant EOS
                self._finish(seq, info)

        for seq in self.sched.active:
            if self.sched.running.get(seq.slot) is seq:
                self.sched.ensure_capacity(seq)
        active = self.sched.active          # preemption may have evicted
        info["active"] = len(active)
        if active:
            if self._chunked:
                self._mixed_round(active, info)
            else:
                toks = self._decode(active)
                for seq, tok in zip(active, toks):
                    seq.tokens.append(tok)
                    seq.pos += 1
                    if seq.finished():
                        self._finish(seq, info)
            self.stats["decode_steps"] += 1
        if self.prefix_cache is not None:
            self.stats["prefix_hits"] = self.prefix_cache.hits
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
        if self._chunked:
            # Exact whole blocks: the ragged mixed step takes any length,
            # so neither KV blocks nor prefill compute pay pow2 rounding.
            return min(-(-t // self.block_size) * self.block_size,
                       self.bucket_cap)
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
        if seq.shared_len:
            # Prefix-cache hit: the adopted blocks already hold positions
            # [0, shared_len); only the tail is computed.
            self._prefill_tail(seq)
            return
        t = len(seq.request.prompt)
        ids = torch.zeros((1, seq.bucket), dtype=torch.long)
        ids[0, :t] = torch.tensor(seq.request.prompt)  # right-pad: causal
        tok, k_stack, v_stack = self._prefill_impl(ids.to(self.device), t)
        blocks = torch.tensor(seq.block_table, dtype=torch.long,
                              device=self.device)
        pack_prefill(self._pools, blocks, k_stack, v_stack)
        self._record_first_token(seq, int(tok))   # host fetch

    def _prefill_tail(self, seq: Sequence) -> None:
        """Prefill only the unshared prompt tail: the tail, right-padded
        to a block-multiple bucket, runs one multi-token paged forward at
        position ``shared_len`` through the gather path (as the JAX
        package's tail prefill does). Writes land past the adopted head
        blocks; pad positions past the allocated blocks hit zero table
        entries (scratch). The bucket is capped so no write index runs
        past the table."""
        t = len(seq.request.prompt)
        sl = seq.shared_len
        tail = t - sl                           # >= 1 (match is capped)
        tb = min(self._bucket_of(tail),
                 self.max_blocks * self.block_size - sl)
        ids = torch.zeros((1, tb), dtype=torch.long)
        ids[0, :tail] = torch.tensor(seq.request.prompt[sl:])
        bt = torch.zeros((1, self.max_blocks), dtype=torch.int32)
        bt[0, :len(seq.block_table)] = torch.tensor(seq.block_table)
        dev = self.device
        start = torch.tensor([sl], dtype=torch.int32, device=dev)
        cache = [PagedLayerCache(*self._pools[i], bt.to(dev), start,
                                 self.block_size, "gather",
                                 dtype=self._dtype)
                 for i in range(self.model_cfg.num_layers)]
        pos_ids = torch.clamp(start.long()[:, None] + torch.arange(
            tb, device=dev), max=self.model_cfg.max_seq_len - 1)
        out = self.module(ids.to(dev), position_ids=pos_ids, cache=cache)
        last = out["logits"][:, tail - 1].float()                # [1, V]
        self._record_first_token(seq, int(self._sample(last)[0]))

    def _record_first_token(self, seq: Sequence, first: int) -> None:
        """Append the prefill's sampled token; TTFT is stamped at the
        request's first prefill only (not on a preemption restart)."""
        seq.tokens.append(first)
        if seq.request.first_token_time is None:
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
                                 impl, dtype=self._dtype)
                 for i in range(self.model_cfg.num_layers)]
        out = self.module(toks[:, None], position_ids=pos.long()[:, None],
                          cache=cache)
        return out["logits"][:, -1].float()

    # -- chunked prefill: the mixed ragged step -------------------------
    def _mixed_round(self, active: List[Sequence],
                     info: Dict[str, Any]) -> None:
        """One mixed step: every decoding sequence advances one token and
        prompts being prefilled advance one chunk, all in one ragged
        batch. Rows: decode tokens first (the budget is >= the slot
        count), then chunks FCFS by ``(admitted_step, rid)`` until the
        budget is full. A prompt whose last chunk lands samples its first
        token from that chunk's last row: the logits the bucketed prefill
        samples from."""
        plen = [len(s.request.prompt) for s in active]
        decoding = [s for s, n in zip(active, plen) if s.prefilled >= n]
        prefilling = sorted(
            (s for s, n in zip(active, plen) if s.prefilled < n),
            key=lambda s: (s.admitted_step, s.request.rid))
        rows = [(s.slot, s.tokens[-1], s.pos) for s in decoding]
        chunks = []                              # (seq, first_row, count)
        for s in prefilling:
            if len(rows) >= self._chunk_budget:
                break
            t0 = s.prefilled
            c = min(len(s.request.prompt) - t0,
                    self._chunk_budget - len(rows))
            chunks.append((s, len(rows), c))
            rows.extend((s.slot, s.request.prompt[t0 + i], t0 + i)
                        for i in range(c))
        tok_host = self._mixed_dispatch(active, rows)
        self.stats["chunk_tokens_last"] = len(rows)
        for r, seq in enumerate(decoding):
            seq.tokens.append(int(tok_host[r]))
            seq.pos += 1
            if seq.finished():
                self._finish(seq, info)
        for seq, r0, c in chunks:
            seq.prefilled += c
            seq.pos = seq.prefilled
            if seq.prefilled == len(seq.request.prompt):
                self._record_first_token(seq, int(tok_host[r0 + c - 1]))
                self.sched.register_prefix(seq, self._step_count)
                info["prefilled"].append(seq.request.rid)
                if seq.finished():   # max_new_tokens == 1 / instant EOS
                    self._finish(seq, info)

    def _mixed_dispatch(self, table_seqs: List[Sequence], rows):
        """Run one ragged token batch. ``rows``: ``(slot, token,
        position)`` triples, padded to the token budget with pad rows of
        slot ``max_batch_size``, the spare all-scratch table row (their
        writes land in scratch block 0, their reads see only it)."""
        nb, mb, budget = (self.scfg.max_batch_size, self.max_blocks,
                          self._chunk_budget)
        bt = np.zeros((nb + 1, mb), np.int32)    # row nb: pad/scratch row
        toks = np.zeros((budget,), np.int64)
        pos = np.zeros((budget,), np.int32)
        slots = np.full((budget,), nb, np.int32)
        for seq in table_seqs:
            bt[seq.slot, :len(seq.block_table)] = seq.block_table
        for r, (sl, tk, p) in enumerate(rows):
            slots[r], toks[r], pos[r] = sl, tk, p
        dev = self.device
        # the step's runs of one sequence, found once for every layer and
        # copied with the step's other inputs, before any kernel runs
        runs = chunked_runs(bt[slots], pos, self.block_size)
        runs.on(dev)
        logits = self._mixed_impl(
            torch.from_numpy(bt).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(slots).to(dev), torch.from_numpy(toks).to(dev),
            runs)
        self.stats["mixed_steps"] += 1
        return self._sample(logits).cpu().numpy()   # host fetch

    def _mixed_impl(self, bt, pos, slots, toks, runs) -> torch.Tensor:
        cache = [ChunkedLayerCache(*self._pools[i], bt, slots, pos,
                                   self.block_size, runs)
                 for i in range(self.model_cfg.num_layers)]
        pos_ids = torch.clamp(pos.long(), max=self.model_cfg.max_seq_len - 1)
        out = self.module(toks[None, :], position_ids=pos_ids[None, :],
                          cache=cache)
        return out["logits"][0].float()                          # [T, V]
