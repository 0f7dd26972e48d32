"""Continuous-batching scheduler: requests, sequences, admission, preemption.

The port's copy of ``deepspeed_tpu/serving/scheduler.py`` (Orca-style
iteration-level scheduling; vLLM 2309.06180): the decode batch is a fixed
set of **slots**, and scheduling happens only at decode-step boundaries. A
finished sequence's slot and KV blocks go to the next waiting request at
once. All of it is host-side Python: free lists, deques and integers.

Policies:

- **Admission**: FCFS. A request is admitted when a slot is free AND the
  block pool covers its whole prompt bucket (never a partial grant).
- **Growth**: a decode write that crosses a block boundary takes one new
  block at the step boundary, before the write.
- **Preemption**: when growth finds the pool empty, the **youngest**
  running sequence is evicted: its blocks are released and its request
  goes back to the FRONT of the queue (it restarts from its prompt; under
  greedy decoding the output is the same). The oldest sequence therefore
  always completes. An evicted request re-admits only when its WHOLE
  remaining run fits in free blocks, so it cannot thrash.

The JAX package's prefix cache is not ported yet (``serving.prefix_cache``
raises).
"""

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from deepspeed_tpu_torch.serving.kv_cache import BlockPool


@dataclass
class Request:
    """One generation request as submitted."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival: float = field(default_factory=time.monotonic)
    # Set at the request's FIRST prefill and kept across preemption
    # restarts: TTFT is when the first token was ever produced.
    first_token_time: Optional[float] = None
    # Times this request was evicted for KV pressure: a nonzero count
    # switches its re-admission to the full-lifetime gate.
    preempted_count: int = 0
    # Set at the request's FIRST admission and kept across restarts.
    admitted_time: Optional[float] = None


@dataclass
class Sequence:
    """A running request: its slot, block table and progress."""

    request: Request
    slot: int
    bucket: int                       # prefill bucket (cache positions 0..)
    block_table: List[int] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)   # prompt + generated
    pos: int = 0                      # next cache write index
    admitted_step: int = 0

    @property
    def last_write_pos(self) -> int:
        """Highest cache position this sequence can ever write: the LAST
        sampled token's KV is never written (the run ends on it)."""
        return len(self.request.prompt) + self.request.max_new_tokens - 2

    @property
    def generated(self) -> int:
        return len(self.tokens) - len(self.request.prompt)

    def finished(self) -> bool:
        if self.generated >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_token_id
        return (eos is not None and self.generated > 0
                and self.tokens[-1] == eos)


class Scheduler:
    """Slot + block bookkeeping for one serving engine."""

    def __init__(self, num_slots: int, pool: BlockPool, block_size: int):
        self.num_slots = int(num_slots)
        self.pool = pool
        self.block_size = int(block_size)
        self.waiting: Deque[Request] = collections.deque()
        self.running: Dict[int, Sequence] = {}            # slot -> seq
        self._free_slots: List[int] = list(range(self.num_slots))[::-1]
        self._ids = itertools.count()
        self.preempted_total = 0

    # -- submission -----------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None) -> int:
        rid = next(self._ids)
        self.waiting.append(Request(rid, list(prompt), int(max_new_tokens),
                                    eos_token_id))
        return rid

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active(self) -> List[Sequence]:
        return [self.running[s] for s in sorted(self.running)]

    def idle(self) -> bool:
        return not self.waiting and not self.running

    # -- admission ------------------------------------------------------
    def try_admit(self, bucket_of, step: int) -> Optional[Sequence]:
        """Admit the head-of-queue request if a slot is free and the pool
        covers its prompt bucket; returns the new Sequence (blocks
        allocated, not yet prefilled) or None."""
        if not self.waiting or not self._free_slots:
            return None
        req = self.waiting[0]
        bucket = bucket_of(len(req.prompt))
        if req.preempted_count:
            # Already evicted once: re-admit only when its WHOLE remaining
            # run fits in free blocks (the last sampled token writes no
            # KV), else admit/prefill/evict would thrash.
            lifetime = max(bucket, len(req.prompt) + req.max_new_tokens - 1)
            if self.pool.free_blocks < -(-lifetime // self.block_size):
                return None
        blocks = self.pool.alloc(bucket // self.block_size)
        if blocks is None:
            return None
        self.waiting.popleft()
        slot = self._free_slots.pop()
        seq = Sequence(request=req, slot=slot, bucket=bucket,
                       block_table=blocks, tokens=list(req.prompt),
                       pos=len(req.prompt), admitted_step=step)
        self.running[slot] = seq
        if req.admitted_time is None:
            req.admitted_time = time.monotonic()
        return seq

    # -- growth / preemption -------------------------------------------
    def ensure_capacity(self, seq: Sequence) -> bool:
        """Make sure ``seq`` can write its next token (``seq.pos``), capped
        at the last position it can ever write. Allocates a block when the
        write crosses into uncovered territory, evicting the YOUNGEST
        running sequence (possibly ``seq`` itself) when the pool is dry,
        so the oldest sequence always completes. Returns False when
        ``seq`` was the youngest and got evicted."""
        target = min(seq.pos, seq.last_write_pos)
        while target >= len(seq.block_table) * self.block_size:
            got = self.pool.alloc(1)
            if got is not None:
                seq.block_table.extend(got)
                continue
            victim = self._youngest()
            if victim is seq and len(self.running) == 1:
                raise RuntimeError(
                    f"KV block pool exhausted: request {seq.request.rid} "
                    f"needs a block and there is no other sequence to "
                    f"preempt; the pool ({self.pool.capacity} blocks of "
                    f"{self.block_size}) cannot hold even one max-length "
                    f"sequence; raise serving.kv_num_blocks")
            self.preempt(victim)
            if victim is seq:
                return False
        return True

    def _youngest(self) -> Sequence:
        """Latest-admitted running sequence (ties broken by request id:
        the larger rid entered the queue later)."""
        return max(self.running.values(),
                   key=lambda s: (s.admitted_step, s.request.rid))

    def preempt(self, seq: Sequence) -> None:
        """Evict: release blocks + slot, requeue the ORIGINAL request at
        the front (it restarts from its prompt on re-admission)."""
        self._release(seq)
        seq.request.preempted_count += 1
        self.waiting.appendleft(seq.request)
        self.preempted_total += 1

    # -- completion -----------------------------------------------------
    def finish(self, seq: Sequence) -> None:
        self._release(seq)

    def _release(self, seq: Sequence) -> None:
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)
        self.pool.release(seq.block_table)
        seq.block_table = []
