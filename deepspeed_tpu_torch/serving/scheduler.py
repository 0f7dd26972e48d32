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
- **Prefix reuse** (``serving.prefix_cache``): a ref-counted trie over
  full prompt-head blocks keyed by their token content. A request whose
  prompt head matches adopts the cached blocks (shared blocks are
  immutable: every write lands past the adopter's ``shared_len``) and
  only the tail is prefilled. Cache-held blocks survive completion and
  preemption (the cache holds its own pool reference); under pool
  pressure the cache drops least-recently-used leaves before any running
  sequence is preempted.
"""

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

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
    # Absolute monotonic deadline (``serving.resilience``): past it the
    # request is aborted at the next step boundary with status
    # ``deadline_expired``. None = no limit.
    deadline: Optional[float] = None


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
    # Prompt positions [0, shared_len) adopted from the prefix cache (a
    # whole-block multiple; 0 = cold): only the tail is prefilled.
    shared_len: int = 0
    # Chunked-prefill cursor: prompt positions [0, prefilled) have their
    # KV written (the bucketed path never reads it).
    prefilled: int = 0

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


class _PrefixNode:
    """One cached prompt-head block: a trie edge keyed by the block's token
    content (the exact tuple, so no hash collision is possible)."""

    __slots__ = ("block", "children", "last_use", "parent", "key")

    def __init__(self, block: int, parent, key):
        self.block = block
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.last_use = 0
        self.parent = parent
        self.key = key


class PrefixCache:
    """Ref-counted prompt-head trie over KV pool blocks.

    Nodes are **full** prompt blocks only (a partial tail block mixes
    prompt K/V with later decode writes), and a match is capped one token
    short of the prompt, so the adopter always prefills at least one tail
    token (the first token's logits come from a real forward). Each node
    holds its own pool reference (``BlockPool.share``), so a warm head
    outlives the sequence that made it.
    """

    def __init__(self, pool: BlockPool, block_size: int):
        self.pool = pool
        self.block_size = int(block_size)
        self._root_children: Dict[Tuple[int, ...], _PrefixNode] = {}
        self.nodes = 0
        self.hits = 0                 # requests that adopted >= 1 block
        self.blocks_reused = 0        # running total of adopted blocks

    def _chunks(self, prompt: List[int], limit: int):
        bs = self.block_size
        for i in range(limit):
            yield i, tuple(prompt[i * bs:(i + 1) * bs])

    def match(self, prompt: List[int], step: int) -> List[int]:
        """Longest cached head as a block list, each block incref'd for
        the caller (who releases them on any failure path). Capped at
        ``(len(prompt) - 1) // block_size`` blocks. The hit counters move
        only in :meth:`commit_hit`: a blocked head-of-queue request
        re-matches every step."""
        children = self._root_children
        blocks: List[int] = []
        for _i, chunk in self._chunks(prompt,
                                      (len(prompt) - 1) // self.block_size):
            node = children.get(chunk)
            if node is None:
                break
            node.last_use = step
            blocks.append(node.block)
            children = node.children
        if blocks:
            self.pool.share(blocks)
        return blocks

    def commit_hit(self, n_blocks: int) -> None:
        """Record one adoption (after the matched request is admitted)."""
        if n_blocks:
            self.hits += 1
            self.blocks_reused += n_blocks

    def insert(self, prompt: List[int], block_table: List[int],
               step: int) -> None:
        """Register a prefilled sequence's full prompt blocks. Existing
        nodes are refreshed (LRU); new ones take a cache-owned reference
        on the sequence's block. The first writer wins a key collision."""
        children = self._root_children
        parent = None
        for i, chunk in self._chunks(prompt,
                                     len(prompt) // self.block_size):
            node = children.get(chunk)
            if node is None:
                block = block_table[i]
                self.pool.share([block])
                node = _PrefixNode(block, parent, chunk)
                children[chunk] = node
                self.nodes += 1
            node.last_use = step
            parent = node
            children = node.children

    def _leaves(self) -> List[_PrefixNode]:
        out = []
        stack = list(self._root_children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _drop(self, node: _PrefixNode) -> None:
        owner = (node.parent.children if node.parent is not None
                 else self._root_children)
        del owner[node.key]
        self.nodes -= 1
        self.pool.release([node.block])

    def evict(self, need_free: int) -> int:
        """Free at least ``need_free`` pool blocks by dropping
        least-recently-used leaves (trie paths stay contiguous from the
        root). Only leaves nobody else holds are dropped: a leaf co-held
        by a running sequence would free nothing now. Returns the blocks
        freed."""
        freed = 0
        while freed < need_free:
            sole = [n for n in self._leaves()
                    if self.pool.refcount(n.block) == 1]
            if not sole:
                break
            before = self.pool.free_blocks
            self._drop(min(sole, key=lambda n: n.last_use))
            freed += self.pool.free_blocks - before
        return freed

    def clear(self) -> None:
        """Drop every cached node (releases all cache-held references):
        with no sequence running, a cleared cache leaves the pool free."""
        while self.nodes:
            for node in self._leaves():
                self._drop(node)


class Scheduler:
    """Slot + block bookkeeping for one serving engine."""

    def __init__(self, num_slots: int, pool: BlockPool, block_size: int,
                 prefix_cache: Optional[PrefixCache] = None):
        self.num_slots = int(num_slots)
        self.pool = pool
        self.block_size = int(block_size)
        self.prefix_cache = prefix_cache
        self.waiting: Deque[Request] = collections.deque()
        self.running: Dict[int, Sequence] = {}            # slot -> seq
        self._free_slots: List[int] = list(range(self.num_slots))[::-1]
        # Admission-level batch cap (<= num_slots): the degradation ladder
        # (serving/resilience.py) halves it; slots above it stay empty.
        self.slot_cap = int(num_slots)
        self._ids = itertools.count()
        self.preempted_total = 0
        # The request accountant (telemetry/requests.py), set by the engine
        # so admission and preemption mark the per-request ledger. None:
        # off.
        self.accountant = None

    # -- submission -----------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None) -> int:
        rid = next(self._ids)
        self.waiting.append(Request(rid, list(prompt), int(max_new_tokens),
                                    eos_token_id))
        return rid

    def reserve_rid(self) -> int:
        """Draw the next request id without queueing anything: a shed
        request still gets a real rid and a terminal record."""
        return next(self._ids)

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
        covers its prompt bucket (less any head adopted from the prefix
        cache); returns the new Sequence (blocks allocated, not yet
        prefilled) or None."""
        if not self.waiting or not self._free_slots:
            return None
        if len(self.running) >= self.slot_cap:
            return None
        req = self.waiting[0]
        bucket = bucket_of(len(req.prompt))
        shared: List[int] = []
        if self.prefix_cache is not None:
            shared = self.prefix_cache.match(req.prompt, step)
        n_shared = len(shared)
        if req.preempted_count:
            # Already evicted once: re-admit only when its WHOLE remaining
            # run fits in free blocks (the last sampled token writes no
            # KV), else admit/prefill/evict would thrash. Adopted blocks
            # need no free blocks.
            lifetime = max(bucket, len(req.prompt) + req.max_new_tokens - 1)
            need = -(-lifetime // self.block_size) - n_shared
            if self.pool.free_blocks < need:
                if shared:
                    self.pool.release(shared)
                return None
        tail_n = bucket // self.block_size - n_shared
        blocks = self.pool.alloc(tail_n)
        if blocks is None and self.prefix_cache is not None:
            # Cold cache entries yield to live admissions before any
            # running sequence would be preempted.
            self.prefix_cache.evict(tail_n - self.pool.free_blocks)
            blocks = self.pool.alloc(tail_n)
        if blocks is None:
            if shared:
                self.pool.release(shared)
            return None
        self.waiting.popleft()
        slot = self._free_slots.pop()
        if self.prefix_cache is not None:
            self.prefix_cache.commit_hit(n_shared)
        seq = Sequence(request=req, slot=slot, bucket=bucket,
                       block_table=shared + blocks, tokens=list(req.prompt),
                       pos=len(req.prompt), admitted_step=step,
                       shared_len=n_shared * self.block_size)
        self.running[slot] = seq
        if req.admitted_time is None:
            req.admitted_time = time.monotonic()
        if self.accountant is not None:
            self.accountant.on_admit(seq)
        return seq

    def register_prefix(self, seq: Sequence, step: int) -> None:
        """After a completed prefill: make this sequence's full prompt
        blocks adoptable by later requests (no-op without a cache)."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(seq.request.prompt, seq.block_table,
                                     step)

    # -- growth / preemption -------------------------------------------
    def ensure_capacity(self, seq: Sequence, lookahead: int = 0) -> bool:
        """Make sure ``seq`` can write its next token (``seq.pos``) plus
        ``lookahead`` further positions (a speculative round's verify chunk
        writes ``pos..pos+k``), capped at the last position it can ever
        write: overshoot past that lands in scratch and needs no block.
        Allocates a block when the write crosses into uncovered territory,
        dropping cold prefix-cache leaves first and then evicting the
        YOUNGEST running sequence (possibly ``seq`` itself) when the pool
        is dry, so the oldest sequence always completes. Returns False
        when ``seq`` was the youngest and got evicted."""
        target = min(seq.pos + lookahead, seq.last_write_pos)
        while target >= len(seq.block_table) * self.block_size:
            got = self.pool.alloc(1)
            if got is None and self.prefix_cache is not None \
                    and self.prefix_cache.evict(1):
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
        """Evict: release blocks + slot (cache-held head blocks stay with
        the cache), requeue the ORIGINAL request at the front (it restarts
        from its prompt, or its cached head, on re-admission)."""
        self._release(seq)
        seq.request.preempted_count += 1
        self.waiting.appendleft(seq.request)
        self.preempted_total += 1
        if self.accountant is not None:
            self.accountant.on_preempt(seq)

    # -- completion -----------------------------------------------------
    def finish(self, seq: Sequence) -> None:
        self._release(seq)

    def abort(self, seq: Sequence) -> None:
        """Terminal eviction (``deadline_expired`` / ``cancelled`` /
        ``aborted``): release slot and blocks exactly once, no requeue;
        the caller writes the terminal record."""
        self._release(seq)

    def _release(self, seq: Sequence) -> None:
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)
        self.pool.release(seq.block_table)
        seq.block_table = []
