"""Continuous-batching serving: paged KV cache, scheduler, engine,
speculative decoding and resilience."""

from deepspeed_tpu_torch.serving.engine import ServeEngine
from deepspeed_tpu_torch.serving.kv_cache import (BlockPool,
                                                  ChunkedLayerCache,
                                                  PagedLayerCache,
                                                  init_paged_pools,
                                                  pack_prefill)
from deepspeed_tpu_torch.serving.resilience import (TERMINAL_STATUSES,
                                                    ResilienceManager)
from deepspeed_tpu_torch.serving.scheduler import (PrefixCache, Request,
                                                   Scheduler, Sequence)

__all__ = ["ServeEngine", "BlockPool", "ChunkedLayerCache",
           "PagedLayerCache", "init_paged_pools", "pack_prefill",
           "PrefixCache", "Request", "ResilienceManager", "Scheduler",
           "Sequence", "TERMINAL_STATUSES"]
