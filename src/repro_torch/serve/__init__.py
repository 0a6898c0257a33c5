"""Continuous-batching serving over the paged KV cache (PyTorch port).

Layout::

  request.py    request record + lifecycle states + SamplingParams
  cache.py      PagedCacheManager (page pool + block tables) /
                BlockAllocator (free list)
  scheduler.py  ServeConfig + token-budget prefill/decode packing,
                free-page-gated admission
  engine.py     ContinuousBatchingEngine — the serving loop + streaming
  workload.py   Poisson staggered-arrival workload generator

Greedy requests only; recompute preemption only. Sampling, swap
preemption, speculative decoding, the contiguous cache and the
lock-step baseline are not ported yet.
"""
from repro_torch.serve.cache import BlockAllocator, NoFreeBlocks, PagedCacheManager
from repro_torch.serve.engine import ContinuousBatchingEngine, TokenEvent
from repro_torch.serve.request import (
    DECODE,
    FINISHED,
    PREFILL,
    WAITING,
    Request,
    SamplingParams,
)
from repro_torch.serve.scheduler import Scheduler, ServeConfig
from repro_torch.serve.workload import poisson_workload

__all__ = [
    "BlockAllocator",
    "ContinuousBatchingEngine",
    "NoFreeBlocks",
    "PagedCacheManager",
    "Scheduler",
    "ServeConfig",
    "Request",
    "SamplingParams",
    "TokenEvent",
    "WAITING",
    "PREFILL",
    "DECODE",
    "FINISHED",
    "poisson_workload",
]
