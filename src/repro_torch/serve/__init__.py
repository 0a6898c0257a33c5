"""Continuous-batching serving (PyTorch port of ``repro.serve``).

Layout::

  request.py    request record + lifecycle states + SamplingParams
  cache.py      SlotCacheManager (contiguous rows per slot) /
                PagedCacheManager (page pool + block tables, swap to the
                host) / BlockAllocator (free list) / SwappedSlot
  scheduler.py  ServeConfig + token-budget prefill/decode packing,
                free-page-gated admission, speculative widths
  engine.py     ContinuousBatchingEngine — the serving loop, sampling,
                preemption (recompute / swap), speculative decoding,
                streaming
  lockstep.py   the static lock-step baseline and parity oracle
  workload.py   Poisson and long-tail workload generators

The dense family only; the other families are not ported yet.
"""
from repro_torch.serve.cache import (
    BlockAllocator,
    NoFreeBlocks,
    PagedCacheManager,
    SlotCacheManager,
    SwappedSlot,
)
from repro_torch.serve.engine import ContinuousBatchingEngine, TokenEvent
from repro_torch.serve.lockstep import generate_lockstep, generate_reference, lockstep_waves
from repro_torch.serve.request import (
    DECODE,
    FINISHED,
    PREFILL,
    WAITING,
    Request,
    SamplingParams,
)
from repro_torch.serve.scheduler import Scheduler, ServeConfig
from repro_torch.serve.workload import longtail_workload, poisson_workload

__all__ = [
    "BlockAllocator",
    "ContinuousBatchingEngine",
    "NoFreeBlocks",
    "PagedCacheManager",
    "SlotCacheManager",
    "SwappedSlot",
    "Scheduler",
    "ServeConfig",
    "Request",
    "SamplingParams",
    "TokenEvent",
    "WAITING",
    "PREFILL",
    "DECODE",
    "FINISHED",
    "generate_lockstep",
    "generate_reference",
    "lockstep_waves",
    "longtail_workload",
    "poisson_workload",
]
