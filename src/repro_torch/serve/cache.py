"""The paged KV cache: slots and pages as allocatable resources.

The twin of the paged half of ``repro.serve.cache``. Attention K/V live
in a global pool of fixed-size **pages** (per layer ``[n_blocks,
block_size, KV, hd]``) handed out by a :class:`BlockAllocator`; each
slot maps logical block *l* to a physical page through its row of the
**block table** (``[B, blocks_per_slot]`` int32). KV memory is then
proportional to actual sequence length, not to ``max_seq``.

Freed pages are **zeroed before reuse**. Swap preemption and the
contiguous per-slot layout are not ported yet.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as lm


class NoFreeBlocks(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the pool is exhausted."""


class BlockAllocator:
    """Host-side free list over a fixed pool of KV pages.

    Invariants: a page has at most one holder; ``n_free + outstanding
    == n_blocks``; double-free raises.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        self.n_blocks = n_blocks
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))  # lowest ids first
        self._held = np.zeros((n_blocks,), bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Claim ``n`` pages (all or nothing). Raises :class:`NoFreeBlocks`
        if fewer than ``n`` are free — the pool is left untouched."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            raise NoFreeBlocks(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._held[out] = True
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Return pages to the pool. Double-free raises, including a
        duplicate id within one call."""
        blocks = list(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate page ids in free: {blocks}")
        for b in blocks:
            if not self._held[b]:
                raise ValueError(f"page {b} already free")
        self._held[blocks] = False
        self._free.extend(blocks)
        self._free.sort(reverse=True)


class PagedCacheManager:
    """Slots + a paged KV pool + the block-table plane.

    * :meth:`alloc` / :meth:`free` — claim a slot; release it with its
      pages, zeroing the pages **eagerly** (they can be handed to another
      slot within the same engine tick);
    * :meth:`ensure` — grow a slot's block table to cover a target
      length, allocating pages on demand (``False`` when the pool can't
      cover it — the engine then preempts a victim and retries);
    * :attr:`block_tables` — the host ``[n_slots, blocks_per_slot]``
      int32 table handed to each step; unassigned entries are 0, a valid
      page that per-slot causal masking fences.

    Args:
      cfg: model config.
      n_slots: batch capacity B.
      max_seq: tokens per slot (prompt + generation must fit).
      block_size: tokens per KV page.
      n_blocks: pool size in pages.
      dtype: pool dtype (fp32 default, as in the JAX engine).
      device: where the pools live.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        n_slots: int,
        max_seq: int,
        *,
        block_size: int,
        n_blocks: int,
        dtype=torch.float32,
        device="cuda",
    ):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.blocks_per_slot = -(-max_seq // block_size)
        self.cache = lm.init_paged_cache(cfg, n_blocks, block_size, dtype=dtype, device=device)
        self.pos = np.zeros((n_slots,), np.int32)
        self.block_tables = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self.n_table_blocks = np.zeros((n_slots,), np.int32)
        self.allocator = BlockAllocator(n_blocks)
        self._free_slots: list[int] = list(range(n_slots - 1, -1, -1))

    @property
    def n_free(self) -> int:
        """Free slots available to admission."""
        return len(self._free_slots)

    @property
    def n_free_blocks(self) -> int:
        """Free pages in the pool (the admission gate)."""
        return self.allocator.n_free

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to cache ``n_tokens`` tokens."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self) -> int:
        """Claim a free slot (lowest id first) with an empty block table."""
        if not self._free_slots:
            raise RuntimeError("no free slots")
        slot = self._free_slots.pop()
        self.pos[slot] = 0
        self.block_tables[slot] = 0
        self.n_table_blocks[slot] = 0
        return slot

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s block table to cover ``n_tokens`` tokens;
        ``False`` (pool untouched) if the free list can't cover it."""
        need = self.blocks_for(n_tokens)
        if need > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens need {need} pages > "
                f"blocks_per_slot {self.blocks_per_slot}"
            )
        have = int(self.n_table_blocks[slot])
        if need <= have:
            return True
        try:
            pages = self.allocator.alloc(need - have)
        except NoFreeBlocks:
            return False
        self.block_tables[slot, have:need] = pages
        self.n_table_blocks[slot] = need
        return True

    def free(self, slot: int) -> None:
        """Release ``slot`` and its pages; zero the pages now."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} already free")
        n = int(self.n_table_blocks[slot])
        pages = self.block_tables[slot, :n].tolist()
        self.allocator.free(pages)
        self.pos[slot] = 0
        self.block_tables[slot] = 0
        self.n_table_blocks[slot] = 0
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        lm.reset_paged(self.cache, pages)
