"""Cache managers: slots and KV pages as allocatable resources.

The twin of ``repro.serve.cache``. Two memory planes:

* :class:`SlotCacheManager` — the contiguous layout: per attention
  layer K/V rows ``[B, max_seq, KV, hd]``, so slot *b* owns ``max_seq``
  rows whatever its request's length.
* :class:`PagedCacheManager` — the paged layout: K/V live in a global
  pool of fixed-size **pages** (per attention layer ``[n_blocks + 1,
  block_size, KV, hd]``, the last page the steps' sink) handed out by a
  :class:`BlockAllocator`; each slot maps logical block *l* to a
  physical page through its row of the **block table** (``[B,
  blocks_per_slot]`` int32). KV memory is then proportional to actual
  sequence length.

Either way an SSM layer keeps its conv window and state as a row per
slot (``[B, ...]``), cleared when the slot gets a new occupant.

Both own the cache, the free lists and the host-side per-slot positions.
Freed state is **zeroed before reuse**. The paged manager also supports
**swap preemption**: :meth:`PagedCacheManager.swap_out` stages one
slot's pages and SSM rows in host memory (:class:`SwappedSlot`, pinned when the cache
is on the card) and :meth:`PagedCacheManager.swap_in` restores them into
fresh pages — the eviction that stays exact for sampled requests.
"""
from __future__ import annotations

from collections.abc import Iterable, Sequence
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as lm


@dataclasses.dataclass
class SwappedSlot:
    """One slot's cache state staged on the host by
    :meth:`PagedCacheManager.swap_out`: ``data`` mirrors the cache (per
    attention layer the K/V of the slot's pages, ``[n_pages, bs, KV, hd]``
    host tensors; per SSM layer the slot's conv window and state), ``pos``
    the slot's write position at eviction, ``n_pages`` the page count to
    allocate again at swap-in."""

    pos: int
    n_pages: int
    data: Any  # list of per-layer {"k", "v"} or {"conv", "state"} host tensors

    @property
    def nbytes(self) -> int:
        """Host bytes staged (the engine's ``swapped_bytes``)."""
        return int(sum(t.numel() * t.element_size() for layer in self.data for t in layer.values()))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a pinned copy when it is on the card, itself
    (already a gathered copy) when it is on the CPU."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class SlotCacheManager:
    """Allocate and free contiguous cache rows per request.

    Args:
      cfg: model config.
      n_slots: batch capacity B, one row set a slot.
      max_seq: rows a slot (prompt + generation must fit).
      dtype: cache dtype (fp32 default, as in the JAX engine).
      device: where the cache lives.
      mesh: a ``data x model`` mesh: the rank holds its shard
        (``lm.cache_layout``: its slots' rows where the data size divides
        the slots, else every slot and, where the fitted spec puts
        ``data`` there, its slice of the sequence; its KV heads). The
        free list and the positions are every slot's, the same on every
        rank.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int, *,
                 dtype=torch.float32, device="cuda", mesh=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.layout = lm.cache_layout(cfg, mesh, n_slots, max_seq)
        self.cache = lm.init_local_cache(cfg, self.layout, mesh, max_seq=max_seq, dtype=dtype,
                                         device=device)
        self.pos = np.zeros((n_slots,), np.int32)  # per-slot write offset
        self._free: list[int] = list(range(n_slots - 1, -1, -1))

    @property
    def n_free(self) -> int:
        """Free slots available to admission."""
        return len(self._free)

    def alloc(self) -> int:
        """Claim a free slot (lowest id first). Raises when full."""
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop()
        self.pos[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Return a slot; its rows are zeroed at the next :meth:`reset`."""
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self.pos[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)

    def reset(self, slots: Iterable[int]) -> None:
        """Zero the cache rows of ``slots``."""
        slots = list(slots)
        if not slots:
            return
        mask = np.zeros((self.n_slots,), bool)
        mask[slots] = True
        lm.reset_slots(self.cache, self.layout.rows(mask))


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
    """Slots + a paged KV pool + the block-table plane, behind the
    interface of :class:`SlotCacheManager` (``alloc`` / ``free`` /
    ``reset`` / ``pos`` / ``cache`` / ``n_free``).

    * :meth:`alloc` / :meth:`free` — claim a slot; release it with its
      pages, zeroing the pages **eagerly** (they can be handed to another
      slot within the same engine tick);
    * :meth:`ensure` — grow a slot's block table to cover a target
      length, allocating pages on demand (``False`` when the pool can't
      cover it — the engine then preempts a victim and retries);
      :meth:`trim` shrinks it back (speculative rollback);
    * :meth:`swap_out` / :meth:`swap_in` — stage a slot's pages on the
      host and restore them into fresh pages;
    * :attr:`block_tables` — the host ``[n_slots, blocks_per_slot]``
      int32 table handed to each step; unassigned entries are 0, a valid
      page that per-slot causal masking fences;
    * the pools' last page, past the ``n_blocks`` the allocator hands
      out, is the sink where a step writes its invalid tokens
      (``lm.init_paged_cache``); it is zeroed with every page this
      manager zeroes, so an idle pool is all zeros.

    Every write to the pools is in place: they keep their memory for the
    manager's life, which a captured step relies on.

    Args:
      cfg: model config.
      n_slots: batch capacity B.
      max_seq: tokens per slot (prompt + generation must fit).
      block_size: tokens per KV page.
      n_blocks: pool size in pages.
      dtype: pool dtype (fp32 default, as in the JAX engine).
      device: where the pools live.
      mesh: a ``data x model`` mesh: each rank's pool holds its KV heads
        and every page (the page axis replicated over ``data``: each step
        writes every data rank's new rows into every replica, so the pools
        stay equal), its SSM rows its slots' where the data size divides
        the slots (``lm.cache_layout``); the block tables, the allocator
        and the swaps' host bookkeeping are the same on every rank, and a
        swap stages the rank's own heads, the slot's SSM rows taken from
        the data rank that holds them.
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
        mesh=None,
    ):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.blocks_per_slot = -(-max_seq // block_size)
        self.mesh = mesh
        self.layout = lm.cache_layout(cfg, mesh, n_slots, max_seq, paged=True)
        self.cache = lm.init_local_cache(cfg, self.layout, mesh, n_blocks=n_blocks,
                                         block_size=block_size, dtype=dtype, device=device)
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
        self._zero(slots=[slot], pages=pages)

    def trim(self, slot: int, n_tokens: int) -> None:
        """Shrink ``slot``'s block table to cover only ``n_tokens`` tokens.

        The speculative rollback: a verify step ensures pages for its
        whole ``k+1``-token chunk, but only the accepted prefix is
        committed, so pages past ``blocks_for(n_tokens)`` hold nothing
        but rejected draft writes. They go back to the pool, zeroed now
        (as at :meth:`free`). A no-op when the committed length still
        needs every page."""
        keep = self.blocks_for(n_tokens)
        have = int(self.n_table_blocks[slot])
        if keep >= have:
            return
        pages = self.block_tables[slot, keep:have].tolist()
        self.allocator.free(pages)
        self.block_tables[slot, keep:have] = 0
        self.n_table_blocks[slot] = keep
        self._zero(slots=[], pages=pages)

    def reset(self, slots: Iterable[int]) -> None:
        """Zero the per-slot state (the SSM rows) of ``slots``. Pages are
        zeroed at :meth:`free` already."""
        self._zero(slots=list(slots), pages=[])

    def swap_out(self, slot: int) -> SwappedSlot:
        """Stage ``slot``'s pages and SSM rows on the host and release the
        slot and its pages (zeroed, as at :meth:`free`). The returned bundle
        restores the exact device state through :meth:`swap_in`; the
        position is kept, so the per-position PRNG lane of a sampled
        request draws the same stream."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} already free")
        n = int(self.n_table_blocks[slot])
        pages = self.block_tables[slot, :n].copy()
        pos = int(self.pos[slot])
        data = [{k: _to_host(t) for k, t in layer.items()}
                for layer in lm.swap_out_slot(self.cache, slot, pages, layout=self.layout,
                                              mesh=self.mesh)]
        self.free(slot)
        return SwappedSlot(pos=pos, n_pages=n, data=data)

    def swap_in(self, slot: int, swapped: SwappedSlot) -> bool:
        """Restore a :meth:`swap_out` bundle into (freshly reset)
        ``slot``: allocate ``swapped.n_pages`` fresh pages (their ids may
        differ from eviction time), write the bundle there and restore the
        position. ``False``, the pool untouched, if the pages are not
        free — admission gates on them, so that is an engine bug."""
        try:
            pages = self.allocator.alloc(swapped.n_pages)
        except NoFreeBlocks:
            return False
        self.block_tables[slot, : swapped.n_pages] = pages
        self.n_table_blocks[slot] = swapped.n_pages
        self.pos[slot] = swapped.pos
        lm.swap_in_slot(self.cache, swapped.data, slot, pages, layout=self.layout)
        return True

    def _zero(self, *, slots: Sequence[int], pages: Sequence[int]) -> None:
        if not slots and not pages:
            return
        slot_mask = np.zeros((self.n_slots,), bool)
        slot_mask[list(slots)] = True
        page_mask = np.zeros((self.n_blocks + 1,), bool)
        page_mask[list(pages)] = True
        page_mask[self.n_blocks] = bool(pages)  # the sink
        lm.reset_paged(self.cache, self.layout.rows(slot_mask), page_mask)

    def page_view(self, page: int) -> list[torch.Tensor]:
        """Host copies of one page's K and V at every attention layer
        (tests and debugging)."""
        return [layer[k][page].cpu() for layer in self.cache if "k" in layer for k in ("k", "v")]
