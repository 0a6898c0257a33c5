"""Token-budget scheduler: interleave chunked prefill with decode.

The port's own copy of ``repro.serve.scheduler``. Each engine step the
scheduler packs work into the batch under a token budget:

* every decoding slot gets 1 token, so running requests are never
  starved by arrivals;
* the remaining budget goes to prefilling slots (oldest arrival first)
  in chunks of up to ``prefill_chunk`` prompt tokens.

Admission is FIFO by (arrival, rid), and under the paged cache also
gated on the free-page count: a request is admitted only while the pool
holds enough free pages for its prefill context (for a swapped-out
request, the page count of its staged cache), and a shortfall blocks the
whole queue. Generation growth is not reserved; the engine preempts the
youngest running request when the pool runs dry.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.request import Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine/scheduler configuration (the same fields and checks as the
    JAX package's, but for ``attn_kernel``'s default).

    Attributes:
      max_slots: batch capacity B — concurrent requests in flight.
      max_seq: cache tokens per slot (prompt + generation must fit).
      prefill_chunk: max prompt tokens one slot absorbs per step (also
        the widest step width C).
      token_budget: max total tokens per engine step; 0 means
        ``max_slots + prefill_chunk``.
      block_size: tokens per KV page; > 0 selects the paged cache.
      n_blocks: page-pool size; 0 sizes the pool to the contiguous
        layout (``max_slots * ceil(max_seq / block_size)`` pages).
      decode_widths: extra step widths below ``prefill_chunk``; a step
        runs at the smallest width that fits its largest chunk.
      attn_kernel: attend through the paged-attention kernel (pages read
        in place) instead of the per-layer gather. Requires the paged
        cache. Unlike the JAX package's it defaults to the cache: ``None``
        resolves to on with the paged cache, off with the contiguous one.
      preempt: pool-exhaustion eviction strategy (paged cache):
        "recompute" re-prefills the victim's token history (exact for
        greedy requests only, which ``Request.preempt`` enforces), "swap"
        stages its pages on the host, "auto" (default) swaps sampled
        requests and recomputes greedy ones.
      spec_k: draft tokens proposed per decode slot (speculative
        decoding; 0 = off). A decoding slot is planned a ``1 + spec_k``
        chunk (the last committed token and k proposals), verified in one
        step; the stream is the same as with ``spec_k = 0``. The chunk
        must fit a step width (``spec_k + 1 <= prefill_chunk``); add
        ``spec_k + 1`` to ``decode_widths`` to run it unpadded.
    """

    max_slots: int
    max_seq: int
    prefill_chunk: int = 8
    token_budget: int = 0
    block_size: int = 0
    n_blocks: int = 0
    decode_widths: tuple[int, ...] = (1, 4)
    attn_kernel: bool | None = None
    preempt: str = "auto"
    spec_k: int = 0

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.token_budget < 0:
            raise ValueError("token_budget must be >= 0 (0 = default)")
        if self.block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = contiguous)")
        if self.n_blocks < 0:
            raise ValueError("n_blocks must be >= 0 (0 = default pool)")
        if self.n_blocks and not self.block_size:
            raise ValueError("n_blocks requires block_size > 0")
        if self.attn_kernel is None:
            object.__setattr__(self, "attn_kernel", self.block_size > 0)
        if self.attn_kernel and not self.block_size:
            raise ValueError(
                "attn_kernel requires the paged cache (block_size > 0): "
                "the kernel addresses K/V through the block table"
            )
        if any(w < 1 for w in self.decode_widths):
            raise ValueError("decode_widths must be >= 1")
        if len(set(self.decode_widths)) != len(self.decode_widths):
            raise ValueError(f"decode_widths {self.decode_widths} contains duplicates")
        too_wide = [w for w in self.decode_widths if w > self.prefill_chunk]
        if too_wide:
            raise ValueError(
                f"decode_widths {too_wide} exceed prefill_chunk {self.prefill_chunk}"
            )
        if self.preempt not in ("auto", "swap", "recompute"):
            raise ValueError(
                f"unknown preemption policy {self.preempt!r}: expected "
                "'auto', 'swap' or 'recompute'"
            )
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = speculation off)")
        if self.spec_k and self.spec_k + 1 > self.prefill_chunk:
            raise ValueError(
                f"spec_k={self.spec_k} needs a {self.spec_k + 1}-wide verify "
                f"chunk but prefill_chunk={self.prefill_chunk}"
            )

    @property
    def budget(self) -> int:
        """Effective per-step token budget."""
        return self.token_budget or (self.max_slots + self.prefill_chunk)

    @property
    def paged(self) -> bool:
        """Whether the paged KV cache is enabled."""
        return self.block_size > 0

    @property
    def blocks_per_slot(self) -> int:
        """Block-table length: pages covering ``max_seq`` tokens."""
        return -(-self.max_seq // self.block_size) if self.paged else 0

    @property
    def total_blocks(self) -> int:
        """Page-pool size (0 when contiguous)."""
        if not self.paged:
            return 0
        return self.n_blocks or (self.max_slots * self.blocks_per_slot)

    @property
    def widths(self) -> tuple[int, ...]:
        """Ascending step widths (always ends at prefill_chunk)."""
        ws = {w for w in self.decode_widths if w <= self.prefill_chunk}
        ws.add(self.prefill_chunk)
        return tuple(sorted(ws))


class Scheduler:
    """Pure planning: no device state, unit-testable in isolation."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self._rr = 0  # round-robin offset for budget-limited decode

    def admit(
        self,
        waiting: list[Request],
        n_free: int,
        clock: int,
        *,
        n_free_blocks: int | None = None,
    ) -> list[Request]:
        """FIFO admission: arrived requests, up to the free-slot count.

        ``waiting`` must be sorted by (arrival, rid); returns the prefix
        to admit. With the paged cache, ``n_free_blocks`` gates each
        candidate on the pages it needs up front (its prefill context, or
        a swapped-out request's staged page count), debited as candidates
        are accepted; the first shortfall stops admission.
        """
        out = []
        blocks = n_free_blocks
        for req in waiting:
            if len(out) >= n_free or req.arrival > clock:
                break
            if self.cfg.paged and blocks is not None:
                if req.swap is not None:
                    need = req.swap.n_pages
                else:
                    need = -(-req.context_len // self.cfg.block_size)
                if need > blocks:
                    break
                blocks -= need
            out.append(req)
        return out

    def plan(self, by_slot: dict[int, Request]) -> dict[int, int]:
        """Token counts per slot for one step, under the budget.

        Decode slots first (round-robin, so a budget smaller than the
        decode count rotates fairly), then prefill chunks by arrival
        order. Slots that don't fit this step's budget are left out.

        With ``spec_k > 0`` a decoding slot is planned ``1 + spec_k``
        tokens, clamped to its remaining generation budget, to 1 for a
        ``no_spec`` request, and to the step budget.
        """
        budget = self.cfg.budget
        plan: dict[int, int] = {}
        decoding = [s for s in sorted(by_slot) if by_slot[s].remaining_prompt == 0]
        if decoding:
            off = self._rr % len(decoding)
            decoding = decoding[off:] + decoding[:off]
            self._rr += max(1, min(self.cfg.budget, len(decoding)))
        prefilling = sorted(
            (s for s in by_slot if by_slot[s].remaining_prompt > 0),
            key=lambda s: (by_slot[s].arrival, by_slot[s].rid),
        )
        for s in decoding:
            if budget < 1:
                break
            req = by_slot[s]
            n = 1
            if self.cfg.spec_k and not req.no_spec:
                remaining = req.max_new_tokens - len(req.generated)
                n = 1 + max(0, min(self.cfg.spec_k, remaining - 1))
            plan[s] = min(n, budget)
            budget -= plan[s]
        for s in prefilling:
            if budget < 1:
                break
            n = min(self.cfg.prefill_chunk, by_slot[s].remaining_prompt, budget)
            plan[s] = n
            budget -= n
        return plan
