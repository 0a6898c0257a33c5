"""The continuous-batching engine over the paged KV cache.

The twin of ``repro.serve.engine`` for greedy requests. One engine
iteration (:meth:`ContinuousBatchingEngine.step`):

1. **admission** — freed slots go to arrived waiting requests (FIFO,
   gated on free pages);
2. **planning** — the :class:`~repro_torch.serve.scheduler.Scheduler`
   packs decode tokens (1 per running slot) and chunked-prefill tokens
   under the token budget; the engine then grows each planned slot's
   block table to cover the step, and if the pool runs dry it
   **preempts** the youngest running request back to WAITING
   (recompute: its token history is prefilled again on re-admission,
   bit-exact for greedy decode) and retries;
3. **one mixed step** — :func:`repro_torch.launch.steps.make_slot_step`
   runs prefill chunks and decode tokens together at the smallest step
   width that fits;
4. **completion** — emitted tokens stream out of :meth:`step` as
   :class:`TokenEvent` s; finished requests release their slot and pages.

Not ported yet, and refused with an error: sampled requests
(temperature > 0), ``preempt="swap"``, speculative decoding
(``spec_k > 0``) and the contiguous cache (``block_size == 0``).
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.serve import request as rq
from repro_torch.serve.cache import PagedCacheManager
from repro_torch.serve.scheduler import Scheduler, ServeConfig


class TokenEvent(NamedTuple):
    """One streamed token, in slot order within a tick. ``is_last``
    marks the request's final token (its slot is already released)."""

    rid: int
    token: int
    is_last: bool


class ContinuousBatchingEngine:
    """Slot-based request scheduler over one model replica.

    Args:
      cfg: model config.
      params: model params on ``device``.
      serve_cfg: slot/chunk/budget/page configuration (paged only).
      cache_dtype: KV pool dtype (fp32 default, as in the JAX engine:
        bf16 K/V are written into fp32 pools).
      device: where the cache lives and the steps run.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig,
        *,
        cache_dtype=torch.float32,
        device="cuda",
    ):
        if not serve_cfg.paged:
            raise NotImplementedError(
                "the contiguous cache is not ported yet: set block_size > 0"
            )
        if serve_cfg.spec_k:
            raise NotImplementedError("speculative decoding (spec_k > 0) is not ported yet")
        if serve_cfg.preempt == "swap":
            raise NotImplementedError("swap preemption is not ported yet")
        self.cfg = cfg
        self.params = params
        self.serve_cfg = serve_cfg
        self.device = torch.device(device)
        self.slots = PagedCacheManager(
            cfg, serve_cfg.max_slots, serve_cfg.max_seq,
            block_size=serve_cfg.block_size,
            n_blocks=serve_cfg.total_blocks,
            dtype=cache_dtype, device=self.device,
        )
        self.scheduler = Scheduler(serve_cfg)
        self._step_fn = steps_lib.make_slot_step(cfg, paged_kernel=serve_cfg.attn_kernel)
        self.waiting: list[rq.Request] = []
        self._known_rids = set()
        self.by_slot: dict[int, rq.Request] = {}
        self.finished: dict[int, rq.Request] = {}
        self.clock = 0
        # stats
        self.compute_steps = 0
        self.idle_steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.preemptions = 0
        self.peak_concurrency = 0
        self.padded_tokens = 0  # B × width summed over compute steps
        self.step_times: list[float] = []
        self._occupancy_sum = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def submit(self, req: rq.Request) -> None:
        """Queue a request. Raises if it can never fit the cache, if its
        rid is already known, or if it samples (not ported yet)."""
        if req.rid in self._known_rids:
            raise ValueError(
                f"request {req.rid}: duplicate rid — already "
                "waiting, running or finished in this engine"
            )
        if not req.sampling.greedy:
            raise NotImplementedError(
                f"request {req.rid}: sampled decoding (temperature > 0) is not ported yet"
            )
        need = req.prompt_len + req.max_new_tokens - 1  # last token not cached
        if need > self.serve_cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+generation ({need}) exceeds "
                f"max_seq {self.serve_cfg.max_seq}"
            )
        need_blocks = -(-need // self.serve_cfg.block_size)
        if need_blocks > self.serve_cfg.total_blocks:
            raise ValueError(
                f"request {req.rid}: needs {need_blocks} pages, pool "
                f"has {self.serve_cfg.total_blocks}"
            )
        self._known_rids.add(req.rid)
        req.state = rq.WAITING
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def _admit(self) -> None:
        admitted = self.scheduler.admit(
            self.waiting, self.slots.n_free, self.clock,
            n_free_blocks=self.slots.n_free_blocks,
        )
        for req in admitted:
            self.waiting.remove(req)
            slot = self.slots.alloc()
            req.slot = slot
            req.state = rq.PREFILL
            self.by_slot[slot] = req

    # ------------------------------------------------------------------
    # paged-cache block management
    # ------------------------------------------------------------------

    def _pick_victim(self, keep: int) -> int | None:
        """Youngest running slot other than ``keep`` (max arrival, rid)."""
        cands = [s for s in self.by_slot if s != keep]
        if not cands:
            return None
        return max(
            cands, key=lambda s: (self.by_slot[s].arrival, self.by_slot[s].rid)
        )

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request back to WAITING (recompute) and free
        its slot and pages."""
        req = self.by_slot.pop(slot)
        req.preempt()
        self.slots.free(slot)
        self.preemptions += 1
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def _ensure_blocks(self, plan: dict[int, int]) -> dict[int, int]:
        """Grow block tables to cover this step's writes, oldest request
        first; preempt the youngest running request on pool exhaustion
        (evicting it from the plan) and retry."""
        order = sorted(
            plan, key=lambda s: (self.by_slot[s].arrival, self.by_slot[s].rid)
        )
        for slot in order:
            if slot not in plan:
                continue  # preempted as a victim earlier in this loop
            need = int(self.slots.pos[slot]) + plan[slot]
            while not self.slots.ensure(slot, need):
                victim = self._pick_victim(keep=slot)
                if victim is None:
                    raise RuntimeError(
                        f"slot {slot}: page pool exhausted with no victim "
                        "(request larger than the pool?)"
                    )
                self._preempt(victim)
                plan.pop(victim, None)
        return plan

    # ------------------------------------------------------------------
    # one engine iteration
    # ------------------------------------------------------------------

    def _pick_width(self, plan: dict[int, int]) -> int:
        """Smallest step width fitting the largest chunk."""
        need = max(plan.values())
        for w in self.serve_cfg.widths:
            if w >= need:
                return w
        return self.serve_cfg.prefill_chunk

    def step(self) -> list[TokenEvent]:
        """Run one engine tick. Returns the tokens emitted this tick (in
        slot order) — empty on an idle tick or a pure-prefill step."""
        self._admit()
        self.peak_concurrency = max(self.peak_concurrency, len(self.by_slot))
        plan = self.scheduler.plan(self.by_slot)
        if plan:
            plan = self._ensure_blocks(plan)
        if not plan:
            self.clock += 1
            self.idle_steps += 1
            return []

        b = self.serve_cfg.max_slots
        width = self._pick_width(plan)
        tokens = np.zeros((b, width), np.int32)
        count = np.zeros((b,), np.int32)
        n_prefill = 0
        for slot, n in plan.items():
            req = self.by_slot[slot]
            if req.remaining_prompt > 0:
                seg = req.context[req.prefilled : req.prefilled + n]
                tokens[slot, : len(seg)] = seg
                count[slot] = len(seg)
                n_prefill += len(seg)
            else:
                tokens[slot, 0] = req.generated[-1]
                count[slot] = 1

        dev = self.device
        state = {
            "tokens": torch.from_numpy(tokens).to(dev),
            "count": torch.from_numpy(count).to(dev),
            "pos": torch.from_numpy(self.slots.pos.copy()).to(dev),
            "cache": self.slots.cache,
            "block_tables": torch.from_numpy(self.slots.block_tables.copy()).to(dev),
        }
        t0 = time.perf_counter()
        nxt, new_state = self._step_fn(self.params, state)
        # reading the tokens back to the host waits for the device, so
        # dt covers the step's device work, not just its enqueue
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        self.slots.cache = new_state["cache"]
        self.slots.pos = self.slots.pos + count

        events: list[TokenEvent] = []
        done_slots = []
        for slot, _n in sorted(plan.items()):
            req = self.by_slot[slot]
            emitted: list[int] = []
            if req.state == rq.PREFILL:
                req.prefilled += int(count[slot])
                if req.remaining_prompt == 0:
                    req.state = rq.DECODE
                    if req.first_token_step < 0:
                        req.first_token_step = self.clock
                    # a recompute-preempted request's re-prefill ends on
                    # generated[-2]; its logits re-predict the known
                    # generated[-1], which must not be emitted twice
                    if not req.generated:
                        emitted = [int(nxt[slot])]
            else:
                emitted = [int(nxt[slot])]
            for e in emitted:
                req.generated.append(e)
                req.token_steps.append(self.clock)
                req.token_latencies.append(dt)
                if req.done:
                    req.state = rq.FINISHED
                    req.finish_step = self.clock
                    self.finished[req.rid] = req
                    done_slots.append(slot)
                events.append(TokenEvent(req.rid, e, req.done))
        for slot in done_slots:
            del self.by_slot[slot]
            self.slots.free(slot)

        self.compute_steps += 1
        self.step_times.append(dt)
        self.padded_tokens += b * width
        n_total = int(count.sum())
        self.prefill_tokens += n_prefill
        self.decode_tokens += n_total - n_prefill
        # mixed steps: apportion wall time by token share
        frac = n_prefill / max(n_total, 1)
        self.prefill_s += dt * frac
        self.decode_s += dt * (1.0 - frac)
        self._occupancy_sum += len(plan)
        self.clock += 1
        return events

    def run(
        self,
        max_ticks: int | None = None,
        *,
        on_token: Callable[[TokenEvent], None] | None = None,
    ) -> dict[int, np.ndarray]:
        """Drive to completion (incl. future arrivals). rid -> tokens.
        ``on_token`` is called with each :class:`TokenEvent` the tick it
        is generated."""
        ticks = 0
        while self.waiting or self.by_slot:
            for ev in self.step():
                if on_token is not None:
                    on_token(ev)
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return {rid: r.tokens() for rid, r in sorted(self.finished.items())}

    def stream(self, max_ticks: int | None = None) -> Iterator[TokenEvent]:
        """Drive to completion, yielding each token as it is generated."""
        ticks = 0
        while self.waiting or self.by_slot:
            yield from self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> dict[str, float]:
        """Aggregate serving metrics: throughput, latency percentiles
        (nearest rank over per-token step times), slot economics,
        padding efficiency and preemptions."""
        total_tokens = self.prefill_tokens + self.decode_tokens
        steps = max(self.compute_steps, 1)
        gen = sum(len(r.generated) for r in self.finished.values())
        lat = sorted(t for r in self.finished.values() for t in r.token_latencies)

        def pct(p):
            if not lat:
                return 0.0
            n = len(lat)
            return lat[min(n - 1, max(0, math.ceil(p * n / 100.0) - 1))]

        wall = sum(self.step_times)
        return {
            "compute_steps": self.compute_steps,
            "idle_steps": self.idle_steps,
            "total_tokens": total_tokens,
            "generated_tokens": gen,
            "tokens_per_step": total_tokens / steps,
            "generated_per_step": gen / steps,
            "slot_utilization": self._occupancy_sum / (steps * self.serve_cfg.max_slots),
            "peak_concurrency": self.peak_concurrency,
            "preemptions": self.preemptions,
            "padded_tokens": self.padded_tokens,
            "padding_efficiency": total_tokens / max(self.padded_tokens, 1),
            "wall_s": wall,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "p50_token_latency_s": pct(50),
            "p99_token_latency_s": pct(99),
        }
