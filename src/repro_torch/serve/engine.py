"""The continuous-batching engine: slot-scheduled, sampling-safe serving.

The twin of ``repro.serve.engine``, for every family. One engine
iteration (:meth:`ContinuousBatchingEngine.step`):

1. **admission** — freed slots go to arrived waiting requests (FIFO;
   under the paged cache also gated on free pages); each new occupant's
   slot state is zeroed and, for the encoder-decoder family, the encoder
   runs over its frames into the slot's row of ``enc_out`` (again for a
   request coming back from any preemption). A request returning from a
   **swap** preemption has its staged pages restored instead of
   prefilling again;
2. **planning** — the :class:`~repro_torch.serve.scheduler.Scheduler`
   packs decode tokens (1 per running slot, ``1 + spec_k`` when
   speculating) and chunked-prefill tokens under the token budget. With
   the paged cache the engine then grows each planned slot's block table
   to cover the step; if the pool runs dry it **preempts** the youngest
   running request back to WAITING by ``ServeConfig.preempt``:
   ``recompute`` (prefill the token history again — exact for greedy
   requests only, which ``Request.preempt`` enforces), ``swap`` (stage
   the slot's pages on the host), or ``auto`` (swap sampled requests,
   recompute greedy ones);
3. **one mixed step** — :func:`repro_torch.launch.steps.make_slot_step`
   runs prefill chunks and decode tokens together at the smallest step
   width that fits. Each request's :class:`~repro_torch.serve.request.SamplingParams`
   ride in the step state as per-slot tensors (temperature / top-k /
   top-p and a ``[B, 2]`` PRNG lane), drawn as ``jax.random`` draws, so
   a seeded sampled stream is the JAX engine's;
4. **completion** — emitted tokens stream out of :meth:`step` as
   :class:`TokenEvent` s; finished requests release their slot (and
   pages).

With ``ServeConfig.spec_k > 0`` the engine adds **speculative
decoding**: before the target step a drafter (its own contiguous
per-slot cache, whose state is advisory: dropped on preemption and
prefilled again from the token history) proposes up to ``k`` tokens per
decoding slot; the target verifies the chunk in one ``k+1``-wide step
with per-position folds, emits the exactly matching draft prefix plus
its own next token, and rolls ``pos`` (and, paged, the tail pages) back
past the first mismatch. The stream is the one ``spec_k = 0`` gives.

The JAX drafter proposes on a functional snapshot of its cache and drops
it. The port's drafter cache is written in place, so after a proposal
round its positions are rolled back and its SSM states restored from a
copy taken before the round: the proposals' K/V stay in the rows past
the synced position, where the per-slot causal mask fences them until
the next catch-up overwrites them, while a recurrent state has no
position to fence by. An encoder-decoder drafter keeps its own per-slot
encoder output, made at admission from the request's frames.

``block_size > 0`` selects the paged cache (attention through the
paged-attention kernel by default); ``block_size == 0`` the contiguous
one (plain attention, as in the JAX package).
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
from repro_torch.models import model as lm
from repro_torch.serve import request as rq
from repro_torch.serve.cache import PagedCacheManager, SlotCacheManager
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
      serve_cfg: slot/chunk/budget/page configuration; ``block_size > 0``
        selects the paged cache.
      cache_dtype: cache dtype (fp32 default, as in the JAX engine: bf16
        K/V are written into fp32 caches).
      device: where the caches live and the steps run.
      draft_cfg / draft_params: the drafter for speculative decoding
        (``spec_k > 0``), a model of the same family and vocabulary. Both
        default to the target model (self-drafting: every proposal the
        target would make).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig,
        *,
        cache_dtype=torch.float32,
        device="cuda",
        draft_cfg: ModelConfig | None = None,
        draft_params=None,
    ):
        self.cfg = cfg
        self.params = params
        self.serve_cfg = serve_cfg
        self.device = torch.device(device)
        if serve_cfg.paged:
            self.slots = PagedCacheManager(
                cfg, serve_cfg.max_slots, serve_cfg.max_seq,
                block_size=serve_cfg.block_size,
                n_blocks=serve_cfg.total_blocks,
                dtype=cache_dtype, device=self.device,
            )
        else:
            self.slots = SlotCacheManager(
                cfg, serve_cfg.max_slots, serve_cfg.max_seq,
                dtype=cache_dtype, device=self.device,
            )
        self.scheduler = Scheduler(serve_cfg)
        self._spec = serve_cfg.spec_k > 0
        self._step_fn = steps_lib.make_slot_step(
            cfg, paged_kernel=serve_cfg.attn_kernel, spec=self._spec
        )
        # --- speculative drafter plane (spec_k > 0) ---
        # Its own contiguous rows, slot ids mirroring the target's, sized
        # past max_seq: proposals write up to spec_k tokens beyond the
        # committed history before the positions are rolled back.
        self._draft = None
        if self._spec:
            self.draft_cfg = draft_cfg or cfg
            self.draft_params = draft_params if draft_params is not None else params
            if self.draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"drafter vocab {self.draft_cfg.vocab} != target vocab {cfg.vocab}"
                )
            self._draft = SlotCacheManager(
                self.draft_cfg, serve_cfg.max_slots, serve_cfg.max_seq + serve_cfg.spec_k,
                dtype=cache_dtype, device=self.device,
            )
            self._draft_step_fn = steps_lib.make_slot_step(self.draft_cfg)
            # committed tokens (prompt + generated) the drafter has
            # consumed per slot; 0 forces a full catch-up prefill
            self._draft_sync = np.zeros((serve_cfg.max_slots,), np.int64)
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
        self.swap_preemptions = 0
        self.recompute_preemptions = 0
        self.swapped_bytes = 0
        self.peak_concurrency = 0
        self.spec_proposed = 0  # draft tokens offered for verification
        self.spec_accepted = 0  # draft tokens the target confirmed
        self.draft_steps = 0  # drafter model invocations
        self.padded_tokens = 0  # B × width summed over compute steps
        self.step_times: list[float] = []
        self.encode_times: list[float] = []  # encdec: seconds an encoder call
        self._occupancy_sum = 0
        # encdec: each slot's encoder output, written at admission (and
        # the drafter's own when speculating)
        self.enc_out = self._draft_enc_out = None
        if cfg.family == "encdec":
            self.enc_out = self._enc_rows(cfg)
            if self._spec:
                self._draft_enc_out = self._enc_rows(self.draft_cfg)

    def _enc_rows(self, cfg: ModelConfig) -> torch.Tensor:
        return torch.zeros((self.serve_cfg.max_slots, cfg.enc_seq, cfg.d_model),
                           dtype=getattr(torch, cfg.dtype), device=self.device)

    def _encode(self, cfg: ModelConfig, params, frames: np.ndarray) -> torch.Tensor:
        """One request's encoder output, ``[enc_seq, d]`` in ``cfg.dtype``;
        its seconds, the device's work included, go to ``encode_times``."""
        self._sync()
        t0 = time.perf_counter()
        out = lm.encode_frames(cfg, params, frames[None], self.device)[0]
        self._sync()
        self.encode_times.append(time.perf_counter() - t0)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def submit(self, req: rq.Request) -> None:
        """Queue a request. Raises if it can never fit the cache, or if
        its rid is already known (waiting, running or finished)."""
        if req.rid in self._known_rids:
            raise ValueError(
                f"request {req.rid}: duplicate rid — already "
                "waiting, running or finished in this engine"
            )
        need = req.prompt_len + req.max_new_tokens - 1  # last token not cached
        if need > self.serve_cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+generation ({need}) exceeds "
                f"max_seq {self.serve_cfg.max_seq}"
            )
        if self.serve_cfg.paged:
            need_blocks = -(-need // self.serve_cfg.block_size)
            if need_blocks > self.serve_cfg.total_blocks:
                raise ValueError(
                    f"request {req.rid}: needs {need_blocks} pages, pool "
                    f"has {self.serve_cfg.total_blocks}"
                )
        if self.cfg.family == "encdec" and req.frames is None:
            raise ValueError(f"request {req.rid}: encdec family needs frames")
        self._known_rids.add(req.rid)
        req.state = rq.WAITING
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def _admit(self) -> None:
        admitted = self.scheduler.admit(
            self.waiting, self.slots.n_free, self.clock,
            n_free_blocks=self.slots.n_free_blocks if self.serve_cfg.paged else None,
        )
        if not admitted:
            return
        new_slots = []
        swapped_in = []
        for req in admitted:
            self.waiting.remove(req)
            slot = self.slots.alloc()
            req.slot = slot
            req.state = rq.PREFILL
            self.by_slot[slot] = req
            new_slots.append(slot)
            if req.swap is not None:
                swapped_in.append(req)
            if self.enc_out is not None:
                self.enc_out[slot] = self._encode(self.cfg, self.params, req.frames)
            if self._draft_enc_out is not None:
                self._draft_enc_out[slot] = self._encode(self.draft_cfg, self.draft_params,
                                                         req.frames)
        self.slots.reset(new_slots)  # clear the previous occupants' state
        if self._draft is not None:
            # drafter state is advisory: every new occupant starts from a
            # zeroed drafter row and a full catch-up prefill
            self._draft.reset(new_slots)
            for slot in new_slots:
                self._draft.pos[slot] = 0
                self._draft_sync[slot] = 0
        for req in swapped_in:
            # admission reserved the page count, so a failed swap-in is an
            # accounting bug, not a recoverable state
            if not self.slots.swap_in(req.slot, req.swap):
                raise RuntimeError(
                    f"request {req.rid}: swap-in failed for "
                    f"{req.swap.n_pages} pages despite admission gate"
                )
            req.resume_from_swap()

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
        """Evict ``slot``'s request back to WAITING and free its pages
        (zeroed now: they may be allocated again within this tick), by
        ``ServeConfig.preempt``: swap stages the pages on the host,
        recompute drops them (``Request.preempt`` raises for a sampled
        request), auto swaps sampled requests and recomputes greedy ones."""
        req = self.by_slot.pop(slot)
        mode = self.serve_cfg.preempt
        if mode == "swap" or (mode == "auto" and not req.sampling.greedy):
            swapped = self.slots.swap_out(slot)  # frees slot + pages
            req.preempt_swap(swapped)
            self.swap_preemptions += 1
            self.swapped_bytes += swapped.nbytes
        else:
            req.preempt()  # checks the greedy-recompute invariant
            self.slots.free(slot)
            self.recompute_preemptions += 1
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

    def _sampling_state(self, slots) -> dict[str, torch.Tensor]:
        """Sampling tensors of the requests in ``slots`` (the other rows
        greedy)."""
        return steps_lib.sampling_state(
            [self.by_slot[s].sampling if s in slots else None
             for s in range(self.serve_cfg.max_slots)],
            self.device,
        )

    # ------------------------------------------------------------------
    # speculative drafting
    # ------------------------------------------------------------------

    def _run_draft(self, tokens: np.ndarray, count: np.ndarray) -> np.ndarray:
        """One drafter step over per-slot chunks; returns emitted tokens.
        The drafter samples with each request's own controls and lane at
        the folds the target will use: a draft is a bet on the exact
        token the target will emit there."""
        dev = self.device
        state = {
            "tokens": torch.from_numpy(tokens).to(dev),
            "count": torch.from_numpy(count).to(dev),
            "pos": torch.from_numpy(self._draft.pos.copy()).to(dev),
            "cache": self._draft.cache,
            **self._sampling_state(self.by_slot),
        }
        if self._draft_enc_out is not None:
            state["enc_out"] = self._draft_enc_out
        nxt, new_state = self._draft_step_fn(self.draft_params, state)
        self._draft.cache = new_state["cache"]
        self._draft.pos = self._draft.pos + count
        self.draft_steps += 1
        return nxt.cpu().numpy()

    def _draft_propose(self, plan: dict[int, int]) -> dict[int, list[int]]:
        """Draft ``n-1`` proposal tokens for each speculative decode slot.

        1. **catch-up** — feed each slot the committed tokens (prompt +
           generated) the drafter has not consumed, in prefill-width
           chunks: the previous tick's accepted tokens in steady state,
           the whole history after admission or a preemption. The step
           that consumes a slot's last committed token emits its first
           proposal ``d1``. These writes are committed state.
        2. **propose** — ``k-1`` width-1 steps, each feeding the previous
           proposal, give ``d2..dk``; slots that want fewer freeze.
        3. **roll back** — the drafter's positions return to the synced
           ones and its SSM states to their copies from before step 2.
           The proposal K/V stay in the rows past the positions, fenced
           by the causal mask; the next catch-up overwrites them with
           whatever the target accepted.
        """
        spec_slots = [
            s for s, n in plan.items()
            if n > 1 and self.by_slot[s].remaining_prompt == 0
        ]
        if not spec_slots:
            return {}
        b = self.serve_cfg.max_slots
        chunk = self.serve_cfg.prefill_chunk
        hist = {
            s: np.concatenate(
                [self.by_slot[s].prompt, np.asarray(self.by_slot[s].generated, np.int32)]
            )
            for s in spec_slots
        }
        pending = {s: hist[s][int(self._draft_sync[s]):] for s in spec_slots}
        # A slot with nothing pending has no fresh logits to draft from;
        # the engine loop never makes one, but demote it to plain decode
        # rather than propose from stale state.
        for s in [s for s in spec_slots if len(pending[s]) == 0]:
            plan[s] = 1
            spec_slots.remove(s)
            pending.pop(s)
        if not spec_slots:
            return {}
        proposals: dict[int, list[int]] = {s: [] for s in spec_slots}
        while any(len(p) for p in pending.values()):
            tokens = np.zeros((b, chunk), np.int32)
            count = np.zeros((b,), np.int32)
            for s in spec_slots:
                seg = pending[s][:chunk]
                tokens[s, : len(seg)] = seg
                count[s] = len(seg)
            nxt = self._run_draft(tokens, count)
            for s in spec_slots:
                pending[s] = pending[s][int(count[s]):]
                if count[s] and not len(pending[s]) and not proposals[s]:
                    proposals[s].append(int(nxt[s]))
        for s in spec_slots:
            self._draft_sync[s] = len(hist[s])
        synced_pos = self._draft.pos.copy()
        synced_ssm = lm.ssm_snapshot(self._draft.cache)
        for _ in range(max(plan[s] - 1 for s in spec_slots) - 1):
            live = [s for s in spec_slots if len(proposals[s]) < plan[s] - 1]
            if not live:
                break
            tokens = np.zeros((b, 1), np.int32)
            count = np.zeros((b,), np.int32)
            for s in live:
                tokens[s, 0] = proposals[s][-1]
                count[s] = 1
            nxt = self._run_draft(tokens, count)
            for s in live:
                proposals[s].append(int(nxt[s]))
        self._draft.pos = synced_pos
        lm.ssm_restore(self._draft.cache, synced_ssm)
        return proposals

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
        if plan and self.serve_cfg.paged:
            plan = self._ensure_blocks(plan)
        if not plan:
            self.clock += 1
            self.idle_steps += 1
            return []
        proposals = self._draft_propose(plan) if self._spec else {}

        b = self.serve_cfg.max_slots
        width = self._pick_width(plan)
        tokens = np.zeros((b, width), np.int32)
        count = np.zeros((b,), np.int32)
        is_spec = np.zeros((b,), bool)
        n_prefill = 0
        for slot, n in plan.items():
            req = self.by_slot[slot]
            if req.remaining_prompt > 0:
                seg = req.context[req.prefilled : req.prefilled + n]
                tokens[slot, : len(seg)] = seg
                count[slot] = len(seg)
                n_prefill += len(seg)
            else:
                # decode: the last committed token, plus — speculating —
                # the drafter's proposals, verified as one chunk
                prop = proposals.get(slot, [])
                tokens[slot, 0] = req.generated[-1]
                if prop:
                    tokens[slot, 1 : 1 + len(prop)] = prop
                    is_spec[slot] = True
                count[slot] = 1 + len(prop)

        dev = self.device
        state = {
            "tokens": torch.from_numpy(tokens).to(dev),
            "count": torch.from_numpy(count).to(dev),
            "pos": torch.from_numpy(self.slots.pos.copy()).to(dev),
            "cache": self.slots.cache,
            **self._sampling_state(plan),
        }
        if self._spec:
            state["is_spec"] = torch.from_numpy(is_spec).to(dev)
        if self.serve_cfg.paged:
            state["block_tables"] = torch.from_numpy(self.slots.block_tables.copy()).to(dev)
        if self.enc_out is not None:
            state["enc_out"] = self.enc_out
        t0 = time.perf_counter()
        # reading the tokens back to the host waits for the device, so
        # dt covers the step's device work, not just its enqueue
        if self._spec:
            (tok, keep), new_state = self._step_fn(self.params, state)
            tok, keep = tok.cpu().numpy(), keep.cpu().numpy()
            consumed = keep
        else:
            nxt, new_state = self._step_fn(self.params, state)
            nxt = nxt.cpu().numpy()
            consumed = count
        dt = time.perf_counter() - t0
        self.slots.cache = new_state["cache"]
        self.slots.pos = self.slots.pos + consumed
        if self._spec and self.serve_cfg.paged:
            # page rollback: pages ensured for the whole verify chunk but
            # past the committed position hold only rejected draft writes
            for slot in plan:
                if is_spec[slot] and consumed[slot] < count[slot]:
                    self.slots.trim(slot, int(self.slots.pos[slot]))

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
                        emitted = [
                            int(tok[slot, count[slot] - 1]) if self._spec else int(nxt[slot])
                        ]
            elif self._spec:
                # accepted drafts + the target's token past them: keep[slot]
                # tokens, the same as keep[slot] plain decode steps give
                emitted = [int(t) for t in tok[slot, : keep[slot]]]
                if is_spec[slot]:
                    self.spec_proposed += int(count[slot]) - 1
                    self.spec_accepted += int(keep[slot]) - 1
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
        n_total = int(consumed.sum())
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
        """Aggregate serving metrics, the JAX engine's keys: throughput,
        latency percentiles (nearest rank over per-token step times),
        slot economics, padding efficiency, preemptions by strategy and
        swap traffic, and speculative decoding (proposed / accepted draft
        tokens, ``acceptance_rate``, drafter invocations)."""
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
            "swap_preemptions": self.swap_preemptions,
            "recompute_preemptions": self.recompute_preemptions,
            "swapped_bytes": self.swapped_bytes,
            "padded_tokens": self.padded_tokens,
            "padding_efficiency": total_tokens / max(self.padded_tokens, 1),
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": self.spec_accepted / max(self.spec_proposed, 1),
            "draft_steps": self.draft_steps,
            "wall_s": wall,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "p50_token_latency_s": pct(50),
            "p99_token_latency_s": pct(99),
        }
