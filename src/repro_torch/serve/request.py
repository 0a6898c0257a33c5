"""Request lifecycle for the continuous-batching engine.

The port's own copy of ``repro.serve.request``. A request moves through::

    WAITING --admit--> PREFILL --last prompt token--> DECODE --max_new--> FINISHED
    (arrival queue)    (chunked)                      (1 tok/step)       (slot freed)
        ^                                               |
        +----------------- preempt (paged engine) ------+

The engine owns the transitions; this module holds the record and its
bookkeeping (slot, prefill progress, generated tokens, sampling
parameters, per-token step/latency traces).

**Sampling** is data on the request (:class:`SamplingParams`):
temperature 0 is greedy; > 0 samples with top-k / top-p from the
request's PRNG lane. The lane is stateless: the token emitted at cache
position ``p`` draws under ``fold_in(key_data(seed), p)``, so the stream
is a pure function of (seed, position), whatever the chunking, slot,
batch or preemptions.

**Preemption** (paged engine) has two strategies:

* **recompute** (:meth:`Request.preempt`) — the cache is dropped and
  :attr:`Request.context` (prompt plus every generated token but the
  newest) is prefilled again on re-admission. Exact for greedy requests
  only, so it raises for a sampled one;
* **swap** (:meth:`Request.preempt_swap`) — the engine stages the slot's
  pages on the host and restores them on re-admission; positions are
  kept, so the stream is the same. Exact for any request.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.launch.steps import TOP_K_CAP

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls, carried on :class:`Request` as data.

    Attributes:
      temperature: 0 (default) is greedy argmax; > 0 samples.
      top_k: keep only the k highest logits (0 = off; at most
        ``TOP_K_CAP``).
      top_p: nucleus mass (1.0 = off).
      seed: the request's PRNG lane seed.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if self.top_k > TOP_K_CAP:
            raise ValueError(f"top_k must be <= {TOP_K_CAP}, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        """Greedy decode — deterministic without a PRNG lane."""
        return self.temperature == 0.0

    def key_data(self) -> np.ndarray:
        """The request's base PRNG lane as raw ``uint32[2]`` key data,
        the layout of ``jax.random.PRNGKey(seed)`` (high word, low word)."""
        return np.array(
            [(self.seed >> 32) & 0xFFFFFFFF, self.seed & 0xFFFFFFFF], np.uint32
        )


@dataclasses.dataclass
class Request:
    """One serving request.

    Args:
      rid: unique id (the engine rejects duplicates at submit time).
      prompt: ``[P]`` int32 token ids (P >= 1).
      max_new_tokens: generation budget (>= 1).
      arrival: engine tick at which the request becomes visible to
        admission.
      sampling: per-request :class:`SamplingParams` (greedy default).
      no_spec: opt out of speculative decoding — one token a step even
        when the engine speculates (the stream is the same either way).
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: int = 0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    no_spec: bool = False

    # --- engine-owned lifecycle state ---
    state: str = WAITING
    slot: int = -1
    prefilled: int = 0  # context tokens already fed to the model
    generated: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0  # times evicted back to WAITING (paged engine)
    # recompute context after a preemption (None = plain prompt)
    _resume: np.ndarray | None = None
    # host-swapped cache state (SwappedSlot) awaiting re-admission
    swap: object | None = None
    # traces (engine ticks / seconds) for latency accounting
    first_token_step: int = -1
    finish_step: int = -1
    token_steps: list[int] = dataclasses.field(default_factory=list)
    token_latencies: list[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def context(self) -> np.ndarray:
        """Tokens to prefill: the prompt, or — after a preemption — the
        prompt plus all generated tokens but the newest."""
        return self.prompt if self._resume is None else self._resume

    @property
    def context_len(self) -> int:
        return int(self.context.size)

    @property
    def remaining_prompt(self) -> int:
        return self.context_len - self.prefilled

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def preempt(self) -> None:
        """Evict back to WAITING with **recompute** on re-admission.
        Raises for a sampled request, whose recomputed stream would
        diverge."""
        if not self.sampling.greedy:
            raise RuntimeError(
                f"request {self.rid}: recompute preemption of a sampled request "
                f"(temperature={self.sampling.temperature}) is not bit-exact: use "
                "swap preemption (ServeConfig.preempt='swap' or 'auto')"
            )
        if self.generated:
            self._resume = np.concatenate(
                [self.prompt, np.asarray(self.generated[:-1], np.int32)]
            )
        else:
            self._resume = None
        self.state = WAITING
        self.slot = -1
        self.prefilled = 0
        self.preemptions += 1

    def preempt_swap(self, swapped) -> None:
        """Evict back to WAITING with the cache **swapped** to the host.
        ``swapped`` is the :class:`~repro_torch.serve.cache.SwappedSlot`
        the engine got from ``swap_out``; prefill progress and positions
        are kept, so re-admission restores the exact device state. Exact
        for greedy and sampled requests alike."""
        self.swap = swapped
        self.state = WAITING
        self.slot = -1
        self.preemptions += 1

    def resume_from_swap(self) -> None:
        """Called by the engine after ``swap_in``: drop the host bundle
        and return to the state the request was evicted in."""
        self.swap = None
        self.state = DECODE if self.remaining_prompt == 0 else PREFILL

    def tokens(self) -> np.ndarray:
        return np.asarray(self.generated, np.int32)
