"""Serving step builders (twin of ``repro.launch.steps``).

Only the non-speculative mixed prefill/decode step with greedy argmax
is ported; sampling, speculative verification and the train steps come
with later slices.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as lm

# Bound on per-request top_k (``SamplingParams`` validates against it),
# kept equal to the JAX package's static ``lax.top_k`` cap.
TOP_K_CAP = 128


def make_slot_step(cfg: ModelConfig, *, paged_kernel: bool = True) -> Callable:
    """Mixed prefill/decode step over per-slot state (continuous batching).

    state = {"tokens": [B,C] int32, "count": [B] int32 (real tokens per
    slot; 0 = idle), "pos": [B] int32 (per-slot cache offsets), "cache":
    the paged cache (list of per-layer pools), "block_tables": [B, NB]
    int32}. ``paged_kernel`` (default) attends through the paged-attention
    kernel; ``paged_kernel=False`` gathers the pages instead.

    Returns ``(next_tokens [B] int32, new_state)``: greedy argmax at each
    slot's last real token, the cache written in place and ``pos``
    advanced by ``count``. Rows with count == 0 return garbage tokens.
    """

    def slot_step(params, state):
        logits, new_cache = lm.decode_slots(
            cfg, params, state["tokens"], state["cache"],
            state["pos"], state["count"],
            block_tables=state["block_tables"],
            paged_kernel=paged_kernel,
        )
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        new_state = dict(state, cache=new_cache, pos=state["pos"] + state["count"])
        return nxt, new_state

    return slot_step
