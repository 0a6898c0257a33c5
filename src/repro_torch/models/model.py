"""Top-level LM: embeddings + stack + the per-slot decode API.

The twin of ``repro.models.model`` for serving the dense family:

  * ``init_params(cfg, seed, device)``          -> params
  * ``params_from_jax(cfg, tree, device)``      -> params from a JAX param tree
  * ``init_paged_cache(cfg, n_blocks, block_size, dtype, device)``
  * ``decode_slots(cfg, params, tokens, cache, slot_pos, token_count, ...)``
  * ``reset_paged(cache, pages)``

Params are nested dicts of tensors in the JAX package's layouts, with
the stack as a list of per-layer dicts instead of stacked arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict[str, Any]:
    """Random params with the JAX package's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device=device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, device=device),
        "stack": transformer.stack_init(gen, cfg, device),
    }


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> dict[str, Any]:
    """The port's params from a JAX param tree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``). The dense family has
    one slot per period, so layer ``li`` is
    ``tree["stack"]["slots"][0][...][li]``."""
    transformer.period_pattern(cfg)
    slot = tree["stack"]["slots"][0]

    def convert(node, li=None):
        if isinstance(node, dict):
            return {k: convert(v, li) for k, v in node.items()}
        return _tensor(node if li is None else np.asarray(node)[li], device)

    return {
        "embed": convert(tree["embed"]),
        "final_norm": convert(tree["final_norm"]),
        "stack": {"layers": [convert(slot, li) for li in range(cfg.n_layers)]},
    }


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int, dtype=None, device="cuda"):
    """Paged decode cache: per layer a K/V page pool ``[n_blocks,
    block_size, KV, hd]`` (the dense family keeps no per-slot state, so
    unlike the JAX package's it takes no batch size)."""
    dt = dtype or getattr(torch, cfg.dtype)
    return transformer.stack_cache_init(cfg, n_blocks, block_size, dt, device=device)


def decode_slots(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B, C] — up to C tokens per slot this step
    cache,
    slot_pos: torch.Tensor,  # [B]: per-slot cache write position
    token_count: torch.Tensor,  # [B]: real tokens per slot (0 = idle slot)
    *,
    block_tables: torch.Tensor,  # [B, NB] int32
    paged_kernel: bool = True,
):
    """Mixed prefill/decode step over independently positioned slots.

    Every batch row is a slot with its own write position: decode slots
    feed 1 token, prefilling slots a chunk of up to C prompt tokens, idle
    slots 0. Slot b's token at logical position p is written to page
    ``block_tables[b, p // block_size]`` at offset ``p % block_size``
    (in place); attention is causally masked per slot.
    ``paged_kernel`` (default) attends through the paged-attention
    kernel; ``paged_kernel=False`` gathers the pages instead.

    Returns ``(logits [B, V] fp32 at each slot's last real token,
    cache)``. Rows with ``token_count == 0`` carry garbage logits the
    caller must ignore.
    """
    b, c = tokens.shape
    ar = torch.arange(c, device=tokens.device)
    positions = slot_pos.long()[:, None] + ar[None, :]  # [B, C]
    valid = ar[None, :] < token_count.long()[:, None]  # [B, C]
    x = layers.embed_apply(params["embed"], tokens)
    x, cache = transformer.stack_apply(
        params["stack"], x, cfg,
        positions=positions, caches=cache, token_valid=valid, block_tables=block_tables,
        paged_kernel=paged_kernel,
    )
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    last = torch.clamp(token_count.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), last][:, None]  # [B, 1, d]
    logits = layers.unembed_apply(params["embed"], x_last, valid=cfg.vocab)[:, 0]
    return logits, cache


def reset_paged(cache, pages) -> None:
    """Zero the K/V pool pages ``pages`` (a list of ids) in place, at
    every layer. The dense family keeps no per-slot state, so pages are
    all there is to clear."""
    if not len(pages):
        return
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=cache[0]["k"].device)
    for layer in cache:
        layer["k"][idx] = 0
        layer["v"][idx] = 0
