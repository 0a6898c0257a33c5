"""Decoder stack for the dense family (twin of ``repro.models.transformer``).

The JAX package stacks each period-slot's parameters ``[n_periods, ...]``
and scans over periods. PyTorch runs eagerly, so here the stack is a
Python loop over a list of per-layer parameter dicts, and the paged
cache is a list of per-layer page pools. The period abstraction is kept
so that the families with heterogeneous layers can join later; only the
dense family (one attention + MLP slot per period) is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str  # "attn"
    ffn: str | None  # "mlp"


def period_pattern(cfg: ModelConfig) -> list[Slot]:
    """The repeating layer pattern for one period."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (dense only)")
    return [Slot("attn", "mlp")]


def n_periods(cfg: ModelConfig) -> int:
    plen = len(period_pattern(cfg))
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible by period {plen}")
    return cfg.n_layers // plen


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _slot_init(gen, cfg: ModelConfig, slot: Slot, device):
    dt = _dtype(cfg)
    p: dict[str, Any] = {
        "norm1": layers.rmsnorm_init(cfg.d_model, dt, device=device),
        "attn": layers.attn_init(gen, cfg, dt, device=device),
    }
    if slot.ffn is not None:
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, dt, device=device)
        p["mlp"] = layers.mlp_init(
            gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp, device=device
        )
    return p


def _slot_apply(
    p,
    x,
    cfg: ModelConfig,
    slot: Slot,
    *,
    qpos,
    cache,
    block_tables,
    rope,
    write_index,
    paged_kernel=True,
):
    h = layers.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    out, new_cache = layers.attn_apply(
        p["attn"], h, cfg,
        qpos=qpos, kv_cache=cache, block_tables=block_tables,
        rope=rope, write_index=write_index, paged_kernel=paged_kernel,
    )
    x = x + out
    if slot.ffn is not None:
        h2 = layers.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp_apply(p["mlp"], h2, cfg.act)
    return x, new_cache


def stack_init(gen, cfg: ModelConfig, device):
    """Per-layer params: ``{"layers": [layer 0, layer 1, ...]}``."""
    slots = period_pattern(cfg)
    return {
        "layers": [
            _slot_init(gen, cfg, slot, device)
            for _ in range(n_periods(cfg))
            for slot in slots
        ]
    }


def stack_cache_init(cfg: ModelConfig, n_pages, block_size, dtype=torch.bfloat16, *, device="cuda"):
    """Paged decode cache: one ``{"k", "v"}`` page pool
    ``[n_pages, block_size, KV, hd]`` per layer. Page id *p* addresses
    the same pool index at every layer, so one block table serves the
    whole stack."""
    period_pattern(cfg)
    shape = (n_pages, block_size, cfg.n_kv_heads, cfg.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for _ in range(cfg.n_layers)
    ]


def stack_apply(
    params,
    x,
    cfg: ModelConfig,
    *,
    positions,
    caches,
    token_valid,
    block_tables,
    paged_kernel=True,
):
    """Run the stack over the paged cache: ``positions [B,S]`` are each
    token's absolute position in its slot, ``token_valid [B,S]`` which
    tokens are real. Returns (x, caches); the pools are written in place.
    The int32 query positions, the RoPE angles and the page-write index
    are the same at every layer, so they are made once here."""
    slots = period_pattern(cfg)
    qpos = positions.to(torch.int32).contiguous()
    rope = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    write_index = layers.paged_write_index(
        block_tables, positions, token_valid, caches[0]["k"].shape[1]
    )
    for li, p in enumerate(params["layers"]):
        x, caches[li] = _slot_apply(
            p, x, cfg, slots[li % len(slots)],
            qpos=qpos, cache=caches[li], block_tables=block_tables,
            rope=rope, write_index=write_index, paged_kernel=paged_kernel,
        )
    return x, caches
