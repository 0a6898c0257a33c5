"""Top-level LM: embeddings + stack + loss + the per-slot decode API.

The twin of ``repro.models.model`` for the dense family:

  * ``init_params(cfg, seed, device)``          -> params
  * ``params_from_jax(cfg, tree, device)``      -> params from a JAX param tree
  * ``site_names(cfg)``                         -> (sites, depth)
  * ``forward(cfg, params, batch, policy)``     -> (logits fp32, aux)
  * ``loss_fn(cfg, params, batch, policy)``     -> (loss, metrics)
  * ``kernel_launches_per_step(cfg, policy)``   -> the kernels a train step launches
  * ``init_paged_cache(cfg, n_blocks, block_size, dtype, device)``
  * ``decode_slots(cfg, params, tokens, cache, slot_pos, token_count, ...)``
  * ``reset_paged(cache, pages)``

Batches are dicts of tensors: ``tokens [B,S]``, ``targets [B,S]`` and
optionally ``loss_mask [B,S]``.

Params are nested dicts of tensors in the JAX package's layouts, with
the stack as a list of per-layer dicts instead of stacked arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
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


def site_names(cfg: ModelConfig):
    """Every sparsifiable call site of this model and the depth negative
    layer indices in rule patterns resolve against: ``(sites, depth)``,
    the inputs of :meth:`~repro_torch.core.policy.PolicyProgram.resolve`."""
    return transformer.stack_sites(cfg), cfg.n_layers


def forward(cfg: ModelConfig, params, batch, policy: PolicyLike = DENSE):
    """Full-sequence forward. Returns (logits fp32 [B, S, V], aux loss);
    the dense family has no auxiliary loss, so aux is 0."""
    x = layers.embed_apply(params["embed"], batch["tokens"])
    x, _ = transformer.stack_apply(params["stack"], x, cfg, policy)
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed_apply(params["embed"], x, valid=cfg.vocab)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ModelConfig, params, batch, policy: PolicyLike = DENSE):
    """Next-token cross-entropy (+0.01 aux), averaged over ``loss_mask``
    (default: every token). Returns ``(total, {"ce", "aux"})``."""
    logits, aux = forward(cfg, params, batch, policy)
    targets = batch["targets"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def kernel_launches_per_step(cfg: ModelConfig, policy: PolicyLike) -> dict[str, int]:
    """Launches of each backward kernel in one training step under
    ``policy`` (a plain policy or a step's table), site by site by the
    engine's rules: a sparse site on the kernel route (``use_pallas``,
    not ``mask_mode``) launches one dX product if ``sparsify_dx`` and one
    dW product if ``sparsify_dw``, through ``matmul`` at channel
    granularity and ``dx_gathered`` / ``dw_gathered`` at block
    granularity. Every site's input needs a gradient (the embedding
    table trains), so layer 0 launches its dX products too."""
    n = {"matmul": 0, "dx_gathered": 0, "dw_gathered": 0}
    for site in site_names(cfg)[0]:
        p = policy_for(policy, site)
        if not (p.active and p.use_pallas and not p.mask_mode):
            continue
        if p.granularity == "channel":
            n["matmul"] += p.sparsify_dx + p.sparsify_dw
        else:
            n["dx_gathered"] += p.sparsify_dx
            n["dw_gathered"] += p.sparsify_dw
    return n


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
