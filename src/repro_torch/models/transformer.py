"""The decoder stack, the encoder and the cross-decoder (twin of ``repro.models.transformer``).

Layer heterogeneity (Jamba's attention:Mamba interleave, MoE on every
other layer) follows the JAX package's **period** abstraction: the layer
pattern repeats every ``period_len`` layers (:func:`period_pattern`).
The JAX package stacks each period-slot's parameters ``[n_periods, ...]``
and scans over periods. PyTorch runs eagerly, so here the stack is a
Python loop over a list of per-layer parameter dicts (layer ``i`` is
slot ``i % period_len``), and a decode cache is a list of per-layer
dicts: K/V for an attention layer, the conv window and SSM state for a
Mamba layer. The VLM family is a dense stack (its patch prefix is the
model's, :mod:`repro_torch.models.model`); the encoder-decoder family
(whisper) runs :func:`encoder_apply`, a non-causal attention + MLP stack
over the frames, then :func:`cross_decoder_apply`, whose layers attend to
themselves through the K/V cache and then to the encoder's output.

Per-site policies: every projection carries a site name
``layer_{li}/{role}/{proj}`` (:func:`stack_sites`). A
:class:`~repro_torch.core.policy.SitePolicies` table threads through
:func:`stack_apply` like a plain policy and is scoped to each layer
before the layer runs. The loop is the JAX package's unrolled path, so
per-depth rules need nothing more (there is no ``scan_layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DENSE, PolicyLike, SitePolicies
from repro_torch.models import layers, moe, ssm

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str  # "attn" | "ssm"
    ffn: str | None  # "mlp" | "moe" | None


def period_pattern(cfg: ModelConfig) -> list[Slot]:
    """The repeating layer pattern for one period."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {', '.join(_FAMILIES)})"
        )
    if cfg.family == "ssm":
        return [Slot("ssm", None)]
    plen = cfg.attn_every or 1
    if cfg.is_moe and cfg.moe_every > 1:
        while plen % cfg.moe_every:
            plen += cfg.attn_every or 1
    slots = []
    for i in range(plen):
        mixer = "ssm" if cfg.attn_every and i % cfg.attn_every != 0 else "attn"
        ffn = "moe" if cfg.is_moe and i % cfg.moe_every == cfg.moe_offset else "mlp"
        slots.append(Slot(mixer, ffn))
    return slots


def n_periods(cfg: ModelConfig) -> int:
    plen = len(period_pattern(cfg))
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible by period {plen}")
    return cfg.n_layers // plen


def layer_slots(cfg: ModelConfig) -> list[Slot]:
    """The slot of every layer, layer ``i`` taking slot ``i % period_len``."""
    slots = period_pattern(cfg)
    n_periods(cfg)
    return [slots[li % len(slots)] for li in range(cfg.n_layers)]


def slot_sites(cfg: ModelConfig, slot: Slot) -> tuple[str, ...]:
    """Layer-relative site names of one period slot's projections."""
    if slot.mixer == "attn":
        sites = ["attn/q", "attn/k", "attn/v", "attn/o"]
    else:
        sites = ["ssm/in_proj", "ssm/out_proj"]
    if slot.ffn == "moe":
        sites += ["moe/gate", "moe/up", "moe/down"]
        if cfg.n_shared_experts:
            sites += ["moe/shared/up", "moe/shared/gate", "moe/shared/down"]
    elif slot.ffn == "mlp":
        sites += ["mlp/up"] + (["mlp/gate"] if cfg.gated_mlp else []) + ["mlp/down"]
    return tuple(sites)


def stack_sites(cfg: ModelConfig) -> tuple[str, ...]:
    """Every sparsifiable site of the decoder stack, ``layer_{li}/...``."""
    return tuple(
        f"layer_{li}/{s}"
        for li, slot in enumerate(layer_slots(cfg))
        for s in slot_sites(cfg, slot)
    )


def _mlp_sites(cfg) -> tuple[str, ...]:
    return ("mlp/up",) + (("mlp/gate",) if cfg.gated_mlp else ()) + ("mlp/down",)


def encoder_sites(cfg: ModelConfig) -> tuple[str, ...]:
    """The encoder's sites, ``enc/layer_{i}/...``."""
    per = ("attn/q", "attn/k", "attn/v", "attn/o") + _mlp_sites(cfg)
    return tuple(f"enc/layer_{i}/{s}" for i in range(cfg.n_enc_layers) for s in per)


def cross_decoder_sites(cfg: ModelConfig) -> tuple[str, ...]:
    """The cross-decoder's sites: self- and cross-attention, then the MLP."""
    per = tuple(
        f"{role}/{proj}" for role in ("self", "cross") for proj in ("q", "k", "v", "o")
    ) + _mlp_sites(cfg)
    return tuple(f"layer_{li}/{s}" for li in range(cfg.n_layers) for s in per)


def _layer_scopes(policy: PolicyLike, n_layers: int):
    """Per-layer policy tables (or the plain policy broadcast)."""
    if not isinstance(policy, SitePolicies):
        return [policy] * n_layers
    return [policy.scoped(f"layer_{li}") for li in range(n_layers)]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _slot_init(gen, cfg: ModelConfig, slot: Slot, device):
    dt = _dtype(cfg)
    p: dict[str, Any] = {"norm1": layers.rmsnorm_init(cfg.d_model, dt, device=device)}
    if slot.mixer == "attn":
        p["attn"] = layers.attn_init(gen, cfg, dt, device=device)
    else:
        p["ssm"] = ssm.ssm_init(gen, cfg, dt, device=device)
    if slot.ffn is not None:
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, dt, device=device)
        if slot.ffn == "moe":
            p["moe"] = moe.moe_init(gen, cfg, dt, device=device)
        else:
            p["mlp"] = layers.mlp_init(
                gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp, device=device
            )
    return p


def _slot_apply(
    p,
    x,
    cfg: ModelConfig,
    slot: Slot,
    policy: PolicyLike,
    *,
    rope,
    qpos=None,
    cache=None,
    token_valid=None,
    block_tables=None,
    write_index=None,
    paged_kernel=True,
    spec_states=False,
):
    """One layer. Returns (x, its new cache or None, its aux loss)."""
    h = layers.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if slot.mixer == "attn":
        out, new_cache = layers.attn_apply(
            p["attn"], h, cfg, policy,
            rope=rope, qpos=qpos, kv_cache=cache, block_tables=block_tables,
            write_index=write_index, paged_kernel=paged_kernel,
        )
    else:
        out, new_cache = ssm.ssm_apply(
            p["ssm"], h, cfg, policy, cache=cache, token_valid=token_valid,
            spec_states=spec_states,
        )
    x = x + out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if slot.ffn is not None:
        h2 = layers.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if slot.ffn == "moe":
            out2, metrics = moe.moe_apply(p["moe"], h2, cfg, policy, full_capacity=cache is not None)
            aux = metrics["aux_loss"]
        else:
            out2 = layers.mlp_apply(p["mlp"], h2, cfg.act, policy)
        x = x + out2
    return x, new_cache, aux


def stack_init(gen, cfg: ModelConfig, device):
    """Per-layer params: ``{"layers": [layer 0, layer 1, ...]}``."""
    return {"layers": [_slot_init(gen, cfg, slot, device) for slot in layer_slots(cfg)]}


def stack_cache_init(
    cfg: ModelConfig, batch, max_seq, dtype=torch.bfloat16, *, n_pages=None, device="cuda"
):
    """Decode cache, a dict a layer. Attention layers hold K/V ``{"k",
    "v"}``: contiguous, ``[batch, max_seq, KV, hd]`` (slot b owns row set
    b); paged (``n_pages``), a pool ``[n_pages, max_seq, KV, hd]`` with
    ``max_seq`` the block size, page id *p* addressing the same pool index
    at every layer, so one block table serves the whole stack. SSM layers
    hold ``{"conv", "state"}`` per slot either way (``[batch, ...]``: O(1)
    a slot, nothing to page), and no K/V."""
    lead = batch if n_pages is None else n_pages
    shape = (lead, max_seq, cfg.n_kv_heads, cfg.head_dim)
    out = []
    for slot in layer_slots(cfg):
        if slot.mixer == "attn":
            out.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            })
        else:
            out.append(ssm.ssm_cache_init(cfg, batch, dtype, device=device))
    return out


def kv_layers(caches) -> list[int]:
    """The layers of a decode cache that hold K/V (the attention layers)."""
    return [li for li, c in enumerate(caches) if "k" in c]


def _decode_geometry(cfg, caches, positions, token_valid, block_tables):
    """What every attention layer of a decode step shares: the int32 query
    positions, the RoPE angles and the K/V write index."""
    qpos = positions.to(torch.int32).contiguous()
    rope = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    rows = caches[kv_layers(caches)[0]]["k"].shape[1]
    if block_tables is None:
        write_index = layers.slot_write_index(positions, token_valid, rows)
    else:
        write_index = layers.paged_write_index(block_tables, positions, token_valid, rows)
    return qpos, rope, write_index


def stack_apply(
    params,
    x,
    cfg: ModelConfig,
    policy: PolicyLike = DENSE,
    *,
    positions=None,
    caches=None,
    token_valid=None,
    block_tables=None,
    paged_kernel=True,
    spec_states=False,
):
    """Run the stack. Returns (x, caches, aux), ``aux`` the MoE layers'
    load-balance losses summed over the layers.

    ``policy`` is a plain policy (every site) or a
    :class:`~repro_torch.core.policy.SitePolicies` table over
    :func:`stack_sites` names, scoped per layer here.

    Without ``caches`` (training): the full causal sequence, RoPE at
    ``arange(S)``. With ``caches`` (serving): ``positions [B,S]`` are each
    token's absolute position in its slot and ``token_valid [B,S]`` marks
    the real tokens; K/V are written in place, and an SSM layer's entry is
    replaced by its new state. With ``block_tables`` it is the paged
    cache, without them the contiguous one. The int32 query positions,
    the RoPE angles and the K/V write index are the same at every layer,
    so they are made once here. ``spec_states=True`` makes the SSM
    layers' entries per-position stacks (see
    :func:`repro_torch.models.ssm.ssm_apply`); K/V are
    position-addressed already and change nothing.
    """
    slots = layer_slots(cfg)
    per_layer = _layer_scopes(policy, cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    has_attn = any(s.mixer == "attn" for s in slots)
    if caches is None:
        rope = None
        if has_attn:
            rope = layers.rope_angles(
                torch.arange(x.shape[1], device=x.device), cfg.head_dim, cfg.rope_theta
            )
        for li, p in enumerate(params["layers"]):
            x, _, a = _slot_apply(p, x, cfg, slots[li], per_layer[li], rope=rope)
            aux = aux + a
        return x, None, aux
    qpos = rope = write_index = None
    if kv_layers(caches):
        qpos, rope, write_index = _decode_geometry(cfg, caches, positions, token_valid,
                                                   block_tables)
    for li, p in enumerate(params["layers"]):
        x, caches[li], a = _slot_apply(
            p, x, cfg, slots[li], per_layer[li],
            rope=rope, qpos=qpos, cache=caches[li], token_valid=token_valid,
            block_tables=block_tables, write_index=write_index, paged_kernel=paged_kernel,
            spec_states=spec_states,
        )
        aux = aux + a
    return x, caches, aux


# ----------------------------------------------------------------------
# encoder (whisper): a non-causal attention + MLP stack
# ----------------------------------------------------------------------


def encoder_init(gen, cfg: ModelConfig, device):
    """Per-layer encoder params: ``{"layers": [{"norm1", "attn", "norm2",
    "mlp"}, ...]}``, ``n_enc_layers`` of them."""
    dt = _dtype(cfg)

    def one():
        return {
            "norm1": layers.rmsnorm_init(cfg.d_model, dt, device=device),
            "attn": layers.attn_init(gen, cfg, dt, device=device),
            "norm2": layers.rmsnorm_init(cfg.d_model, dt, device=device),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp,
                                   device=device),
        }

    return {"layers": [one() for _ in range(cfg.n_enc_layers)]}


def encoder_apply(params, x, cfg: ModelConfig, policy: PolicyLike = DENSE):
    """The encoder over ``x [B, enc_seq, d]``: per layer non-causal
    self-attention (RoPE at ``arange(enc_seq)``, as the JAX package's
    default positions) and the MLP, pre-norm residual. A
    :class:`~repro_torch.core.policy.SitePolicies` table is scoped to
    ``enc`` and then to each layer."""
    enc = policy.scoped("enc") if isinstance(policy, SitePolicies) else policy
    per_layer = _layer_scopes(enc, cfg.n_enc_layers)
    rope = layers.rope_angles(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                              cfg.rope_theta)
    for p, pol in zip(params["layers"], per_layer, strict=True):
        a, _ = layers.attn_apply(p["attn"], layers.rmsnorm_apply(p["norm1"], x, cfg.norm_eps),
                                 cfg, pol, rope=rope, causal=False)
        x = x + a
        x = x + layers.mlp_apply(p["mlp"], layers.rmsnorm_apply(p["norm2"], x, cfg.norm_eps),
                                 cfg.act, pol)
    return x


# ----------------------------------------------------------------------
# cross-decoder (whisper): self-attention, cross-attention, MLP
# ----------------------------------------------------------------------


def cross_decoder_init(gen, cfg: ModelConfig, device):
    """Per-layer decoder params: ``{"layers": [{"norm1", "self", "norm_x",
    "cross", "norm2", "mlp"}, ...]}``."""
    dt = _dtype(cfg)

    def one():
        return {
            "norm1": layers.rmsnorm_init(cfg.d_model, dt, device=device),
            "self": layers.attn_init(gen, cfg, dt, device=device),
            "norm_x": layers.rmsnorm_init(cfg.d_model, dt, device=device),
            "cross": layers.attn_init(gen, cfg, dt, device=device),
            "norm2": layers.rmsnorm_init(cfg.d_model, dt, device=device),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp,
                                   device=device),
        }

    return {"layers": [one() for _ in range(cfg.n_layers)]}


def cross_decoder_apply(
    params,
    x,
    enc_out,
    cfg: ModelConfig,
    policy: PolicyLike = DENSE,
    *,
    positions=None,
    caches=None,
    token_valid=None,
    block_tables=None,
    paged_kernel=True,
):
    """Run the cross-decoder over ``x [B,S,d]`` and the encoder's output
    ``enc_out [B, enc_seq, d]``. Returns (x, caches).

    Each layer: causal self-attention with RoPE (sites ``self/...``),
    then cross-attention over ``enc_out`` without RoPE or cache (sites
    ``cross/...``; its K/V are projected from ``enc_out`` at every call,
    as in the JAX package), then the MLP. Without ``caches`` (training)
    the self-attention runs over the sequence; with them (serving) it
    writes and reads the per-layer K/V cache, paged or contiguous, as
    :func:`stack_apply`'s attention layers do."""
    per_layer = _layer_scopes(policy, cfg.n_layers)
    if caches is None:
        rope = layers.rope_angles(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                                  cfg.rope_theta)
        qpos = write_index = None
    else:
        qpos, rope, write_index = _decode_geometry(cfg, caches, positions, token_valid,
                                                   block_tables)
    for li, (p, pol) in enumerate(zip(params["layers"], per_layer, strict=True)):
        a, cache = layers.attn_apply(
            p["self"], layers.rmsnorm_apply(p["norm1"], x, cfg.norm_eps), cfg, pol,
            rope=rope, qpos=qpos, kv_cache=None if caches is None else caches[li],
            block_tables=block_tables, write_index=write_index, paged_kernel=paged_kernel,
            site="self",
        )
        if caches is not None:
            caches[li] = cache
        x = x + a
        c, _ = layers.attn_apply(
            p["cross"], layers.rmsnorm_apply(p["norm_x"], x, cfg.norm_eps), cfg, pol,
            rope=None, x_kv=enc_out, site="cross",
        )
        x = x + c
        x = x + layers.mlp_apply(p["mlp"], layers.rmsnorm_apply(p["norm2"], x, cfg.norm_eps),
                                 cfg.act, pol)
    return x, caches
