"""Top-level LM: embeddings + stack + loss + the per-slot decode API.

The twin of ``repro.models.model`` for every family (dense, moe, ssm,
hybrid, encdec, vlm):

  * ``init_params(cfg, seed, device)``          -> params
  * ``params_from_jax(cfg, tree, device)``      -> params from a JAX param tree
  * ``site_names(cfg)``                         -> (sites, depth)
  * ``forward(cfg, params, batch, policy)``     -> (logits fp32, aux)
  * ``loss_fn(cfg, params, batch, policy)``     -> (loss, metrics)
  * ``kernel_launches_per_step(cfg, policy)``   -> the kernels a train step launches
  * ``init_cache(cfg, batch, max_seq, dtype, device)``   -> the contiguous cache
  * ``init_paged_cache(cfg, n_blocks, block_size, dtype, device, batch=)``
  * ``decode_slots(cfg, params, tokens, cache, slot_pos, token_count, ...)``
  * ``decode_step(cfg, params, tokens, cache, pos)``      -> lock-step decode
  * ``encode(cfg, params, frames)``             -> the encoder's output (encdec)
  * ``encode_frames(cfg, params, frames, device)`` -> the same from numpy frames
  * ``commit_spec_cache(cache, keep)``
  * ``reset_slots(cache, free_mask)`` / ``reset_paged(cache, slot_mask, page_mask)``
  * ``swap_out_slot(cache, slot, pages)`` / ``swap_in_slot(cache, data, slot, pages)``

Batches are dicts of tensors: ``tokens [B,S]``, ``targets [B,S]`` and
optionally ``loss_mask [B,S]``; a vlm batch adds ``patches [B,
n_patches, d_model]`` (the stubbed vision frontend's output), an encdec
batch ``frames [B, enc_seq, d_model]`` (the stubbed audio frontend's).

Params are nested dicts of tensors in the JAX package's layouts, with
each stack as a list of per-layer dicts instead of stacked arrays: the
decoder-only families' ``stack``, the encdec family's ``encoder``,
``enc_norm`` and ``decoder``. A decode cache is a list of per-layer
dicts: ``{"k", "v"}`` for an attention layer (the cross-decoder's
self-attention among them; paged: a page pool; contiguous: rows a
slot), ``{"conv", "state"}`` for a Mamba layer (a row a slot either
way). The encoder's output is not cached here: the serving engine keeps
it a slot, and the cross-attention projects its K/V at every step.
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
    params = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device=device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, device=device),
    }
    if cfg.family == "encdec":
        params["encoder"] = transformer.encoder_init(gen, cfg, device)
        params["enc_norm"] = layers.rmsnorm_init(cfg.d_model, dt, device=device)
        params["decoder"] = transformer.cross_decoder_init(gen, cfg, device)
    else:
        params["stack"] = transformer.stack_init(gen, cfg, device)
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> dict[str, Any]:
    """The port's params from a JAX param tree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``). The JAX package stacks
    each period slot's leaves ``[n_periods, ...]``, so layer ``i * plen +
    j`` is ``tree["stack"]["slots"][j][...][i]``; the encdec family's
    ``encoder`` and ``decoder`` leaves are stacked ``[n_layers, ...]``."""

    def convert(node, pi=None):
        if isinstance(node, dict):
            return {k: convert(v, pi) for k, v in node.items()}
        return _tensor(node if pi is None else np.asarray(node)[pi], device)

    out = {"embed": convert(tree["embed"]), "final_norm": convert(tree["final_norm"])}
    if cfg.family == "encdec":
        out["encoder"] = {"layers": [convert(tree["encoder"], i)
                                     for i in range(cfg.n_enc_layers)]}
        out["enc_norm"] = convert(tree["enc_norm"])
        out["decoder"] = {"layers": [convert(tree["decoder"], i) for i in range(cfg.n_layers)]}
        return out
    plen = len(transformer.period_pattern(cfg))
    slots = tree["stack"]["slots"]
    out["stack"] = {"layers": [convert(slots[li % plen], li // plen)
                               for li in range(cfg.n_layers)]}
    return out


def site_names(cfg: ModelConfig):
    """Every sparsifiable call site of this model and the depth negative
    layer indices in rule patterns resolve against: ``(sites, depth)``,
    the inputs of :meth:`~repro_torch.core.policy.PolicyProgram.resolve`.
    The encdec family's are the encoder's (``enc/layer_{i}/...``) and then
    the cross-decoder's."""
    if cfg.family == "encdec":
        sites = transformer.encoder_sites(cfg) + transformer.cross_decoder_sites(cfg)
    else:
        sites = transformer.stack_sites(cfg)
    return sites, cfg.n_layers


def _embed_inputs(cfg, params, batch):
    """Token embeddings, with the VLM's patch prefix in front."""
    x = layers.embed_apply(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params, batch, policy: PolicyLike = DENSE):
    """Full-sequence forward. Returns (logits fp32 [B, S, V], aux loss):
    the MoE layers' load-balance losses summed (0 without MoE layers).

    vlm: the patches go in front of the tokens, and their positions are
    cut off after the final norm, so a token at index i sits at position
    ``n_patches + i`` and the logits are the tokens' alone. encdec: the
    encoder runs over ``frames`` (in the params' dtype), its output
    normed, and the cross-decoder attends to it."""
    x = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"].to(x.dtype), policy)
        x, _ = transformer.cross_decoder_apply(params["decoder"], x, enc, cfg, policy)
    else:
        x, _, aux = transformer.stack_apply(params["stack"], x, cfg, policy)
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches :]
    logits = layers.unembed_apply(params["embed"], x, valid=cfg.vocab)
    return logits, aux


def encode(cfg: ModelConfig, params, frames: torch.Tensor, policy: PolicyLike = DENSE):
    """The encdec family's encoder pass: ``frames [B, enc_seq, d]`` ->
    the normed encoder output the cross-decoder attends to (serving runs
    it once a request, at admission)."""
    enc = transformer.encoder_apply(params["encoder"], frames, cfg, policy)
    return layers.rmsnorm_apply(params["enc_norm"], enc, cfg.norm_eps)


def encode_frames(cfg: ModelConfig, params, frames: np.ndarray, device) -> torch.Tensor:
    """:func:`encode` of numpy ``frames [B, enc_seq, d]`` (a request's, as
    the workload draws them): on ``device`` in ``cfg.dtype``, no grad."""
    x = torch.from_numpy(np.asarray(frames, np.float32)).to(device)
    with torch.no_grad():
        return encode(cfg, params, x.to(getattr(torch, cfg.dtype)))


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


_EXPERT_SITES = ("moe/gate", "moe/up", "moe/down")  # a launch a product an expert


def kernel_launches_per_step(cfg: ModelConfig, policy: PolicyLike) -> dict[str, int]:
    """Launches of each backward kernel in one training step under
    ``policy`` (a plain policy or a step's table), site by site by the
    engine's rules: a sparse site on the kernel route (``use_pallas``,
    not ``mask_mode``) launches one dX product if ``sparsify_dx`` and one
    dW product if ``sparsify_dw``, through ``matmul`` at channel
    granularity and ``dx_gathered`` / ``dw_gathered`` at block
    granularity. Every site's input needs a gradient (the embedding
    table and the norms' scales train), so layer 0 launches its dX
    products too, the encoder's first layer among them. The routed
    experts' sites (``moe/gate``, ``moe/up``, ``moe/down``) launch their
    products once an expert."""
    n = {"matmul": 0, "dx_gathered": 0, "dw_gathered": 0}
    for site in site_names(cfg)[0]:
        p = policy_for(policy, site)
        if not (p.active and p.use_pallas and not p.mask_mode):
            continue
        per = cfg.n_experts if site.split("/", 1)[1] in _EXPERT_SITES else 1
        if p.granularity == "channel":
            n["matmul"] += per * (p.sparsify_dx + p.sparsify_dw)
        else:
            n["dx_gathered"] += per * p.sparsify_dx
            n["dw_gathered"] += per * p.sparsify_dw
    return n



def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    """Contiguous decode cache: per attention layer K/V rows ``[batch,
    max_seq, KV, hd]``, one row set per slot; per SSM layer its conv
    window and state, a row per slot."""
    dt = dtype or getattr(torch, cfg.dtype)
    return transformer.stack_cache_init(cfg, batch, max_seq, dt, device=device)


def init_paged_cache(
    cfg: ModelConfig, n_blocks: int, block_size: int, dtype=None, device="cuda", *, batch: int = 0
):
    """Paged decode cache: per attention layer a K/V page pool
    ``[n_blocks, block_size, KV, hd]``; per SSM layer its conv window and
    state for ``batch`` slots (the JAX package's first argument, here a
    keyword: a stack without SSM layers keeps no per-slot state)."""
    dt = dtype or getattr(torch, cfg.dtype)
    if batch < 1 and any(s.mixer == "ssm" for s in transformer.period_pattern(cfg)):
        raise ValueError(f"{cfg.name}: a paged cache of SSM layers needs the slot count (batch=)")
    return transformer.stack_cache_init(cfg, batch, block_size, dt, n_pages=n_blocks,
                                        device=device)


def decode_slots(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B, C] — up to C tokens per slot this step
    cache,
    slot_pos: torch.Tensor,  # [B]: per-slot cache write position
    token_count: torch.Tensor,  # [B]: real tokens per slot (0 = idle slot)
    *,
    enc_out: torch.Tensor | None = None,  # [B, enc_seq, d] (encdec)
    block_tables: torch.Tensor | None = None,  # [B, NB] int32 (paged cache)
    paged_kernel: bool = True,
    all_logits: bool = False,
    spec_states: bool = False,
):
    """Mixed prefill/decode step over independently positioned slots.

    Every batch row is a slot with its own write position: decode slots
    feed 1 token, prefilling slots a chunk of up to C prompt tokens, idle
    slots 0. Slot b's token c is written at position ``slot_pos[b] + c``
    (invalid tokens dropped), in place; attention is causally masked per
    slot, which also fences whatever a previous occupant or a rejected
    draft left past the slot's position.

    With ``block_tables`` the cache is the paged one
    (:func:`init_paged_cache`): position p of slot b lives in page
    ``block_tables[b, p // block_size]`` at offset ``p % block_size``.
    ``paged_kernel`` (default) attends through the paged-attention
    kernel, ``paged_kernel=False`` gathers the pages. Without
    ``block_tables`` the cache is the contiguous one (:func:`init_cache`)
    and attention is plain PyTorch, as the JAX package's is there.

    Returns ``(logits [B, V] fp32 at each slot's last real token,
    cache)``; ``all_logits=True`` returns the whole chunk's ``[B, C, V]``
    (the speculative verifier compares every position). Rows with
    ``token_count == 0`` carry garbage logits the caller must ignore.
    ``spec_states=True`` makes each SSM layer's cache entry the
    per-position stacks (``conv [B, C, ...]`` / ``state [B, C, ...]``),
    so that :func:`commit_spec_cache` can select the state as of an
    accepted prefix; K/V are position-addressed and unchanged.

    encdec: ``enc_out`` is each slot's encoder output (:func:`encode`),
    which every layer's cross-attention reads. vlm: the tokens alone, at
    the positions they are given; no patch prefix is fed, as in the JAX
    package's decode.
    """
    b, c = tokens.shape
    ar = torch.arange(c, device=tokens.device)
    positions = slot_pos.long()[:, None] + ar[None, :]  # [B, C]
    valid = ar[None, :] < token_count.long()[:, None]  # [B, C]
    x = layers.embed_apply(params["embed"], tokens)
    if cfg.family == "encdec":
        if enc_out is None:
            raise ValueError(f"{cfg.name}: an encdec decode step needs enc_out")
        x, cache = transformer.cross_decoder_apply(
            params["decoder"], x, enc_out, cfg,
            positions=positions, caches=cache, token_valid=valid, block_tables=block_tables,
            paged_kernel=paged_kernel,
        )
    else:
        x, cache, _ = transformer.stack_apply(
            params["stack"], x, cfg,
            positions=positions, caches=cache, token_valid=valid, block_tables=block_tables,
            paged_kernel=paged_kernel, spec_states=spec_states,
        )
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if all_logits:
        return layers.unembed_apply(params["embed"], x, valid=cfg.vocab), cache
    last = torch.clamp(token_count.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), last][:, None]  # [B, 1, d]
    logits = layers.unembed_apply(params["embed"], x_last, valid=cfg.vocab)[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos: int, *,
                enc_out: torch.Tensor | None = None):
    """One lock-step decode step over the contiguous cache: every row
    writes its ``S`` tokens at ``pos .. pos + S - 1``. The uniform-position
    case of :func:`decode_slots` (the JAX package writes it with one
    ``dynamic_update_slice``; the rows and the mask are the same).
    ``enc_out``: the rows' encoder outputs (encdec).
    Returns (logits [B, V] at the last position, cache)."""
    b, s = tokens.shape
    kv = transformer.kv_layers(cache)
    t = cache[kv[0]]["k"].shape[1] if kv else pos + s
    if pos + s > t:
        raise ValueError(f"decode_step writes positions {pos}..{pos + s - 1} past max_seq {t}")
    dev = tokens.device
    slot_pos = torch.full((b,), pos, dtype=torch.int32, device=dev)
    count = torch.full((b,), s, dtype=torch.int32, device=dev)
    return decode_slots(cfg, params, tokens, cache, slot_pos, count, enc_out=enc_out)


def commit_spec_cache(cache, keep: torch.Tensor):
    """Collapse a ``spec_states=True`` cache to the accepted prefix, in
    the list: ``keep [B]`` is how many of the chunk's tokens each slot
    consumed. An SSM layer's stacks ``[B, C, ...]`` become the state at
    position ``clip(keep - 1, 0)`` (a slot with ``keep == 0`` reads
    position 0, which equals the pre-step state since invalid positions
    are frozen). K/V are position-addressed (rejected writes lie past the
    committed position, fenced by the causal mask until overwritten) and
    pass through."""
    idx = torch.clamp(keep.long() - 1, min=0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for li, layer in enumerate(cache):
        if "state" in layer:
            cache[li] = {k: t[rows, idx.to(t.device)] for k, t in layer.items()}
    return cache


def _indices(mask, device) -> torch.Tensor:
    """The set entries of a host bool mask, as a long tensor on ``device``."""
    return torch.as_tensor(np.flatnonzero(np.asarray(mask)), dtype=torch.long, device=device)


def _zero_rows(cache, mask, leaves) -> None:
    """Zero, in place, the rows in the host bool ``mask`` of every
    layer's ``leaves`` (the leading axis: slots or pages)."""
    held = [(layer, [k for k in leaves if k in layer]) for layer in cache]
    held = [(layer, names) for layer, names in held if names]
    if not held:
        return
    idx = _indices(mask, held[0][0][held[0][1][0]].device)
    if not len(idx):
        return
    for layer, names in held:
        for k in names:
            layer[k][idx] = 0


def reset_slots(cache, free_mask) -> None:
    """Zero the contiguous cache rows of the slots in ``free_mask [B]``
    (a host bool array), in place, at every layer: K/V rows and SSM
    states (which carry no position to mask by)."""
    _zero_rows(cache, free_mask, ("k", "v", "conv", "state"))


def reset_paged(cache, slot_mask, page_mask) -> None:
    """Zero freed state in a paged cache, in place: the K/V pages in
    ``page_mask [n_blocks]`` and the SSM rows of the slots in ``slot_mask
    [B]``, at every layer."""
    _zero_rows(cache, page_mask, ("k", "v"))
    _zero_rows(cache, slot_mask, ("conv", "state"))


def swap_out_slot(cache, slot: int, pages):
    """One slot's swappable state of a paged cache, per layer: the K/V of
    its ``pages`` (``[n_pages, bs, KV, hd]`` copies) or its SSM row
    (``conv`` / ``state`` copies), on the cache's device. The bundle plus
    the slot's position restores the request's device state exactly."""
    out = []
    for layer in cache:
        if "k" in layer:
            idx = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=layer["k"].device)
            out.append({k: layer[k].index_select(0, idx) for k in ("k", "v")})
        else:
            out.append({k: t[slot].clone() for k, t in layer.items()})
    return out


def swap_in_slot(cache, data, slot: int, pages) -> None:
    """Write a :func:`swap_out_slot` bundle back into a paged cache, in
    place: K/V at the freshly allocated ``pages`` (the ids may differ from
    swap-out time: page contents are position-addressed within a page),
    SSM rows at ``slot``."""
    for layer, saved in zip(cache, data, strict=True):
        where = slot
        if "k" in layer:
            where = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=layer["k"].device)
        for k, t in layer.items():
            t[where] = saved[k].to(device=t.device, dtype=t.dtype)


def ssm_snapshot(cache):
    """Copies of the SSM layers' states (``{layer: {"conv", "state"}}``):
    what a proposal round must restore, since K/V rows past a position
    are fenced by the mask but a recurrent state is not."""
    return {li: {k: t.clone() for k, t in layer.items()}
            for li, layer in enumerate(cache) if "state" in layer}


def ssm_restore(cache, snap) -> None:
    """Put an :func:`ssm_snapshot` back into ``cache``."""
    for li, layer in snap.items():
        cache[li] = layer
