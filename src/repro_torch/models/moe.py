"""Mixture-of-Experts layer: top-k router + sort-based static dispatch.

The twin of ``repro.models.moe``. Token-to-expert assignments are sorted
by expert id (a stable sort), packed into an ``[E, capacity, d]`` buffer
(overflow dropped), the experts' gated FFNs run over it, and the outputs
are combined with the router weights in fp32.

The JAX package vmaps ``sparse_dense`` over the expert axis, so each
expert selects its own top-k channels over its own ``[capacity, D_out]``
cotangent. The port does the same by running each expert's three
products through :func:`~repro_torch.core.dense.sparse_dense` one expert
at a time whenever the policy of the site is active and a gradient is
wanted (with ``use_pallas`` the shrunk products of each expert are their
own ``matmul`` launches); otherwise the experts run as one batched
product.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.dense import sparse_dense
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.models import layers


def moe_init(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    """Router (fp32), the experts' ``gate`` / ``up`` ``[E, d, ff]`` and
    ``down`` ``[E, ff, d]``, and the shared expert's gated MLP. The expert
    tensors are drawn directly in ``dtype`` (at kimi-k2's width an fp32
    draw of one of them would be a 22.5 GB temporary)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)

    p = {
        "router": layers.dense_init(gen, d, e, dtype=torch.float32, device=device),
        "gate": experts((e, d, ff), 1.0 / math.sqrt(d)),
        "up": experts((e, d, ff), 1.0 / math.sqrt(d)),
        "down": experts((e, ff, d), 1.0 / math.sqrt(ff)),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(
            gen, d, cfg.d_ff * cfg.n_shared_experts, dtype=dtype, device=device
        )
    return p


def _expert_ffn(gate_w, up_w, down_w, xb, act, pols):
    """The experts' gated FFNs on their ``[E, capacity, d]`` buffers.

    ``pols`` = the (gate, up, down) policies (sites ``moe/gate``,
    ``moe/up``, ``moe/down``). A site whose policy is active takes each
    expert's product through ``sparse_dense`` on its own, so each expert
    selects over its own cotangent, as the JAX package's vmap does."""
    fn = layers._ACTS[act]

    def product(x, w, pol):
        if pol.active and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return torch.stack([sparse_dense(x[i], w[i], policy=pol) for i in range(w.shape[0])])
        t = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(t), w.to(t))

    h = fn(product(xb, gate_w, pols[0])) * product(xb, up_w, pols[1])
    return product(h, down_w, pols[2])


def _expert_policies(policy: PolicyLike):
    return tuple(policy_for(policy, f"moe/{s}") for s in ("gate", "up", "down"))


def moe_apply(p, x, cfg, policy: PolicyLike = DENSE, *, full_capacity: bool = False):
    """x [B, S, d] -> ([B, S, d], {"aux_loss", "dropped"}).

    Router in fp32; ``top_k`` weights renormalised; the Switch
    load-balance loss ``E * sum(mean prob * routed share)``; dispatch by a
    stable argsort over expert ids with group starts from
    ``searchsorted``; per-expert capacity ``max(1, int(T*k/E *
    capacity_factor))``, or T with ``full_capacity`` (decode: no token can
    be dropped); overflow zeroed and counted in ``dropped``; the combine a
    scatter to ``order`` in fp32; plus the shared expert.

    ``moe_dp_groups > 0`` (DP-local dispatch for meshes) is not ported.
    """
    if cfg.moe_dp_groups and not full_capacity:
        raise NotImplementedError("DP-local MoE dispatch (moe_dp_groups) is not ported yet")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_topk
    tokens = b * s
    xf = x.reshape(tokens, d)
    dev = x.device

    logits = layers.dense_apply(p["router"], xf.float(), DENSE)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    topw, topi = torch.topk(probs, k, dim=-1)  # [T, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance aux (Switch-style) ----
    me = probs.mean(0)
    counts = torch.bincount(topi.reshape(-1), minlength=e)  # [E]
    ce = counts.float() / (tokens * k)
    aux_loss = e * torch.sum(me * ce)

    # ---- sort-based dispatch ----
    cap = tokens if full_capacity else max(1, int(tokens * k / e * cfg.capacity_factor))
    flat_e = topi.reshape(-1)  # [T*k]
    order = torch.argsort(flat_e, stable=True)  # group by expert
    sorted_e = flat_e[order]
    sorted_tok = order // k  # source token of each slot
    grp_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev), side="left")
    pos = torch.arange(tokens * k, device=dev) - grp_start[sorted_e]
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)

    # The JAX package writes every slot with one ``.at[].set`` scatter, in
    # which the overflow's clamped duplicates of slot cap-1 all land on
    # it and the last write wins (XLA's scatter, in sorted order): the
    # slot holds a dropped entry's zeros when its expert overflows. Write
    # exactly those last writers, whose indices are unique.
    last = (pos < cap - 1) | (pos == counts[sorted_e] - 1)
    src = torch.where(keep[:, None], xf[sorted_tok], torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev).index_put(
        (sorted_e[last], pos_c[last]), src[last]
    )

    out_buf = _expert_ffn(p["gate"], p["up"], p["down"], buf, cfg.act, _expert_policies(policy))

    # ---- combine ----
    gathered = out_buf[sorted_e, pos_c]  # [T*k, d]
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                device=dev))
    contrib = torch.zeros((tokens * k, d), dtype=torch.float32, device=dev).index_copy(
        0, order, gathered.float()
    )
    contrib = contrib.reshape(tokens, k, d) * topw[..., None]
    y = contrib.sum(dim=1).to(x.dtype)

    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], xf, cfg.act, policy, site="moe/shared")

    frac_dropped = 1.0 - keep.float().mean()
    return y.reshape(b, s, d), {"aux_loss": aux_loss, "dropped": frac_dropped}
