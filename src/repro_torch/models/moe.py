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

Every sort, scatter and combine carries a leading ``[G]`` axis of token
groups. ``dp_groups > 0`` dispatches within that many groups (the data
shards of a mesh), each with its own capacity, and each (group, expert)
pair runs its own ``sparse_dense`` products, as the JAX package vmaps its
expert FFN over both axes; the ungrouped dispatch is the one-group case
(the JAX package keeps two copies of the body, the port one).

On a ``data x model`` mesh (``mesh=``) the experts are split over
``model`` (the reference's expert parallelism: a rank holds ``E/model``
of them). The tokens are replicated over ``model``, so the router, the
top-k and the dispatch run alike on every model rank; each rank runs its
own experts' products, and its combine, a partial sum, is closed by
``reduce_from_model``. The dispatched ``x`` and the combine weights reach
only the rank's experts, so both sit behind ``copy_to_model``; the router
reads ``x`` directly, so the load-balance loss's gradient, the same on
every rank, is not summed ``model`` times. Over ``data``: with
``dp_groups`` a multiple of the data size each data rank dispatches its
own groups; otherwise (the global dispatch) every rank places every
token by the all-gathered top-k ids in global order, fills its own
tokens' capacity slots and leaves the others' zero, so capacity and
drops are the one-device step's, and each expert's selection sums its
importance over ``data`` (``SiteMesh(rows="padded")``). ``aux_loss`` and
``dropped`` are the global ones on every rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.dense import sparse_dense
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.dist import parallel
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


def _expert_ffn(gate_w, up_w, down_w, xb, act, pols, site_mesh=None):
    """The experts' gated FFNs on their ``[E, capacity, d]`` buffers.

    ``pols`` = the (gate, up, down) policies (sites ``moe/gate``,
    ``moe/up``, ``moe/down``). A site whose policy is active takes each
    expert's product through ``sparse_dense`` on its own, so each expert
    selects over its own cotangent, as the JAX package's vmap does.
    ``site_mesh(name, i)``: on a mesh, the ``SiteMesh`` of local expert
    ``i``'s ``name`` product."""
    fn = layers._ACTS[act]

    def product(x, w, pol, name):  # x [..., E, cap, d_in] @ w [E, d_in, d_out]
        if pol.active and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            xs = x.reshape(-1, *x.shape[-3:])
            out = torch.stack([
                torch.stack([sparse_dense(xg[i], w[i], policy=pol,
                                          mesh=site_mesh and site_mesh(name, i))
                             for i in range(w.shape[0])])
                for xg in xs])
            return out.reshape(*x.shape[:-1], w.shape[-1])
        t = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(t), w.to(t))

    h = fn(product(xb, gate_w, pols[0], "gate")) * product(xb, up_w, pols[1], "up")
    return product(h, down_w, pols[2], "down")


def expert_site(name: str, e: int) -> str:
    """The name a routed expert's product records its selection under on
    a mesh: ``moe/{name}[{e}]``, ``e`` the global expert id."""
    return f"moe/{name}[{e}]"


def local_experts(cfg, mesh) -> tuple[int, int]:
    """The ``[lo, hi)`` experts this rank holds (all of them off a mesh)."""
    e = cfg.n_experts
    if mesh is None or mesh.model == 1:
        return 0, e
    if e % mesh.model:
        raise NotImplementedError(f"a model mesh of {mesh.model} does not divide {e} experts")
    n = e // mesh.model
    return mesh.model_rank * n, (mesh.model_rank + 1) * n


def dispatch_groups(dp_groups: int, tokens: int, full_capacity: bool,
                    data: int = 1, seq_split: bool = False) -> tuple[int, int]:
    """``(groups, local groups)`` of a step over ``tokens`` tokens in all
    (every data rank's): ``dp_groups`` where it divides the tokens (else
    1, the ungrouped dispatch), and how many of them a data rank of
    ``data`` takes part in: every group under the global dispatch or where
    the ranks hold blocks of the sequence (``seq_split``: a group, the
    reference's ``T/G`` consecutive tokens of the flattened batch, may
    span ranks), else its own ``G/data``."""
    g = dp_groups if dp_groups and tokens % dp_groups == 0 and not full_capacity else 1
    if data == 1 or g == 1 or seq_split:
        return g, g
    if g % data:
        raise NotImplementedError(f"moe_dp_groups={g} on a data mesh of {data}")
    return g, g // data


def _expert_policies(policy: PolicyLike):
    return tuple(policy_for(policy, f"moe/{s}") for s in ("gate", "up", "down"))


def moe_apply(p, x, cfg, policy: PolicyLike = DENSE, *, full_capacity: bool = False,
              dp_groups: int = 0, mesh=None):
    """x [B, S, d] -> ([B, S, d], {"aux_loss", "dropped"}).

    Router in fp32; ``top_k`` weights renormalised; the Switch
    load-balance loss ``E * sum(mean prob * routed share)``; dispatch by a
    stable argsort over expert ids with group starts from
    ``searchsorted``; per-expert capacity ``max(1, int(T*k/E *
    capacity_factor))``, or T with ``full_capacity`` (decode: no token can
    be dropped); overflow zeroed and counted in ``dropped``; the combine a
    scatter to ``order`` in fp32; plus the shared expert.

    ``dp_groups`` with ``B*S % dp_groups == 0`` and not ``full_capacity``
    dispatches within that many token groups of ``T/G`` tokens, each with
    its own capacity ``max(1, int(T/G*k/E * capacity_factor))``; otherwise
    there is one group. ``aux_loss`` and ``dropped`` are taken over all
    groups. ``mesh``: this rank's rows and experts (module docstring).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_topk
    data = mesh.dp if mesh is not None else 1
    t_loc = b * s
    tokens = t_loc * data  # every data rank holds as many tokens
    layout = mesh.layout if mesh is not None and data > 1 else None
    seq_split = layout is not None and layout.seq_split
    g, g_loc = dispatch_groups(dp_groups, tokens, full_capacity, data, seq_split)
    spread = data > 1 and g_loc == g  # every group over every data rank's tokens
    tg = tokens // g
    dev = x.device
    e_lo, e_hi = local_experts(cfg, mesh)

    logits = layers.dense_apply(p["router"], x.reshape(t_loc, d).float(), DENSE)
    probs = torch.softmax(logits, dim=-1)  # [t_loc, E]
    topw, topi = torch.topk(probs, k, dim=-1)  # [t_loc, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance aux (Switch-style), over every data rank's tokens ----
    counts_e = torch.bincount(topi.reshape(-1), minlength=e).float()
    if data > 1:
        me = parallel.sum_over_data(probs.sum(0), mesh) / tokens
        counts_e = parallel.all_reduce(counts_e, mesh.data_group)
    else:
        me = probs.mean(0)
    aux_loss = e * torch.sum(me * (counts_e / (tokens * k)))

    # ---- sort-based dispatch, within each group ----
    # the groups this rank dispatches: its own (g_loc of tg tokens), or
    # every group of every rank's tokens, placed in global order by the
    # all-gathered ids (and, for blocks of the sequence, the tokens' global
    # indices)
    ids, local_of = topi, None
    if spread:
        ids = parallel.gather_ids_over_data(topi, mesh)  # [tokens, k], rank-major
        if seq_split:
            where = layout.token_index(dev)
            every = parallel.gather_ids_over_data(where, mesh)
            ids = torch.empty_like(ids).index_copy_(0, every, ids)
            local_of = torch.full((tokens,), -1, dtype=torch.long, device=dev)
            local_of[where] = torch.arange(t_loc, device=dev)
        else:
            off = mesh.data_rank * t_loc  # this rank's first token
            local_of = torch.arange(tokens, device=dev) - off
            local_of = torch.where((local_of >= 0) & (local_of < t_loc), local_of, -1)
    gd = g_loc
    n = tg * k
    cap = tokens if full_capacity else max(1, int(tg * k / e * cfg.capacity_factor))
    flat_e = ids.reshape(gd, n)
    order = torch.argsort(flat_e, dim=1, stable=True)  # group by expert
    sorted_e = flat_e.gather(1, order)
    sorted_tok = order // k  # source token of each slot, within the group
    experts = torch.arange(e, device=dev).expand(gd, e).contiguous()
    grp_start = torch.searchsorted(sorted_e, experts, side="left")  # [G, E]
    counts = torch.searchsorted(sorted_e, experts, side="right") - grp_start
    pos = torch.arange(n, device=dev)[None, :] - grp_start.gather(1, sorted_e)
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)
    gidx = torch.arange(gd, device=dev)[:, None].expand(gd, n)
    tok = gidx * tg + sorted_tok  # the slot's token: global (spread) or the rank's own
    if spread:
        tok = local_of[tok]  # its row on this rank, or -1
    own = tok >= 0
    mine = (sorted_e >= e_lo) & (sorted_e < e_hi)

    # The JAX package writes every slot with one ``.at[].set`` scatter, in
    # which the overflow's clamped duplicates of slot cap-1 all land on
    # it and the last write wins (XLA's scatter, in sorted order): the
    # slot holds a dropped entry's zeros when its expert overflows. Write
    # exactly those last writers, whose indices are unique (a rank: its
    # experts' slots, its own tokens' values).
    xf = parallel.copy_to_model(x, mesh).reshape(-1, d)
    last = ((pos < cap - 1) | (pos == counts.gather(1, sorted_e) - 1)) & mine
    src_tok = torch.clamp(tok, 0, t_loc - 1)  # rows of xf
    src = torch.where((keep & own)[..., None], xf[src_tok],
                      torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros((gd, e_hi - e_lo, cap, d), dtype=x.dtype, device=dev).index_put(
        (gidx[last], sorted_e[last] - e_lo, pos_c[last]), src[last]
    )

    # every (group, expert) pair its own sparse products
    site_mesh = None
    if mesh is not None:
        rows = "padded" if spread else "local" if data > 1 else "split"

        def site_mesh(name, i):
            return parallel.SiteMesh(mesh, col=False, rows=rows,
                                     site=mesh.prefix + expert_site(name, e_lo + i))

    out_buf = _expert_ffn(p["gate"], p["up"], p["down"], buf, cfg.act,
                          _expert_policies(policy), site_mesh)  # [G, E_loc, cap, d]

    # ---- combine: this rank's tokens, from this rank's experts ----
    take = keep & own & mine
    gathered = out_buf[gidx[take], sorted_e[take] - e_lo, pos_c[take]]
    slot = tok * k + order % k  # the (token, choice) on this rank
    contrib = torch.zeros((t_loc * k, d), dtype=torch.float32, device=dev).index_put(
        (slot[take],), gathered.float())
    w = parallel.copy_to_model(topw, mesh)
    contrib = contrib.reshape(t_loc, k, d) * w[..., None]
    y = parallel.reduce_from_model(contrib.sum(dim=1), mesh).to(x.dtype)

    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], x.reshape(t_loc, d), cfg.act, policy,
                                 site="moe/shared", mesh=mesh,
                                 d_ff=cfg.d_ff * cfg.n_shared_experts)

    n_keep = keep.float().sum()
    if data > 1 and not spread:
        n_keep = parallel.all_reduce(n_keep.clone(), mesh.data_group)
    frac_dropped = 1.0 - n_keep * (1.0 / (tokens * k))  # the JAX package's mean: by the reciprocal
    return y.reshape(b, s, d), {"aux_loss": aux_loss, "dropped": frac_dropped}
