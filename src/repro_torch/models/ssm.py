"""Mamba-2 SSD (state-space duality) block: chunked scan + per-token decode.

The twin of ``repro.models.ssm``. Within a chunk the recurrence is a
masked attention-like product; across chunks a Python loop carries the
``[B, H, N, P]`` state (the JAX package's ``lax.scan``), all in fp32.
Decode runs the single-token recurrence position by position, as the
JAX package's decode scan does, so a chunk of any width S >= 1 is the
same arithmetic as S single-token steps.

The projections route through ``dense_apply`` (sites ``ssm/in_proj`` and
``ssm/out_proj``), so ssProp applies to them; the scan has no
output-channel product to shrink, and is plain tensor arithmetic here as
in the JAX package.

On a model mesh (``mesh=``) a rank runs its ``H/model`` heads. The
reference splits ``in_proj``'s columns evenly, which cuts across its
``[z | x | B | C | dt]`` parts, so the rank gathers the weight on use and
computes the full product (its gradient summed over ``model`` behind
``copy_to_model``), then keeps its heads' z, x and dt and the whole of B
and C (one group every head shares). ``conv_w`` / ``conv_b`` serve the
rank's x channels and B/C, their partial gradients summed over ``model``;
``A_log``, ``dt_bias``, ``D`` and the norm's scale are sliced to the
rank's heads; the gated RMSNorm's sum of squares is summed over
``model``; ``out_proj`` is row-parallel over the rank's ``d_inner`` rows.
A decode cache holds the rank's state heads ``[B, H/model, N, P]`` and a
conv window over its x channels plus B and C.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.policy import DENSE, PolicyLike
from repro_torch.dist import parallel
from repro_torch.models import layers

_CONV_K = 4  # depthwise causal conv width (mamba default)


def ssm_init(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    """Mamba-2 block params with the JAX package's distributions and
    layouts (``conv_w [K, C]``, fp32 ``A_log`` / ``dt_bias`` / ``D``)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    kw = dict(dtype=dtype, device=device)
    conv_w = torch.randn((_CONV_K, conv_ch), generator=gen, dtype=torch.float32, device=device)
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": layers.dense_init(gen, d, 2 * di + 2 * n + h, **kw),
        "conv_w": (conv_w * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_ch,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": layers.rmsnorm_init(di, dtype, device=device),
        "out_proj": layers.dense_init(gen, di, d, **kw),
    }


def _causal_conv(x, w, b, halo=None):
    """Depthwise causal conv: x [B, L, C], w [K, C] -> [B, L, C]. ``halo
    [B, K-1, C]``: the positions before ``x`` (zeros without it)."""
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)) if halo is None else torch.cat([halo.to(x.dtype), x], dim=1)
    out = 0
    for i in range(k):
        out = out + xp[:, i : i + length] * w[i]
    return out + b


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(proj, [di, di + 2 * n, proj.shape[-1] - 2 * di - 2 * n], dim=-1)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk, seq=None):
    """SSD chunk-parallel scan.

    x [B, L, H, P], dt [B, L, H] (post-softplus, fp32), a_log [H],
    b_mat / c_mat [B, L, N] (one group broadcast over heads); L a
    multiple of ``chunk``. Returns y [B, L, H, P] fp32.

    ``seq`` (a ``models/layers.py::SeqSplit``): the block is one rank's of
    a sequence split over a mesh axis. The scan runs from a zero state;
    the block's total decay and the state it ends in are folded over the
    ranks in order (``dist/parallel.py::seq_fold``) into the state that
    enters the block, whose decayed read-out is added at every position.
    """
    bsz, slen, h, p = x.shape
    n = b_mat.shape[-1]
    nc = slen // chunk
    a = -torch.exp(a_log)  # [H], negative

    xr = x.reshape(bsz, nc, chunk, h, p).float()
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b_mat.reshape(bsz, nc, chunk, n).float()
    cr = c_mat.reshape(bsz, nc, chunk, n).float()

    da = dtr * a  # [B, nc, Q, H]
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative decay

    # ---- intra-chunk (masked attention-like) ----
    # The log-decay from j to i is the segment sum of da over (j, i], taken
    # as a cumsum of da masked to k > j. The JAX package takes it as the
    # difference cum_i - cum_j of two long prefix sums; the backward of
    # that difference weights each position by its whole prefix, and the
    # large terms cancel: in fp32 it puts a relative error of ~4e-4 on a
    # 256-token chunk's A_log gradient, which parts the backward routes
    # (see ``tools/ssm_route_depth.py``).
    ar = torch.arange(chunk, device=x.device)
    after = (ar[:, None] > ar[None, :])[None, None, :, :, None]  # [k, j]: k > j
    seg = torch.cumsum(torch.where(after, da[:, :, :, None, :], 0.0), dim=2)  # [B,nc,i,j,H]
    mask = ar[:, None] >= ar[None, :]
    # Mask the exponent, not the result: exp of a masked +large diff is
    # inf, and where(mask, inf, 0) back-propagates inf*0 = NaN.
    diff = torch.where(mask[None, None, :, :, None], seg, -math.inf)
    decay = torch.exp(diff)
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)  # [B,nc,Q,Q]
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]  # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xr)

    # ---- chunk-final states ----
    # the log-decay from q to the chunk's end, sum of da over (q, Q): a
    # reverse cumsum, shifted (no difference of prefix sums, as above)
    to_end = torch.flip(torch.cumsum(torch.flip(da[:, :, 1:], [2]), dim=2), [2])
    decay_to_end = torch.exp(F.pad(to_end, (0, 0, 0, 1)))  # [B,nc,Q,H]
    weighted = xr * (decay_to_end * dtr)[..., None]  # [B,nc,Q,H,P]
    s_local = torch.einsum("bcqn,bcqhp->bchnp", br, weighted)  # [B,nc,H,N,P]

    # ---- cross-chunk recurrence: the state entering each chunk ----
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    s_prev = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s_prev)
        s_prev = chunk_decay[:, ci, :, None, None] * s_prev + s_local[:, ci]
    s_prevs = torch.stack(s_prevs, dim=1)  # [B,nc,H,N,P]

    # ---- inter-chunk contribution ----
    in_decay = torch.exp(cum)  # decay from chunk start to position i
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cr, s_prevs) * in_decay[..., None]
    y = y_intra + y_inter
    if seq is not None:
        # the state entering this rank's block, and its read-out: the log
        # decay from the block's start to position i is the chunks'
        # totals before i's chunk plus the within-chunk cumsum
        totals = cum[:, :, -1, :]  # [B,nc,H]
        before = F.pad(torch.cumsum(totals[:, :-1], dim=1), (0, 0, 1, 0))
        h_in = parallel.seq_fold(torch.exp(totals.sum(dim=1)), s_prev, seq)
        y = y + torch.einsum("bcqn,bhnp->bcqhp", cr, h_in) * torch.exp(
            before[:, :, None, :] + cum)[..., None]
    return y.reshape(bsz, slen, h, p)


def _decode_scan(p, cfg, xbc, dt, cache, token_valid, spec_states):
    """The single-token recurrence over the S positions of ``xbc [B, S,
    C]`` / ``dt [B, S, H]`` (``p`` the rank's leaves, :func:`_local`);
    invalid tokens leave the conv window and the state as they were.
    Returns (y [B, S, H, P] fp32, new cache)."""
    bsz, s, _ = xbc.shape
    n, h, pd = cfg.ssm_state, dt.shape[-1], cfg.ssm_headdim
    di = h * pd
    a = -torch.exp(p["A_log"])
    conv_state, state = cache["conv"], cache["state"]  # [B,K-1,C], [B,H,N,P]
    cat_dtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    ys, convs, states = [], [], []
    for t in range(s):
        dt_t, valid_t = dt[:, t], token_valid[:, t]
        conv_cat = torch.cat([conv_state.to(cat_dtype), xbc[:, t, None].to(cat_dtype)], dim=1)
        xc = F.silu((conv_cat * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
        xs_t, bm_t, cm_t = torch.split(xc, [di, n, n], dim=-1)
        xh_t = xs_t.reshape(bsz, h, pd).float()
        da = torch.exp(dt_t * a)  # [B,H]
        s_new = da[..., None, None] * state + torch.einsum(
            "bn,bhp->bhnp", bm_t.float(), dt_t[..., None] * xh_t
        )
        y_t = torch.einsum("bn,bhnp->bhp", cm_t.float(), s_new)
        ys.append(y_t + xh_t * p["D"][None, :, None])
        conv_state = torch.where(valid_t[:, None, None], conv_cat[:, 1:], conv_state).to(
            conv_state.dtype
        )
        state = torch.where(valid_t[:, None, None, None], s_new, state)
        if spec_states:
            convs.append(conv_state)
            states.append(state)
    if spec_states:
        new_cache = {"conv": torch.stack(convs, dim=1), "state": torch.stack(states, dim=1)}
    else:
        new_cache = {"conv": conv_state, "state": state}
    return torch.stack(ys, dim=1), new_cache


def local_heads(cfg, mesh) -> tuple[int, int]:
    """The ``[lo, hi)`` SSM heads this rank runs (all of them off a mesh)."""
    h = cfg.n_ssm_heads
    if mesh is None or mesh.model == 1:
        return 0, h
    if h % mesh.model:
        raise NotImplementedError(f"a model mesh of {mesh.model} does not divide {h} SSM heads")
    n = h // mesh.model
    return mesh.model_rank * n, (mesh.model_rank + 1) * n


def conv_channels(cfg, lo: int, hi: int, device=None) -> torch.Tensor:
    """The conv channels heads ``[lo, hi)`` read: their x channels, then B
    and C (``[x (d_inner) | B | C]`` is the conv's channel layout), made on
    ``device`` (a copy from host memory would stall the host each layer)."""
    di, pd = cfg.d_inner, cfg.ssm_headdim
    return torch.cat([torch.arange(lo * pd, hi * pd, device=device),
                      torch.arange(di, di + 2 * cfg.ssm_state, device=device)])


def _local(p, x, cfg, policy, mesh):
    """``(proj pieces z, xbc, dt, the rank's leaves)``: off a mesh the
    layer's own; on a model mesh the rank's heads (see the module
    docstring)."""
    if mesh is None or mesh.model == 1:
        proj = layers.dense_apply(p["in_proj"], x, policy, site="ssm/in_proj", mesh=mesh)
        z, xbc, dt = _split_proj(cfg, proj)
        leaves = {k: p[k] for k in ("conv_w", "conv_b", "A_log", "dt_bias", "D")}
        return z, xbc, dt, dict(leaves, norm=p["norm"]["scale"])
    width = p["in_proj"]["w"].shape[-1]
    held = width == site_cols(cfg)  # gathered at load (serving: ``model.decode_params``)
    if not held and width * mesh.model != site_cols(cfg):
        raise NotImplementedError(f"{cfg.name}: in_proj split off its columns on a mesh")
    lo, hi = local_heads(cfg, mesh)
    pd = cfg.ssm_headdim
    proj = parallel.copy_to_model(layers.dense_apply(
        p["in_proj"], x, policy, site="ssm/in_proj", mesh=None if held else mesh,
        split="gather"), mesh)
    z, xbc, dt = _split_proj(cfg, proj)
    ch = conv_channels(cfg, lo, hi, device=x.device)
    leaves = {k: parallel.copy_to_model(p[k], mesh).index_select(-1, ch)
              for k in ("conv_w", "conv_b")}
    for k in ("A_log", "dt_bias", "D"):
        leaves[k] = parallel.slice_for_model(p[k], mesh)
    leaves["norm"] = parallel.slice_for_model(p["norm"]["scale"], mesh)
    return (z[..., lo * pd:hi * pd], xbc.index_select(-1, ch), dt[..., lo:hi], leaves)


def site_cols(cfg) -> int:
    """``in_proj``'s output width: ``[z | x | B | C | dt]``."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads


def _gated_norm(scale, y, eps, width, mesh):
    """RMSNorm over the full ``d_inner`` of ``y``'s (the rank's) columns:
    the sum of squares summed over ``model``."""
    if mesh is None or mesh.model == 1:
        return layers.rmsnorm_apply({"scale": scale}, y, eps)
    y32 = y.float()
    ss = parallel.sum_stat_over_model(torch.sum(y32 * y32, dim=-1, keepdim=True), mesh)
    return (y32 * torch.rsqrt(ss / width + eps) * scale.float()).to(y.dtype)


def ssm_apply(
    p, x, cfg, policy: PolicyLike = DENSE, cache=None, token_valid=None, spec_states=False,
    mesh=None,
):
    """Mamba-2 block. x [B, S, d] -> (out [B, S, d], new cache or None).

    Without ``cache``: the full sequence, padded to a multiple of
    ``ssm_chunk`` for :func:`ssd_chunked`. Where the step splits the
    sequence over a data axis (``mesh.seq``) the rank's block is padded at
    its end (zero ``dt`` there: the state passes through unchanged), its
    causal conv reads the previous rank's last positions
    (``dist/parallel.py::seq_halo``) and its scan starts from the state
    the earlier ranks' blocks end in. With ``cache`` = ``{"conv":
    [B, K-1, C], "state": [B, H, N, P]}`` (decode): the per-position
    recurrence over the S tokens; ``token_valid [B, S]`` freezes the conv
    window and the state on padding rows, so slots advance independently.

    ``spec_states=True`` (decode) returns the per-position stacks
    ``{"conv": [B, S, K-1, C], "state": [B, S, H, N, P]}`` in place of the
    final state, so a speculative verifier can commit the state as of any
    accepted prefix (a frozen position carries the previous state on).

    ``mesh``: a model mesh; the rank runs its heads and holds their cache.
    """
    bsz, s, _ = x.shape
    n, pd = cfg.ssm_state, cfg.ssm_headdim
    z, xbc, dt, lp = _local(p, x, cfg, policy, mesh)
    h = dt.shape[-1]
    di = h * pd
    dt = F.softplus(dt.float() + lp["dt_bias"])

    new_cache = None
    if cache is None:
        seq = mesh.seq if mesh is not None else None
        halo = None if seq is None else parallel.seq_halo(xbc, seq, lp["conv_w"].shape[0] - 1)
        xbc = F.silu(_causal_conv(xbc, lp["conv_w"], lp["conv_b"], halo))
        xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
        xh = xs.reshape(bsz, s, h, pd)
        pad = (-s) % cfg.ssm_chunk
        xh_p, dt_p, bm, cm = xh, dt, bmat, cmat
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            bm = F.pad(bmat, (0, 0, 0, pad))
            cm = F.pad(cmat, (0, 0, 0, pad))
        y = ssd_chunked(xh_p, dt_p, lp["A_log"], bm, cm, cfg.ssm_chunk, seq)[:, :s]
        y = y + xh * lp["D"][None, None, :, None]
    else:
        if token_valid is None:
            token_valid = torch.ones((bsz, s), dtype=torch.bool, device=x.device)
        y, new_cache = _decode_scan(lp, cfg, xbc, dt, cache, token_valid, spec_states)

    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(lp["norm"], y, cfg.norm_eps, cfg.d_inner, mesh)
    out = layers.dense_apply(p["out_proj"], y, policy, site="ssm/out_proj", mesh=mesh,
                             split="row")
    return out, new_cache


def shard_cache(cfg, cache, mesh, rows: slice = slice(None)):
    """This rank's part of one SSM layer's decode cache on a mesh: its
    slot ``rows`` (the reference's batch over ``data``), its state heads
    (``model`` on H) and its conv channels (:func:`conv_channels`; the
    port's own layout, never checkpointed)."""
    lo, hi = local_heads(cfg, mesh)
    ch = conv_channels(cfg, lo, hi, device=cache["conv"].device)
    return {"conv": cache["conv"][rows].index_select(-1, ch).contiguous(),
            "state": cache["state"][rows, lo:hi].contiguous()}


def ssm_cache_init(cfg, batch, dtype=torch.float32, device="cuda"):
    """A slot's decode state, ``batch`` slots: the conv window ``[B, K-1,
    C]`` in ``dtype`` and the SSM state ``[B, H, N, P]`` in fp32."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, conv_ch), dtype=dtype, device=device),
        "state": torch.zeros(
            (batch, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
            dtype=torch.float32, device=device,
        ),
    }
