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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.policy import DENSE, PolicyLike
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


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B, L, C], w [K, C] -> [B, L, C]."""
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i : i + length] * w[i]
    return out + b


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(proj, [di, di + 2 * n, proj.shape[-1] - 2 * di - 2 * n], dim=-1)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk):
    """SSD chunk-parallel scan.

    x [B, L, H, P], dt [B, L, H] (post-softplus, fp32), a_log [H],
    b_mat / c_mat [B, L, N] (one group broadcast over heads); L a
    multiple of ``chunk``. Returns y [B, L, H, P] fp32.
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
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # Mask the exponent, not the result: exp of a masked +large diff is
    # inf, and where(mask, inf, 0) back-propagates inf*0 = NaN.
    diff = torch.where(mask[None, None, :, :, None], diff, -math.inf)
    decay = torch.exp(diff)
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)  # [B,nc,Q,Q]
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]  # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xr)

    # ---- chunk-final states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
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
    return (y_intra + y_inter).reshape(bsz, slen, h, p)


def _decode_scan(p, cfg, xbc, dt, cache, token_valid, spec_states):
    """The single-token recurrence over the S positions of ``xbc [B, S,
    C]`` / ``dt [B, S, H]``; invalid tokens leave the conv window and
    the state as they were. Returns (y [B, S, H, P] fp32, new cache)."""
    bsz, s, _ = xbc.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
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


def ssm_apply(
    p, x, cfg, policy: PolicyLike = DENSE, cache=None, token_valid=None, spec_states=False
):
    """Mamba-2 block. x [B, S, d] -> (out [B, S, d], new cache or None).

    Without ``cache``: the full sequence, padded to a multiple of
    ``ssm_chunk`` for :func:`ssd_chunked`. With ``cache`` = ``{"conv":
    [B, K-1, C], "state": [B, H, N, P]}`` (decode): the per-position
    recurrence over the S tokens; ``token_valid [B, S]`` freezes the conv
    window and the state on padding rows, so slots advance independently.

    ``spec_states=True`` (decode) returns the per-position stacks
    ``{"conv": [B, S, K-1, C], "state": [B, S, H, N, P]}`` in place of the
    final state, so a speculative verifier can commit the state as of any
    accepted prefix (a frozen position carries the previous state on).
    """
    bsz, s, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim

    proj = layers.dense_apply(p["in_proj"], x, policy, site="ssm/in_proj")
    z, xbc, dt = _split_proj(cfg, proj)
    dt = F.softplus(dt.float() + p["dt_bias"])

    new_cache = None
    if cache is None:
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
        xh = xs.reshape(bsz, s, h, pd)
        pad = (-s) % cfg.ssm_chunk
        xh_p, dt_p, bm, cm = xh, dt, bmat, cmat
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            bm = F.pad(bmat, (0, 0, 0, pad))
            cm = F.pad(cmat, (0, 0, 0, pad))
        y = ssd_chunked(xh_p, dt_p, p["A_log"], bm, cm, cfg.ssm_chunk)[:, :s]
        y = y + xh * p["D"][None, None, :, None]
    else:
        if token_valid is None:
            token_valid = torch.ones((bsz, s), dtype=torch.bool, device=x.device)
        y, new_cache = _decode_scan(p, cfg, xbc, dt, cache, token_valid, spec_states)

    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rmsnorm_apply(p["norm"], y, cfg.norm_eps)
    out = layers.dense_apply(p["out_proj"], y, policy, site="ssm/out_proj")
    return out, new_cache


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
