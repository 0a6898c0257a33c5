"""Shared model layers: plain functions on tensors and dict params.

The twin of ``repro.models.layers`` for the dense decoder (training and
paged serving) and the CNNs' convolutions. Parameters keep the JAX
package's layouts (dense weights are ``[d_in, d_out]``, conv filters
OIHW), so a JAX param tree converts array for array. Every projection
goes through :func:`dense_apply` (the ssProp linear layer,
:func:`repro_torch.core.dense.sparse_dense`) and every convolution
through :func:`conv_apply` (:func:`repro_torch.core.conv.sparse_conv2d`).

Every call site carries a site name (``site=``): a plain
:class:`~repro_torch.core.policy.SsPropPolicy` ignores it, while a
:class:`~repro_torch.core.policy.SitePolicies` table gives each named
site its own policy. Serving passes no policy (dense) and asks for no
gradient, so its projections are plain matmuls.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.conv import sparse_conv2d
from repro_torch.core.dense import sparse_dense
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import paged_attention_ref

# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------


def dense_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16, scale=None, device="cuda"):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x, policy: PolicyLike = DENSE, key=None, site: str = ""):
    return sparse_dense(x, p["w"], p.get("b"), policy=policy_for(policy, site), key=key)


def conv2d_init(gen, c_out, c_in, k, *, bias=False, dtype=torch.float32, device="cuda"):
    """Kaiming-normal OIHW conv params ``{"w"[, "b"]}``, drawn from the
    ``torch.Generator`` ``gen``."""
    fan_in = c_in * k * k
    w = torch.randn((c_out, c_in, k, k), generator=gen, dtype=torch.float32, device=device)
    p = {"w": (w * math.sqrt(2.0 / fan_in)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def conv_apply(
    p,
    x,
    policy: PolicyLike,
    *,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    key=None,
    site: str = "",
):
    """The single conv call site the CNN models share: params dict in,
    ssProp-backward conv out."""
    return sparse_conv2d(
        x,
        p["w"],
        p.get("b"),
        stride=stride,
        padding=padding,
        dilation=dilation,
        groups=groups,
        policy=policy_for(policy, site),
        key=key,
    )


def rmsnorm_init(d, dtype=torch.bfloat16, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each [B, S, 1, D/2], of the rotation at ``positions``
    ([B, S] or [S]). They depend on the positions only, so a step computes
    them once for all its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, angles) -> torch.Tensor:
    """x: [B, S, H, D]; ``angles``: :func:`rope_angles` of x's positions.
    Half-split rotation."""
    cos, sin = angles
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def attn_init(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "k": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "v": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "o": dense_init(
            gen, cfg.n_heads * hd, d,
            scale=1.0 / math.sqrt(2 * cfg.n_layers * cfg.n_heads * hd), **kw,
        ),
    }


def paged_write_index(block_tables, positions, token_valid, block_size):
    """Where this step's real tokens go in a page pool: ``(rows, cols,
    (page, off))``, so that token ``[rows[i], cols[i]]`` is written at
    ``pool[page[i], off[i]]``. The token at absolute position p of slot
    b sits in page ``block_tables[b, p // block_size]`` (block index
    clipped to the table, as the JAX package does) at offset ``p %
    block_size``. Invalid tokens are left out, which is what the JAX
    package's out-of-range ``mode="drop"`` scatter does. Picking the real
    tokens reads the mask back to the host, so a step computes this once
    for all its layers."""
    logical = positions.long()
    blk = torch.clamp(logical // block_size, 0, block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, blk)  # [B,S]
    rows, cols = token_valid.nonzero(as_tuple=True)
    return rows, cols, (page[rows, cols], (logical % block_size)[rows, cols])


def slot_write_index(positions, token_valid, t):
    """Where this step's real tokens go in a contiguous cache ``[B, t,
    KV, hd]``: ``(rows, cols, (rows, tgt))``, so that token ``[rows[i],
    cols[i]]`` is written at ``cache[rows[i], tgt[i]]``, its absolute
    position. Invalid tokens and positions past the cache are left out,
    as the JAX package's out-of-range ``mode="drop"`` scatter does."""
    keep = token_valid & (positions < t)
    rows, cols = keep.nonzero(as_tuple=True)
    return rows, cols, (rows, positions.long()[rows, cols])


def masked_attention(q, k, v, *, q_chunk: int = 1024):
    """Full-sequence causal attention, blocked over query chunks of
    ``q_chunk``.

    q [B,S,H,D], k/v [B,S,KV,D] (GQA: each KV head serves H/KV query
    heads). Scores and softmax in fp32, future positions masked at -1e30,
    as the JAX package's ``masked_attention`` without a cache. Returns
    [B,S,H,D] in q.dtype.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    k_t = k.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)  # [B,H,D,T]
    v_h = v.float().repeat_interleave(h // kv, dim=2).transpose(1, 2)  # [B,H,T,D]
    kv_pos = torch.arange(t, device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        qc = q[:, c0 : c0 + q_chunk].float().transpose(1, 2)  # [B,H,qc,D]
        scores = (qc @ k_t) * scale  # [B,H,qc,T]
        q_pos = torch.arange(c0, c0 + qc.shape[2], device=q.device)
        scores = scores.masked_fill(kv_pos[None, :] > q_pos[:, None], -1e30)
        outs.append((torch.softmax(scores, dim=-1) @ v_h).transpose(1, 2))  # [B,qc,H,D]
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_apply(
    p,
    x,
    cfg,
    policy: PolicyLike = DENSE,
    *,
    rope,
    qpos=None,
    kv_cache=None,
    block_tables=None,
    write_index=None,
    paged_kernel=True,
    site: str = "attn",
):
    """Causal self-attention, full-sequence or over a KV cache.

    x [B,S,d]; ``rope`` is :func:`rope_angles` of the tokens' positions,
    the same at every layer of a step, so the stack makes it once. The
    projections look their policies up as ``{site}/q`` ... ``{site}/o``.

    Without ``kv_cache`` (training): causal :func:`masked_attention` over
    the sequence itself.

    With ``kv_cache`` = dict(k, v) (serving), ``qpos [B,S]`` int32 is each
    token's absolute position in its slot, and this step's K/V are
    written **in place** (cast to the cache dtype) at ``write_index``,
    which leaves out the invalid tokens:

    * with ``block_tables``, the paged layout: ``kv_cache`` is one
      layer's page pool ``[n_pages, bs, KV, D]`` shared by all slots, and
      slot b's token at position p lives in page ``block_tables[b, p //
      bs]`` at offset ``p % bs`` (``write_index`` from
      :func:`paged_write_index`). ``paged_kernel=True`` (the default)
      attends through the paged-attention kernel, which reads the pages
      in place; ``paged_kernel=False`` takes the gather route, the
      kernel's plain version
      :func:`~repro_torch.kernels.paged_attention.paged_attention_ref`;
    * without, the contiguous layout: ``kv_cache`` is ``[B, T, KV, D]``,
      one row set a slot (``write_index`` from :func:`slot_write_index`).
      Attention is the plain per-slot causal one, as in the JAX package,
      which computes this route outside any kernel: the cache read as a
      pool of B pages of T tokens, slot b's table ``[b]``.

    Returns (out [B,S,d], kv_cache).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = dense_apply(p["q"], x, policy, site=f"{site}/q").reshape(b, s, cfg.n_heads, hd)
    k = dense_apply(p["k"], x, policy, site=f"{site}/k").reshape(b, s, cfg.n_kv_heads, hd)
    v = dense_apply(p["v"], x, policy, site=f"{site}/v").reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)

    if kv_cache is None:
        out = masked_attention(q, k, v, q_chunk=cfg.attn_q_chunk)
    else:
        k_pool, v_pool = kv_cache["k"], kv_cache["v"]
        rows, cols, dest = write_index
        k_pool[dest] = k[rows, cols].to(k_pool.dtype)
        v_pool[dest] = v[rows, cols].to(v_pool.dtype)
        if block_tables is None:
            tables = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
            out = paged_attention_ref(q, k_pool, v_pool, tables, qpos).to(q.dtype)
        elif paged_kernel:
            out = kops.paged_attention(q, k_pool, v_pool, block_tables, qpos)
        else:
            out = paged_attention_ref(q, k_pool, v_pool, block_tables, qpos).to(q.dtype)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return dense_apply(p["o"], out, policy, site=f"{site}/o"), kv_cache


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

_ACTS = {"silu": F.silu}


def mlp_init(gen, d_model, d_ff, dtype=torch.bfloat16, gated: bool = True, device="cuda"):
    if not gated:
        raise NotImplementedError("only the gated MLP is ported yet")
    kw = dict(dtype=dtype, device=device)
    return {
        "up": dense_init(gen, d_model, d_ff, **kw),
        "gate": dense_init(gen, d_model, d_ff, **kw),
        "down": dense_init(gen, d_ff, d_model, **kw),
    }


def mlp_apply(p, x, act: str, policy: PolicyLike = DENSE, site: str = "mlp"):
    try:
        fn = _ACTS[act]
    except KeyError:
        raise NotImplementedError(f"activation {act!r} is not ported yet") from None
    h = fn(dense_apply(p["gate"], x, policy, site=f"{site}/gate")) * dense_apply(
        p["up"], x, policy, site=f"{site}/up"
    )
    return dense_apply(p["down"], h, policy, site=f"{site}/down")


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------


def embed_init(gen, vocab, d_model, dtype=torch.bfloat16, device="cuda"):
    t = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=device)
    return {"table": (t * 0.02).to(dtype)}


def embed_apply(p, tokens):
    return p["table"][tokens.long()]


def unembed_apply(p, x, valid: int | None = None):
    """Tied unembedding: x [B,S,d] @ table^T -> logits in fp32.

    Both operands go to fp32 before the product, as the JAX package's
    ``preferred_element_type=float32`` accumulates: rounding 152k logits
    to bf16 would make argmax ties common. ``valid`` masks the logits of
    the padded vocabulary rows to -1e30.
    """
    table = p["table"]
    logits = x.float() @ table.float().t()
    v = table.shape[0]
    if valid is not None and valid < v:
        logits[..., valid:] = -1e30
    return logits
