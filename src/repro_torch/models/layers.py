"""Shared model layers: plain functions on tensors and dict params.

The twin of ``repro.models.layers`` for the dense decoder's serving
path and the CNNs' convolutions. Parameters keep the JAX package's
layouts (dense weights are ``[d_in, d_out]``, conv filters OIHW), so a
JAX param tree converts array for array. ``dense_apply`` is forward
only (the LM's sparse backward is not ported yet); ``conv_apply`` is
the ssProp convolution (:func:`repro_torch.core.conv.sparse_conv2d`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.conv import sparse_conv2d
from repro_torch.core.policy import SsPropPolicy, policy_for
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


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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
    policy: SsPropPolicy,
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
    page, off)``, so that token ``[rows[i], cols[i]]`` is written at
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
    return rows, cols, page[rows, cols], (logical % block_size)[rows, cols]


def attn_apply(
    p,
    x,
    cfg,
    *,
    qpos,
    kv_cache,
    block_tables,
    rope,
    write_index,
    paged_kernel=True,
):
    """Causal self-attention over the paged KV cache.

    x [B,S,d]; ``qpos [B,S]`` int32, each token's absolute position in
    its slot. ``kv_cache`` = dict(k, v): one layer's page pool ``[n_pages,
    bs, KV, D]`` shared by all slots; slot b's token at position p lives
    in page ``block_tables[b, p // bs]`` at offset ``p % bs``. This step's
    K/V are written **in place** into the pools (cast to the pool dtype)
    at ``write_index`` (:func:`paged_write_index`, which leaves out the
    invalid tokens). ``qpos``, ``rope`` (:func:`rope_angles` of the
    positions) and ``write_index`` are the same at every layer of a step,
    so the stack makes them once and passes them in.

    ``paged_kernel=True`` (the default) attends through the
    paged-attention kernel, which reads the pages in place;
    ``paged_kernel=False`` takes the gather route, the kernel's plain
    version :func:`~repro_torch.kernels.paged_attention.paged_attention_ref`
    (K/V gathered through the clipped table, masked fp32 softmax).
    Returns (out [B,S,d], kv_cache).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = dense_apply(p["q"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense_apply(p["k"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense_apply(p["v"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)

    k_pool, v_pool = kv_cache["k"], kv_cache["v"]
    rows, cols, page, off = write_index
    k_pool[page, off] = k[rows, cols].to(k_pool.dtype)
    v_pool[page, off] = v[rows, cols].to(v_pool.dtype)
    if paged_kernel:
        out = kops.paged_attention(q, k_pool, v_pool, block_tables, qpos)
    else:
        out = paged_attention_ref(q, k_pool, v_pool, block_tables, qpos).to(q.dtype)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return dense_apply(p["o"], out), kv_cache


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


def mlp_apply(p, x, act: str):
    try:
        fn = _ACTS[act]
    except KeyError:
        raise NotImplementedError(f"activation {act!r} is not ported yet") from None
    h = fn(dense_apply(p["gate"], x)) * dense_apply(p["up"], x)
    return dense_apply(p["down"], h)


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
