"""Public wrappers around the hand-written kernels (twin of ``repro.kernels.ops``).

They keep the JAX package's contracts: the compact dW scattered into
zeros over the kept blocks (dropped blocks exactly 0), the cotangent
rows laid out by :func:`_dy_rows`, the group-blocked zero-padded image
``xg``, the conv dX in NCHW (the kernel computes the interior only),
and the compact filter ``w2k`` gathered here with ``index_select``. Unlike the JAX
package's, they pad no operand to tile multiples: the kernels mask
ragged edges themselves. Kernel-side contracts live in
:mod:`repro_torch.kernels.gathered_matmul` and
:mod:`repro_torch.kernels.paged_attention`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import paged_attention as pa


def _i32(block_idx: torch.Tensor) -> torch.Tensor:
    return block_idx.to(torch.int32).contiguous()


def _same_dtype(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype (one kernel instantiation
    takes one operand type)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t).contiguous(), b.to(t).contiguous()


def dx_gathered(dy, w, block_idx, block_size: int = 128) -> torch.Tensor:
    """dX[M, D_in] = dY[:, kept] @ W[:, kept]^T, the gather in-kernel; fp32."""
    dy, w = _same_dtype(dy, w)
    return gm.dx_gathered(dy, w, _i32(block_idx), block_size=block_size)


def dw_gathered_scatter(x, dy, block_idx, n_out: int, block_size: int = 128) -> torch.Tensor:
    """Full dW[D_in, N] (fp32): the compact kernel output scattered into
    zeros over the kept blocks."""
    x, dy = _same_dtype(x, dy)
    bidx = _i32(block_idx)
    d_in = x.shape[1]
    compact = gm.dw_gathered(x, dy, bidx, block_size=block_size)  # [D_in, KB*bs]
    nb = -(-n_out // block_size)
    dw = torch.zeros((d_in, nb, block_size), dtype=torch.float32, device=x.device)
    dw[:, bidx.long(), :] = compact.reshape(d_in, -1, block_size)
    return dw.reshape(d_in, nb * block_size)[:, :n_out]


def _dy_rows(dy: torch.Tensor, block_size: int) -> torch.Tensor:
    """NCHW cotangent -> ``[B*H_out, W_out, C_pad]`` rows, channels
    zero-padded to a whole number of blocks (contiguous)."""
    b, c_out, h_out, w_out = dy.shape
    c_pad = c_out + (-c_out) % block_size
    rows = dy.permute(0, 2, 3, 1)
    if c_pad == c_out:
        return rows.reshape(b * h_out, w_out, c_out).contiguous()
    out = dy.new_zeros((b, h_out, w_out, c_pad))
    out[..., :c_out] = rows
    return out.reshape(b * h_out, w_out, c_pad)


def _image_rows(x: torch.Tensor, padding, groups: int) -> torch.Tensor:
    """NCHW input -> group-blocked zero-padded rows ``[B*H_pad, G, W_pad,
    Cg]`` (contiguous)."""
    b, c_in, h, w_dim = x.shape
    (ph0, ph1), (pw0, pw1) = padding
    h_pad, w_pad = h + ph0 + ph1, w_dim + pw0 + pw1
    return (
        F.pad(x, (pw0, pw1, ph0, ph1))
        .permute(0, 2, 3, 1)
        .reshape(b, h_pad, w_pad, groups, c_in // groups)
        .permute(0, 1, 3, 2, 4)
        .reshape(b * h_pad, groups, w_pad, c_in // groups)
        .contiguous()
    )


def _compact_filters(w: torch.Tensor, block_idx: torch.Tensor, block_size: int) -> torch.Tensor:
    """OIHW filters -> the kept blocks ``w2k [Kh, Kw, Cg, KB*bs]``, the
    phantom channels of a ragged tail zero."""
    wfull = gm.pad_channels(w.permute(2, 3, 1, 0), block_size)  # [Kh, Kw, Cg, C_pad]
    kh, kw, cg, c_pad = wfull.shape
    return (
        wfull.reshape(kh, kw, cg, c_pad // block_size, block_size)
        .index_select(3, block_idx.long())
        .reshape(kh, kw, cg, -1)
    )


def conv_dw_fused_scatter(
    x, dy, block_idx, *, kh, kw, stride, padding, dilation, groups, block_size=128
) -> torch.Tensor:
    """Canonical conv dW2 ``[Cg*Kh*Kw, C_out]`` (fp32) with the patch
    gather in the kernel; the compact output scattered into zeros over
    the kept output-channel blocks."""
    x, dy = _same_dtype(x, dy)
    bidx = _i32(block_idx)
    cg = x.shape[1] // groups
    c_out, h_out = dy.shape[1], dy.shape[2]
    c_pad = c_out + (-c_out) % block_size
    dy2r = _dy_rows(dy, block_size)
    xg = _image_rows(x, padding, groups)
    compact = gm.conv_dw_fused(
        xg, dy2r, bidx, kh_dim=kh, kw_dim=kw, stride=stride, dilation=dilation,
        h_out=h_out, block_size=block_size, c_out=c_out,
    )  # [Kh, Kw, Cg, KB*bs]
    d_flat = cg * kh * kw
    compact = compact.permute(2, 0, 1, 3).reshape(d_flat, -1, block_size)
    dw = torch.zeros((d_flat, c_pad // block_size, block_size), dtype=torch.float32,
                     device=x.device)
    dw[:, bidx.long(), :] = compact
    return dw.reshape(d_flat, c_pad)[:, :c_out]


def conv_dx_fused(
    dy, w, block_idx, *, hw, stride, padding, dilation, groups, block_size=128
) -> torch.Tensor:
    """Conv dX ``[B, C_in, H, W]`` (fp32) with the col2im in the kernel.

    ``hw`` is the input's (H, W). The kernel computes the interior image
    only (channels innermost); it is returned as an NCHW view of that
    buffer, with no copy. The kept filter blocks are gathered here
    (filters are small next to activations)."""
    dy, w = _same_dtype(dy, w)
    bidx = _i32(block_idx)
    b, c_out = dy.shape[:2]
    h, w_dim = hw
    cg = w.shape[1]
    dy2r = _dy_rows(dy, block_size)
    w2k = _compact_filters(w, bidx, block_size)
    dx = gm.conv_dx_fused(
        dy2r, w2k, bidx, b=b, hw=(h, w_dim), padding=padding, groups=groups, stride=stride,
        dilation=dilation, block_size=block_size, c_out=c_out,
    )  # [B*H, G, W, Cg]
    return (
        dx.reshape(b, h, groups, w_dim, cg)
        .permute(0, 2, 4, 1, 3)
        .reshape(b, groups * cg, h, w_dim)
    )


def matmul(a, b) -> torch.Tensor:
    """A[M, K] @ B[K, N] -> fp32 through the ``matmul`` kernel. Operands
    go to their promoted dtype; strided views (a transpose) are passed
    as they are, and nothing is padded."""
    t = torch.promote_types(a.dtype, b.dtype)
    return gm.matmul(a.to(t), b.to(t))


def importance(dy) -> torch.Tensor:
    """Per-channel mean |dY| over all leading axes: dy [..., N] -> [N]
    fp32, divided by the true row count (the JAX package's pad-and-rescale
    is a TPU tiling artefact)."""
    return gm.importance(dy.reshape(-1, dy.shape[-1]).contiguous())


def paged_attention(q, k_pool, v_pool, block_tables, qpos) -> torch.Tensor:
    """Per-slot causal attention reading K/V pages in place.

    q ``[B,S,H,D]``, pools ``[n_pages, bs, KV, D]``, block_tables
    ``[B, NB]``, qpos ``[B, S]`` -> ``[B, S, H, D]`` in q.dtype. The
    kernel-side contract lives in :mod:`repro_torch.kernels.paged_attention`.
    """
    out = pa.paged_attention(
        q.contiguous(),
        k_pool,
        v_pool,
        block_tables.to(torch.int32).contiguous(),
        qpos.to(torch.int32).contiguous(),
    )
    return out.to(q.dtype)
