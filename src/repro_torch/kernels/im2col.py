"""im2col / patch lowering: conv backward in the canonical 2-D form.

The twin of ``repro.kernels.im2col``. The gathered kernels speak
``X2 [M, D_flat]``, ``W2 [D_flat, C_out]``, ``dY2 [M, C_out]``, so a
conv reaches ``dx_gathered`` / ``dw_gathered`` by columnizing:

  * ``X2`` rows are the ``C_in*Kh*Kw`` receptive-field patches at each
    output position (``M = B*H_out*W_out``), by ``F.unfold``, whose
    columns are ordered ``(c, kh, kw)``, the order of a flattened OIHW
    filter (``tests/test_torch_gathered_matmul.py`` checks it);
  * ``dX2`` goes back to the image by ``F.fold`` (col2im), the exact
    adjoint of the patch extraction.

A 1x1 filter takes no ``unfold``: its patches are the strided view
``x[:, :, ::s, ::s]`` made rows, and its col2im adds ``dX2`` into zeros
at those pixels (the same bits as ``F.fold``; on the card ``F.unfold``
launches a kernel a sample). This is the materializing route: ``X2`` and
``dX2`` are real ``[M, C_in*Kh*Kw]`` buffers. Padding is explicit ``(lo, hi)`` pairs; an
asymmetric one pads the image first, since ``unfold``/``fold`` pad
symmetrically only.
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F


def conv_patches(
    x: torch.Tensor,
    kh: int,
    kw: int,
    stride: tuple[int, int],
    padding,
    dilation: tuple[int, int],
) -> tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor], tuple[int, int]]:
    """Receptive-field patches of ``x [B, C_in, H, W]`` and the col2im;
    ``padding`` is ``((lo, hi), (lo, hi))``.

    Returns ``(x2, col2im, (h_out, w_out))``: ``x2`` is
    ``[B*H_out*W_out, C_in*Kh*Kw]`` with columns ordered ``(c, kh, kw)``,
    and ``col2im`` lifts a cotangent of that shape back to
    ``[B, C_in, H, W]`` (in ``x``'s dtype) by adding each patch element
    to its source pixel.
    """
    (ph0, ph1), (pw0, pw1) = padding
    b, _, h, w = x.shape
    xp = F.pad(x, (pw0, pw1, ph0, ph1)) if (ph0 or ph1 or pw0 or pw1) else x
    hp, wp = xp.shape[2:]
    h_out = (hp - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    w_out = (wp - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    pointwise = kh == 1 and kw == 1
    if pointwise:
        picked = xp[:, :, :: stride[0], :: stride[1]]  # [B, C, H_out, W_out]
        ckk = picked.shape[1]
        x2 = picked.permute(0, 2, 3, 1).reshape(b * h_out * w_out, ckk)
    else:
        p = F.unfold(xp, (kh, kw), dilation=dilation, padding=0, stride=stride)  # [B, CKK, L]
        ckk = p.shape[1]
        x2 = p.transpose(1, 2).reshape(b * h_out * w_out, ckk)

    def col2im(dx2: torch.Tensor) -> torch.Tensor:
        # the cotangent in x's dtype, as the JAX package's; the overlapping
        # patch sums in fp32, rounded once (XLA's bf16 conv does the same)
        dcol = dx2.reshape(b, h_out * w_out, ckk).transpose(1, 2).to(x.dtype)
        if pointwise:  # no overlaps: each element added once into zeros, as fold does
            dxp = torch.zeros((b, ckk, hp, wp), dtype=torch.float32, device=x.device)
            dxp[:, :, :: stride[0], :: stride[1]] += dcol.reshape(b, ckk, h_out, w_out)
        else:
            dxp = F.fold(dcol.float(), (hp, wp), (kh, kw), dilation=dilation, padding=0,
                         stride=stride)
        return dxp[:, :, ph0 : ph0 + h, pw0 : pw0 + w].to(x.dtype)

    return x2, col2im, (h_out, w_out)


def flatten_filters(w: torch.Tensor) -> torch.Tensor:
    """OIHW filters → canonical ``W2 [C_in*Kh*Kw, C_out]`` (a view)."""
    return w.reshape(w.shape[0], -1).T


def unflatten_filter_grad(dw2: torch.Tensor, w_shape) -> torch.Tensor:
    """Canonical ``dW2 [C_in*Kh*Kw, C_out]`` → OIHW filter gradient."""
    c_out, c_in, kh, kw = w_shape
    return dw2.T.reshape(c_out, c_in, kh, kw)


def flatten_grad(dy: torch.Tensor) -> torch.Tensor:
    """NCHW cotangent → canonical ``dY2 [B*H_out*W_out, C_out]`` (row
    order matching :func:`conv_patches`; a contiguous copy)."""
    b, c, h, w = dy.shape
    return dy.permute(0, 2, 3, 1).reshape(b * h * w, c)
