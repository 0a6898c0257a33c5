"""The traffic model that decides a conv's backward route.

The port's copy of the part of ``repro.core.flops`` that the routing
gate reads (:func:`kept_channels`, :func:`conv_backward_bytes_policy`,
:func:`conv_backward_bytes_breakdown`), line for line. It models the
TPU kernels' HBM traffic, and is kept as it is so that the port takes
the same routes as the JAX package at every site; a traffic model of
the H100 kernels, and routes chosen by it, are later work.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.core.policy import SsPropPolicy


def kept_channels(c_out: int, policy: SsPropPolicy) -> int:
    """Output channels whose gradients the engine actually computes.

    Channel granularity: the paper's ``max(1, round((1-D)*C))``. Block
    granularity: whole blocks, ``keep_count`` blocks × ``block_size``
    channels, capped at ``C``.
    """
    if not policy.active:
        return c_out
    if policy.granularity == "channel":
        return policy.keep_count(c_out)
    return min(c_out, policy.keep_count(c_out) * policy.block_size)


def conv_backward_bytes_policy(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    policy: SsPropPolicy,
    fused: bool | None = None,
    itemsize: int = 4,
    groups: int = 1,
) -> int:
    """HBM bytes one conv backward moves under ``policy``.

    * **Materializing** (``fused=False``): the canonical im2col path
      builds ``X2 [M, N]`` and ``dX2 [M, N]`` (``M = Bt*H_out*W_out``,
      ``N = C_in*K²``), each written and read once.
    * **Fused** (``fused=True``): the fused kernels' per-(tap ×
      kept-block) re-fetches of image rows and cotangent panels; no
      ``[M, N]`` buffer.

    ``fused=None`` routes exactly like the engine: the fused model when
    the policy's fused path applies to this conv and it moves fewer
    bytes, the materializing model otherwise. Geometry is counted at
    stride 1 / 'SAME'-ish padding (``H_pad = H_out + K - 1``).
    """
    if fused is None:
        mat = conv_backward_bytes_policy(
            bt, h_out, w_out, c_in, c_out, k, policy,
            fused=False, itemsize=itemsize, groups=groups,
        )
        if not (
            policy.active
            and policy.use_pallas
            and policy.granularity == "block"
            and policy.fuse_im2col
            and k > 1
        ):
            return mat
        fus = conv_backward_bytes_policy(
            bt, h_out, w_out, c_in, c_out, k, policy,
            fused=True, itemsize=itemsize, groups=groups,
        )
        return min(mat, fus)

    parts = conv_backward_bytes_breakdown(
        bt, h_out, w_out, c_in, c_out, k, policy, fused=fused, groups=groups
    )
    return sum(parts.values()) * itemsize


def conv_backward_bytes_breakdown(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    policy: SsPropPolicy,
    *,
    fused: bool,
    groups: int = 1,
) -> dict[str, int]:
    """Per-component *element* counts behind the bytes model
    (:func:`conv_backward_bytes_policy` is ``sum(...) * itemsize``)."""
    m = bt * h_out * w_out
    cg = c_in // groups
    n = cg * k * k
    kept = kept_channels(c_out, policy)
    sdx = policy.active and policy.sparsify_dx
    sdw = policy.active and policy.sparsify_dw
    h_pad, w_pad = h_out + k - 1, w_out + k - 1
    x_elems = bt * c_in * h_pad * w_pad

    if not fused or k == 1:
        kept_dx = kept if sdx else c_out
        kept_dw = kept if sdw else c_out
        return {
            "mat.x_read": x_elems,               # read X to extract patches
            "mat.patch_buffers": 4 * m * n * groups,  # X2 w+r, dX2 w+r
            "mat.dy_panels": m * (kept_dx + kept_dw),  # read by each matmul
            "mat.importance": m * c_out,         # dY read for importance
            "mat.w_panels": n * kept_dx,         # W2 panels read (dX side)
            "mat.dw_write": n * c_out,           # dW written
            "mat.dx_write": x_elems,             # dX written
        }

    bs = policy.block_size
    nb = -(-c_out // bs)
    kb = policy.keep_count(c_out) if policy.active else nb
    kb_dx = kb if sdx else nb
    kb_dw = kb if sdw else nb
    m2 = bt * h_out      # dY row count (dW grid's sequential axis)
    s_ax = bt * h_pad    # padded-image row count (dX grid's outer axis)
    return {
        # dW kernel: one fetch per grid step for both streaming operands
        "dw.xg_rows": k * kb_dw * m2 * (w_pad * cg),
        "dw.dy_panels": k * kb_dw * m2 * (w_out * bs),
        "dw.out_flush": k * kb_dw * (k * cg * bs),
        # dX kernel: cotangent per (row, block, tap); filter once
        "dx.dy_rows": s_ax * kb_dx * k * (w_out * bs),
        "dx.w2k_gather": k * k * cg * kb_dx * bs,
        "dx.w2k_fetch": k * k * cg * kb_dx * bs,
        "dx.out_writes": s_ax * (w_pad * cg) * groups,
        # shared wrapper traffic
        "common.pad_image": 2 * x_elems,   # build padded row-major view
        "common.importance": m * c_out,    # dY read for importance
        "common.dw_write": n * c_out,      # dW written
        "common.dx_write": x_elems,        # dX written (border sliced off)
    }
