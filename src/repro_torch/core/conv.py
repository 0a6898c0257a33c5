"""``sparse_conv2d``: convolution with ssProp channel-sparse backward.

The twin of ``repro.core.conv``, as a ``torch.autograd.Function``.
Forward is ``F.conv2d`` (NCHW / OIHW, the JAX package's layout; XLA's
conv there, a library call here). Backward delegates to the engine
(:mod:`repro_torch.core.backward`); this module supplies only the conv
linear algebra:

* **full / mask-mode contraction**: the conv's own VJP
  (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``; XLA's conv VJP in
  the JAX package),
* **gathered contraction**: the same VJP restricted to the kept output
  channels,
* **fused kernel backward** (``use_pallas``, block granularity,
  ``fuse_im2col``): ``kernels/ops.py::conv_dx_fused`` /
  ``conv_dw_fused_scatter`` address the im2col patches inside the
  kernels, behind the same 1×1 exclusion, groups check and bytes gate
  (:func:`backward_route`) as the JAX package,
* **canonical (im2col) lowering**: ``kernels/im2col.py`` columnizes the
  conv for ``dx_gathered`` / ``dw_gathered_scatter``.

String padding is resolved to explicit ``(lo, hi)`` pairs up front, as
``jax.lax.padtype_to_pads`` does: "SAME" at stride 2 pads
asymmetrically, which ``F.conv2d`` cannot express, so such a conv pads
the input with ``F.pad`` first. The first conv of a network (whose
input needs no gradient) computes no dX, as ``jit`` drops it in the JAX
package. Grouped convs and ``tp_shards`` need the sharded selection,
which is not ported yet.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import backward
from repro_torch.core import flops as FL
from repro_torch.core.policy import PolicyLike, SsPropPolicy, policy_for

# frozen, so safe to share as the signature default
_DEFAULT_POLICY = SsPropPolicy()

Pads = tuple[tuple[int, int], tuple[int, int]]


def _norm_pair(v) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(v)


def explicit_padding(padding, hw, kernel, stride, dilation) -> Pads:
    """Per-dim ``(lo, hi)`` pads for an int, explicit pairs, or one of
    JAX's padding strings ("SAME", "SAME_LOWER", "VALID"), computed on
    the effective (dilated) filter extent as ``padtype_to_pads`` does."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if not isinstance(padding, str):
        return tuple(tuple(int(v) for v in p) for p in padding)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding not in ("SAME", "SAME_LOWER"):
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for n, k, s, d in zip(hw, kernel, stride, dilation, strict=True):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        lo = total // 2 if padding == "SAME" else total - total // 2
        pads.append((lo, total - lo))
    return tuple(pads)


def _symmetric(pads: Pads) -> bool:
    return pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]


def _pad_input(x, pads: Pads):
    (ph0, ph1), (pw0, pw1) = pads
    return F.pad(x, (pw0, pw1, ph0, ph1))


def _conv(x, w, stride, pads: Pads, dilation, groups):
    if _symmetric(pads):
        return F.conv2d(x, w, None, stride, (pads[0][0], pads[1][0]), dilation, groups)
    return F.conv2d(_pad_input(x, pads), w, None, stride, 0, dilation, groups)


def _conv_dx(x_shape, w, dy, stride, pads: Pads, dilation, groups):
    """The conv's VJP with respect to its input."""
    if _symmetric(pads):
        return torch.nn.grad.conv2d_input(
            x_shape, w, dy, stride, (pads[0][0], pads[1][0]), dilation, groups
        )
    (ph0, ph1), (pw0, pw1) = pads
    b, c, h, wd = x_shape
    dxp = torch.nn.grad.conv2d_input(
        (b, c, h + ph0 + ph1, wd + pw0 + pw1), w, dy, stride, 0, dilation, groups
    )
    return dxp[:, :, ph0 : ph0 + h, pw0 : pw0 + wd]


def _conv_dw(x, w_shape, dy, stride, pads: Pads, dilation, groups):
    """The conv's VJP with respect to its filters."""
    if _symmetric(pads):
        return torch.nn.grad.conv2d_weight(
            x, w_shape, dy, stride, (pads[0][0], pads[1][0]), dilation, groups
        )
    return torch.nn.grad.conv2d_weight(
        _pad_input(x, pads), w_shape, dy, stride, 0, dilation, groups
    )


def backward_route(
    policy: SsPropPolicy,
    *,
    batch: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    kh: int,
    kw: int,
    groups: int = 1,
) -> str:
    """The contraction the engine runs for one conv's backward:

    * ``"full"``: a dense step (the conv's own VJP);
    * ``"mask"``: the mask-mode oracle;
    * ``"fused"``: the fused kernels ``conv_dx_fused`` / ``conv_dw_fused``;
    * ``"canonical"``: im2col, then ``dx_gathered`` / ``dw_gathered``;
    * ``"gathered"``: the VJP on the kept filters.

    The fused route needs ``fuse_im2col``, a filter larger than 1×1,
    whole blocks per group, and the traffic model to find the fused
    kernels moving fewer bytes than the materialized patch buffers (the
    JAX package's gate, ``conv.py:159-184`` there).
    """
    if not policy.active or not (policy.sparsify_dx or policy.sparsify_dw):
        return "full"
    if policy.mask_mode:
        return "mask"
    if not (policy.use_pallas and policy.granularity == "block"):
        return "gathered"
    bs = policy.block_size
    if (
        policy.fuse_im2col
        and not (kh == kw == 1)
        and not (groups > 1 and c_out % (groups * bs) != 0)
    ):
        def model(fused):
            return FL.conv_backward_bytes_policy(
                batch, h_out, w_out, c_in, c_out, kh, policy, fused=fused, groups=groups
            )

        if model(True) < model(False):
            return "fused"
    return "canonical" if groups == 1 else "gathered"


def route_launches(routes: dict[str, str], policy: PolicyLike) -> dict[str, int]:
    """Launches of each gathered kernel in one backward of the convs whose
    routes (site -> :func:`backward_route`) are ``routes``, under a plain
    policy or a per-site table. The fused route launches ``conv_dw_fused``
    and ``conv_dx_fused``; the canonical one ``dw_gathered`` and
    ``dx_gathered`` on the sides that its site's ``sparsify_*`` flags
    shrink. A network's first conv, ``stem``, computes no dX."""
    n = {"dx_gathered": 0, "dw_gathered": 0, "conv_dw_fused": 0, "conv_dx_fused": 0}
    for site, route in routes.items():
        pol = policy_for(policy, site)
        need_dx = site != "stem"
        if route == "fused":
            n["conv_dw_fused"] += 1
            n["conv_dx_fused"] += need_dx
        elif route == "canonical":
            n["dw_gathered"] += pol.sparsify_dw
            n["dx_gathered"] += need_dx and pol.sparsify_dx
    return n


class _ConvOp(backward.ChannelSparseOp):
    """Conv adapter: NCHW dY, OIHW dW (output channels on axis 0)."""

    channel_axis = 1
    dw_channel_axis = 0

    def __init__(self, x, w, stride, pads: Pads, dilation, groups, policy, need_dx=True):
        super().__init__(policy, need_dx)
        self.x = x
        self.w = w
        self.stride = stride
        self.pads = pads
        self.dilation = dilation
        self.groups = groups
        self.c_out = w.shape[0]

    def selection_shards(self, policy: SsPropPolicy) -> int:
        s = 1
        if policy.tp_shards > 1 and self.c_out % policy.tp_shards == 0:
            s = policy.tp_shards
        if self.groups > 1 and (s < self.groups or s % self.groups != 0):
            s = self.groups
        return s

    def _operands(self, w, dy):
        x, w = self._cast(self.x), self._cast(w)
        return x, w, dy.to(torch.promote_types(x.dtype, w.dtype))

    def _dx(self, w, dy):
        _, w, dy = self._operands(w, dy)
        return _conv_dx(
            self.x.shape, w, dy, self.stride, self.pads, self.dilation, self.groups
        )

    def _dw(self, w, dy):
        x, w, dy = self._operands(w, dy)
        return _conv_dw(x, w.shape, dy, self.stride, self.pads, self.dilation, self.groups)

    def dx_full(self, dy_eff):
        return self._dx(self.w, dy_eff)

    def dw_full(self, dy_eff):
        return self._dw(self.w, dy_eff)

    def contract_gathered_dx(self, dy_k, sel):
        return self._dx(self.w.index_select(0, sel.idx), dy_k)

    def contract_gathered_dw(self, dy_k, sel):
        return self._dw(self.w.index_select(0, sel.idx), dy_k)

    def fused_backward(self, dy_eff, sel, sdx, sdw):
        c_out, _, kh, kw = self.w.shape
        _, _, h_out, w_out = dy_eff.shape
        route = backward_route(
            self.policy, batch=dy_eff.shape[0], h_out=h_out, w_out=w_out,
            c_in=self.x.shape[1], c_out=c_out, kh=kh, kw=kw, groups=self.groups,
        )
        if route != "fused":
            return None
        from repro_torch.kernels import ops as kops

        bs = self.policy.block_size
        x, w, dy_eff = self._operands(self.w, dy_eff)
        nb = -(-c_out // bs)
        # dense side of a mixed sparsify_dx/dw policy: every block kept
        dense_idx = torch.arange(nb, dtype=torch.int32, device=dy_eff.device)
        common = dict(
            stride=self.stride, padding=self.pads, dilation=self.dilation,
            groups=self.groups, block_size=bs,
        )
        dx = None
        if self.need_dx:
            dx = kops.conv_dx_fused(
                dy_eff, w, sel.block_idx if sdx else dense_idx,
                hw=tuple(self.x.shape[2:]), **common,
            ).to(self._acc)
        dw2 = kops.conv_dw_fused_scatter(
            x, dy_eff, sel.block_idx if sdw else dense_idx, kh=kh, kw=kw, **common,
        )  # [Cg*Kh*Kw, C_out], rows in (c, kh, kw) order -> OIHW
        dw = dw2.T.reshape(c_out, self.w.shape[1], kh, kw)
        return dx, dw.to(self._acc)

    def canonical(self, dy_eff):
        if self.groups != 1:
            return None
        from repro_torch.kernels import im2col

        kh, kw = self.w.shape[2:]
        x2, col2im, _ = im2col.conv_patches(
            self._cast(self.x), kh, kw, self.stride, self.pads, self.dilation
        )
        return backward.CanonicalForm(
            x2=x2,
            w2=self._cast(im2col.flatten_filters(self.w)),
            dy2=im2col.flatten_grad(dy_eff),
            dx_from=col2im,
            dw_from=lambda dw2: im2col.unflatten_filter_grad(dw2, self.w.shape),
        )


class _SparseConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, policy, stride, pads, dilation, groups, key):
        y = _conv(x, w, stride, pads, dilation, groups)
        if b is not None:
            y = y + b[None, :, None, None]
        ctx.save_for_backward(x, w)
        ctx.conf = (policy, stride, pads, dilation, groups, key, b is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        policy, stride, pads, dilation, groups, key, has_bias = ctx.conf
        op = _ConvOp(x, w, stride, pads, dilation, groups, policy,
                     need_dx=ctx.needs_input_grad[0])
        dx, dw, db = backward.channel_sparse_backward(
            policy, op, dy, key=key, has_bias=has_bias
        )
        return (
            None if dx is None else dx.to(x.dtype),
            dw.to(w.dtype),
            db.to(dy.dtype) if has_bias else None,
            None, None, None, None, None, None,
        )


def sparse_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int | Sequence[int] = 1,
    padding: str | int | Sequence[tuple[int, int]] = 0,
    dilation: int | Sequence[int] = 1,
    groups: int = 1,
    policy: SsPropPolicy = _DEFAULT_POLICY,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """2-D convolution (NCHW) with ssProp scheduled-sparse backward.

    Args:
      x: ``[B, C_in, H, W]`` input.
      w: ``[C_out, C_in // groups, Kh, Kw]`` filters (OIHW).
      b: optional ``[C_out]`` bias.
      stride / padding / dilation / groups: as in the JAX package
        (padding: an int, ``(lo, hi)`` pairs, or "SAME"/"VALID").
      policy: ssProp policy.
      key: ``[2]`` int64 JAX key data (``core/prng.py``), only needed for
        ``selection="random"``.
    """
    stride = _norm_pair(stride)
    dilation = _norm_pair(dilation)
    pads = explicit_padding(padding, x.shape[2:], w.shape[2:], stride, dilation)
    return _SparseConv2d.apply(x, w, b, policy, stride, pads, dilation, groups, key)
