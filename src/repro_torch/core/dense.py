"""``sparse_dense``: matmul with ssProp channel-sparse backward.

The twin of ``repro.core.dense``, as a ``torch.autograd.Function``.
Forward is ``Y = X @ W (+ b)``; backward is the engine
(:mod:`repro_torch.core.backward`) over this module's dense linear
algebra. The canonical form (``use_pallas``, block granularity) goes
through the gathered kernels ``dx_gathered`` / ``dw_gathered``.

At channel granularity with ``use_pallas`` the shrunk products run
through the ``matmul`` kernel on the gathered operands, fp32 out, as the
JAX package's do; the operands are gathered into buffers whose row pitch
is a multiple of 8 elements (``gather_columns``), so the kernel's TMA
reads them in place. Without ``use_pallas``, ``torch.matmul`` is the JAX
package's ``jnp.matmul``, its output in the operands' dtype: that
rounding difference between the two routes is the reference's own.

Where no gradient is wanted (grad mode off, or no input requiring one,
as in serving) ``sparse_dense`` is the plain ``x @ w (+ b)`` and does not
enter the autograd Function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import backward
from repro_torch.core.policy import SsPropPolicy
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import ops as kops

# frozen, so safe to share as the signature default
_DEFAULT_POLICY = SsPropPolicy()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp.matmul`` promotes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


class _DenseOp(backward.ChannelSparseOp):
    """Canonical-form op: X2 [M, D_in] @ W [D_in, D_out]."""

    channel_axis = 1
    dw_channel_axis = 1

    def __init__(self, x2, w, policy, need_dx=True):
        super().__init__(policy, need_dx)
        self.x2 = x2
        self.w = w
        self.c_out = w.shape[1]

    def selection_shards(self, policy: SsPropPolicy) -> int:
        if policy.tp_shards > 1 and self.c_out % policy.tp_shards == 0:
            return policy.tp_shards
        return 1

    def dx_full(self, dy_eff):
        return _mm(dy_eff, self._cast(self.w).T)

    def dw_full(self, dy_eff):
        return _mm(self._cast(self.x2).T, dy_eff)

    def gather_cotangent(self, dy_eff, sel):
        if self.policy.use_pallas:  # row pitch a multiple of 8: the kernel's TMA reads it
            return gm.gather_columns(dy_eff, sel.idx)
        return super().gather_cotangent(dy_eff, sel)

    def contract_gathered_dx(self, dy_k, sel):
        if self.policy.use_pallas:
            w_k = self._cast(gm.gather_columns(self.w, sel.idx))
            return kops.matmul(dy_k, w_k.T)
        w_k = self._cast(self.w.index_select(1, sel.idx))
        return _mm(dy_k, w_k.T)  # shrunk: 2*M*K*D_in

    def contract_gathered_dw(self, dy_k, sel):
        x2 = self._cast(self.x2)
        if self.policy.use_pallas:
            return kops.matmul(x2.T, dy_k)
        return _mm(x2.T, dy_k)  # shrunk: 2*M*D_in*K

    def canonical(self, dy_eff):
        return backward.CanonicalForm(
            x2=self._cast(self.x2),
            w2=self._cast(self.w),
            dy2=dy_eff,
            dx_from=lambda dx2: dx2,
            dw_from=lambda dw2: dw2,
        )


class _SparseDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, policy, key):
        y = _mm(x, w)
        if b is not None:
            y = y + b
        ctx.save_for_backward(x, w)
        ctx.conf = (policy, key, b is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        policy, key, has_bias = ctx.conf
        d_in, d_out = w.shape
        lead = x.shape[:-1]
        m = math.prod(lead)
        op = _DenseOp(x.reshape(m, d_in), w, policy, need_dx=ctx.needs_input_grad[0])
        dx2, dw, db = backward.channel_sparse_backward(
            policy, op, dy.reshape(m, d_out), key=key, has_bias=has_bias
        )
        return (
            None if dx2 is None else dx2.reshape(*lead, d_in).to(x.dtype),
            dw.to(w.dtype),
            db.to(dy.dtype) if has_bias else None,
            None, None,
        )


def sparse_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    policy: SsPropPolicy = _DEFAULT_POLICY,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Linear layer with ssProp scheduled-sparse backward.

    Args:
      x: ``[..., D_in]`` activations.
      w: ``[D_in, D_out]`` weights.
      b: optional ``[D_out]`` bias.
      policy: the ssProp policy of this step.
      key: ``[2]`` int64 JAX key data (``core/prng.py``), only needed for
        ``selection="random"``.
    """
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b))):
        y = _mm(x, w)
        return y if b is None else y + b
    return _SparseDense.apply(x, w, b, policy, key)
