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
reads them in place. A ``tp_shards`` selection with both sides
sparsified takes the TP fast path (:meth:`_DenseOp.tp_contract`) before
any kernel, as two plain products in the operands' dtype with results in
the accumulation dtype, as the JAX package computes it outside any Pallas
kernel. Without ``use_pallas``, ``torch.matmul`` is the JAX
package's ``jnp.matmul``, its output in the operands' dtype: that
rounding difference between the two routes is the reference's own.

Where no gradient is wanted (grad mode off, or no input requiring one,
as in serving) ``sparse_dense`` is the plain ``x @ w (+ b)`` and does not
enter the autograd Function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import backward, sparsity
from repro_torch.core.policy import SsPropPolicy
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import ops as kops

# frozen, so safe to share as the signature default
_DEFAULT_POLICY = SsPropPolicy()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp.matmul`` promotes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def _mm_acc(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` on operands of one dtype, accumulated and returned in
    ``acc`` (``preferred_element_type`` in the JAX package). On the card a
    bf16 product stays a bf16 GEMM with an fp32 result; on the CPU the
    operands are widened, which leaves each product exact."""
    if a.dtype == acc:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=acc)
    return a.to(acc) @ b.to(acc)


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
        return sparsity.selection_shards(policy, self.c_out)

    def dx_full(self, dy_eff):
        return _mm(dy_eff, self._cast(self.w).T)

    def dw_full(self, dy_eff):
        return _mm(self._cast(self.x2).T, dy_eff)

    def gather_cotangent(self, dy_eff, sel):
        if self.policy.use_pallas:  # row pitch a multiple of 8: the kernel's TMA reads it
            return gm.gather_columns(dy_eff, sel.idx)
        return super().gather_cotangent(dy_eff, sel)

    def contract_gathered_dx(self, dy_k, sel):
        if self.policy.use_pallas and sel.k:
            w_k = self._cast(gm.gather_columns(self.w, sel.idx))
            return kops.matmul(dy_k, w_k.T)
        w_k = self._cast(self.w.index_select(1, sel.idx))
        return _mm(dy_k, w_k.T)  # shrunk: 2*M*K*D_in

    def contract_gathered_dw(self, dy_k, sel):
        x2 = self._cast(self.x2)
        if self.policy.use_pallas and sel.k:
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

    def tp_contract(self, dy_eff, sel):
        # The gather stays on the shard-local channel axis ([M, S, c_loc]),
        # where a TP-sharded dY needs no all-gather; dX contracts over
        # (shard, kept) as the row-parallel matmul does.
        m = dy_eff.shape[0]
        d_in = self.w.shape[0]
        s, k = sel.shard_idx.shape
        c_loc = self.c_out // s
        idx = sel.shard_idx[None]  # [1, S, k]
        dy_k = dy_eff.reshape(m, s, c_loc).gather(2, idx.expand(m, s, k))  # [M, S, k]
        w_k = self.w.reshape(d_in, s, c_loc).gather(2, idx.expand(d_in, s, k))  # [D_in, S, k]
        dy2 = dy_k.reshape(m, s * k)
        dx2 = None
        if self.need_dx:  # "msk,dsk->md"
            dx2 = _mm_acc(dy2, w_k.to(dy2.dtype).reshape(d_in, s * k).T, self._acc)
        dw_k = _mm_acc(self.x2.to(dy2.dtype).T, dy2, self._acc)  # "md,msk->dsk"
        dw = torch.zeros((d_in, s, c_loc), dtype=dw_k.dtype, device=dw_k.device)
        dw.scatter_(2, idx.expand(d_in, s, k), dw_k.reshape(d_in, s, k))
        return dx2, dw.reshape(d_in, self.c_out)


class _SparseDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, policy, key, mesh):
        y = _mm(x, w)
        if b is not None:
            y = y + b
        ctx.save_for_backward(x, w)
        ctx.conf = (policy, key, b is not None, mesh)
        ctx.site = mesh.site if mesh is not None else backward.current_scope()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        policy, key, has_bias, mesh = ctx.conf
        d_in, d_out = w.shape
        lead = x.shape[:-1]
        m = math.prod(lead)
        op = _DenseOp(x.reshape(m, d_in), w, policy, need_dx=ctx.needs_input_grad[0])
        with backward.region(ctx.site, policy):
            dx2, dw, db = backward.channel_sparse_backward(
                policy, op, dy.reshape(m, d_out), key=key, has_bias=has_bias, mesh=mesh
            )
        return (
            None if dx2 is None else dx2.reshape(*lead, d_in).to(x.dtype),
            dw.to(w.dtype),
            db.to(dy.dtype) if has_bias else None,
            None, None, None,
        )


def sparse_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    policy: SsPropPolicy = _DEFAULT_POLICY,
    key: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Linear layer with ssProp scheduled-sparse backward.

    Args:
      x: ``[..., D_in]`` activations.
      w: ``[D_in, D_out]`` weights.
      b: optional ``[D_out]`` bias.
      policy: the ssProp policy of this step.
      key: ``[2]`` int64 JAX key data (``core/prng.py``), only needed for
        ``selection="random"``.
      mesh: on a device mesh, the site's ``dist/parallel.py::SiteMesh``:
        ``x``/``w``/``dy`` are then this rank's pieces, and the selection
        is the one-device run's (``channel_sparse_backward``). A rank whose
        columns hold no kept channel computes zeros and launches nothing.
    """
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b))):
        y = _mm(x, w)
        return y if b is None else y + b
    return _SparseDense.apply(x, w, b, policy, key, mesh)
