"""The channel-sparse backward engine (paper Fig. 1(a), one implementation).

The twin of ``repro.core.backward``. ``sparse_dense`` and
``sparse_conv2d`` supply their linear algebra through a
:class:`ChannelSparseOp`; :func:`channel_sparse_backward` owns every
op-independent stage:

  1. ``bwd_dtype`` casting of the output cotangent,
  2. importance → policy-driven channel/block selection (with the
     ragged-tail ``valid`` mask, and the shard-balanced selection of
     ``tp_shards`` and grouped convs),
  3. the ``mask_mode`` oracle (same selection, materialized as a mask
     over a full-size contraction),
  4. the gathered route: gather of the kept channels, shrunk
     contraction, compact dW scattered into zeros by accumulation,
  5. the TP fast path: a sharded selection with both sides sparsified
     goes to the op's ``tp_contract`` when it has one (dense), before
     the kernel route, as in the JAX package,
  6. the kernel route (``use_pallas`` + block granularity, a selection
     with ``block_idx``): the fused conv kernels when the op takes them,
     else the canonical 2-D form through ``dx_gathered`` /
     ``dw_gathered_scatter``.

Eager PyTorch has no dead-code elimination, so an op whose input needs
no gradient (a network's first conv) says so with ``need_dx=False`` and
the engine computes no dX for it: under ``jit`` the JAX package drops
that dX the same way.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
import contextlib
import dataclasses

import torch

from repro_torch.core import sparsity
from repro_torch.core.policy import SsPropPolicy

_selection_log: list | None = None
_cotangent_log: tuple[frozenset, dict] | None = None  # (the sites wanted, their dY)
_scopes: list[str] = []  # the names the running forward ops sit under, outermost first
_region: tuple[str, SsPropPolicy] | None = None  # the sparse backward running: (site, policy)


class scope:
    """Within the block, ops run under ``name`` (a layer, then a site in
    it): what :func:`current_scope` joins, and what a sparse op records
    at forward for its backward's :class:`region`. The program auditor
    reads both (``analysis/dispatch_walk.py``). A class, not a generator:
    every dense call enters one, serving included."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        _scopes.append(self.name)

    def __exit__(self, *exc) -> None:
        _scopes.pop()


def current_scope() -> str:
    """The names of :class:`scope` in force, joined by ``/``."""
    return "/".join(n for n in _scopes if n)


class region:
    """Within the block the sparse backward of ``site`` runs under
    ``policy`` (its ``bwd_dtype`` region): :func:`current_region`."""

    __slots__ = ("entry", "prev")

    def __init__(self, site: str, policy: SsPropPolicy):
        self.entry = (site, policy)

    def __enter__(self) -> None:
        global _region
        self.prev, _region = _region, self.entry

    def __exit__(self, *exc) -> None:
        global _region
        _region = self.prev


def current_region() -> tuple[str, SsPropPolicy] | None:
    """``(site, policy)`` of the sparse backward running, or None."""
    return _region


@contextlib.contextmanager
def record_selections() -> Iterator[list]:
    """Within the block, every sparse backward appends
    ``(weight.data_ptr(), Selection)`` to the list it yields: how a
    caller sees which channels each site kept. On a mesh the key is the
    site's name, and the selection the rank's (local channel indices)."""
    global _selection_log
    prev, _selection_log = _selection_log, []
    try:
        yield _selection_log
    finally:
        _selection_log = prev


@contextlib.contextmanager
def record_cotangents(sites) -> Iterator[dict]:
    """Within the block, the sparse backward of each mesh site named in
    ``sites`` stores a copy of its output gradient (the rank's piece, as
    the selection reads it) under that name in the dict it yields; a
    site's first backward in the block is kept."""
    global _cotangent_log
    prev, log = _cotangent_log, {}
    _cotangent_log = (frozenset(sites), log)
    try:
        yield log
    finally:
        _cotangent_log = prev


@dataclasses.dataclass
class CanonicalForm:
    """An op lowered to the 2-D form the gathered kernels take.

    ``x2 [M, D_flat]``, ``w2 [D_flat, C_out]``, ``dy2 [M, C_out]`` with
    rows of ``x2``/``dy2`` aligned. ``dx_from`` / ``dw_from`` lift dX2
    ``[M, D_flat]`` and full-size dW2 ``[D_flat, C_out]`` back to the
    op's shapes (dense: identity; conv: col2im / OIHW reshape).
    """

    x2: torch.Tensor
    w2: torch.Tensor
    dy2: torch.Tensor
    dx_from: Callable[[torch.Tensor], torch.Tensor]
    dw_from: Callable[[torch.Tensor], torch.Tensor]


def acc_dtype(policy: SsPropPolicy) -> torch.dtype:
    return torch.bfloat16 if policy.bwd_dtype == "bfloat16" else torch.float32


class ChannelSparseOp:
    """Adapter protocol: the op-specific linear algebra.

    Attributes:
      c_out: number of output channels (the sparsified axis).
      channel_axis: position of the channel axis in ``dy``.
      dw_channel_axis: position of the output-channel axis in ``dw``.
      need_dx: False when the op's input needs no gradient; every dX
        then comes back as None.

    Ops implement the one-sided contractions (``dx_full``, ``dw_full``,
    ``contract_gathered_dx``, ``contract_gathered_dw``) and optionally
    ``canonical``, ``fused_backward`` and ``tp_contract``.
    """

    c_out: int
    channel_axis: int
    dw_channel_axis: int

    def __init__(self, policy: SsPropPolicy, need_dx: bool = True):
        self.policy = policy
        self.need_dx = need_dx
        self._acc = acc_dtype(policy)

    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        """Contraction operands in the accumulation dtype when
        ``bwd_dtype`` is set; unchanged otherwise."""
        return a.to(self._acc) if self.policy.bwd_dtype else a

    def selection_shards(self, policy: SsPropPolicy) -> int:
        """How many contiguous channel groups selection must balance over."""
        return 1

    def dx_full(self, dy_eff: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def dw_full(self, dy_eff: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def contract_full(self, dy_eff):
        """(dX, dW) from a full-size (possibly masked) cotangent."""
        dx = self.dx_full(dy_eff) if self.need_dx else None
        return dx, self.dw_full(dy_eff)

    def gather_cotangent(self, dy_eff: torch.Tensor, sel) -> torch.Tensor:
        """The kept channels of the cotangent, ``dy_k``."""
        return dy_eff.index_select(self.channel_axis % dy_eff.dim(), sel.idx)

    def contract_gathered_dx(self, dy_k: torch.Tensor, sel) -> torch.Tensor:
        raise NotImplementedError

    def contract_gathered_dw(self, dy_k: torch.Tensor, sel) -> torch.Tensor:
        raise NotImplementedError

    def contract_gathered(self, dy_k, sel):
        """(dX, compact dW) from the gathered cotangent ``dy_k`` (kept
        channels only, phantom slots zeroed); the engine scatters dW."""
        dx = self.contract_gathered_dx(dy_k, sel) if self.need_dx else None
        return dx, self.contract_gathered_dw(dy_k, sel)

    def canonical(self, dy_eff: torch.Tensor) -> CanonicalForm | None:
        """The 2-D lowering for the gathered kernels, or None."""
        return None

    def fused_backward(self, dy_eff, sel, sdx: bool, sdw: bool):
        """Optional fused kernel path: (dX, dW) in the op's shapes and
        accumulation dtype, or None to fall through to the canonical
        form. Checked first on the kernel route."""
        return None

    def tp_contract(self, dy_eff, sel):
        """Optional sharded fast path: (dX, full dW) from the per-shard
        selection (dX None when ``need_dx`` is False), or None to take
        the generic routes."""
        return None


def scatter_channels(
    compact: torch.Tensor, idx: torch.Tensor, c: int, axis: int
) -> torch.Tensor:
    """Scatter a compact per-kept-channel tensor into full-size zeros.

    Accumulating (``index_add_``): the clamped phantoms of a ragged block
    tail, whose values the engine has already zeroed, add nothing
    instead of overwriting channel ``C-1``.
    """
    axis = axis % compact.dim()
    shape = list(compact.shape)
    shape[axis] = c
    out = torch.zeros(shape, dtype=compact.dtype, device=compact.device)
    return out.index_add_(axis, idx, compact)


def channel_sparse_backward(
    policy: SsPropPolicy,
    op: ChannelSparseOp,
    dy: torch.Tensor,
    *,
    key: torch.Tensor | None = None,
    has_bias: bool = False,
    mesh=None,
):
    """Run the ssProp backward pipeline for one op.

    Returns ``(dX, dW, db)`` in accumulation dtype (callers cast back to
    their parameter dtypes); ``db`` is None when ``has_bias`` is False,
    ``dX`` when ``op.need_dx`` is False.

    ``mesh`` (a ``dist/parallel.py::SiteMesh``) makes ``dy`` one mesh
    rank's piece of the site's output gradient: the selection is then
    :func:`~repro_torch.core.sparsity.select_on_mesh`, the one-device
    run's channels restricted to the rank's columns.
    """
    ca = op.channel_axis % dy.dim()
    c = op.c_out
    reduce_axes = tuple(a for a in range(dy.dim()) if a != ca)
    dy_eff = dy.to(op._acc) if policy.bwd_dtype else dy
    sdx, sdw = policy.sparsify_dx, policy.sparsify_dw
    need_dx = op.need_dx

    if not policy.active or not (sdx or sdw):
        dx, dw = op.contract_full(dy_eff)
        db = dy_eff.sum(dim=reduce_axes) if has_bias else None
        return dx, dw, db

    if mesh is None:
        sel = sparsity.select(
            dy_eff, policy, channel_axis=ca, n_shards=op.selection_shards(policy), key=key
        )
    else:
        if _cotangent_log is not None and mesh.site in _cotangent_log[0]:
            _cotangent_log[1].setdefault(mesh.site, dy_eff.detach().clone())
        sel = sparsity.select_on_mesh(
            dy_eff, policy, mesh, n_shards=op.selection_shards(policy), key=key
        )
    if _selection_log is not None:
        _selection_log.append((op.w.data_ptr() if mesh is None else mesh.site, sel))

    if policy.mask_mode:
        # The oracle: identical selection, zeroed channels, full-size
        # contraction. A side whose sparsify_* flag is off sees the raw
        # cotangent.
        mask = sparsity.keep_mask(dy.shape, sel.idx, channel_axis=ca, dtype=dy_eff.dtype)
        dy_m = dy_eff * mask
        dx = op.dx_full(dy_m if sdx else dy_eff) if need_dx else None
        dw = op.dw_full(dy_m if sdw else dy_eff)
        db = (dy_m if sdw else dy_eff).sum(dim=reduce_axes) if has_bias else None
        return dx, dw, db

    db = None
    if has_bias:
        # db follows the dW side; phantom slots always point into the
        # kept tail block, so the plain keep-mask is right.
        db = dy_eff.sum(dim=reduce_axes)
        if sdw:
            db = db * sparsity.keep_mask((c,), sel.idx, channel_axis=0, dtype=dy_eff.dtype)

    if sel.shard_idx is not None and sdx and sdw:
        fast = op.tp_contract(dy_eff, sel)
        if fast is not None:
            dx, dw = fast
            return dx, dw, db

    if policy.use_pallas and policy.granularity == "block" and sel.block_idx is not None:
        fused = op.fused_backward(dy_eff, sel, sdx, sdw)
        if fused is not None:
            dx, dw = fused
            return dx, dw, db
        can = op.canonical(dy_eff)
        if can is not None:
            from repro_torch.kernels import ops as kops

            dx = None
            if need_dx:
                if sdx:
                    dx2 = kops.dx_gathered(can.dy2, can.w2, sel.block_idx, policy.block_size)
                else:
                    dx2 = can.dy2 @ can.w2.T
                dx = can.dx_from(dx2)
            if sdw:
                dw2 = kops.dw_gathered_scatter(
                    can.x2, can.dy2, sel.block_idx, c, policy.block_size
                )
            else:
                dw2 = can.x2.T @ can.dy2
            return dx, can.dw_from(dw2), db

    dy_k = op.gather_cotangent(dy_eff, sel)
    if sel.valid is not None:
        vshape = [1] * dy.dim()
        vshape[ca] = sel.k
        dy_k = dy_k * sel.valid.reshape(vshape).to(dy_k.dtype)
    if sdx and sdw:
        dx, dw_compact = op.contract_gathered(dy_k, sel)
    elif sdx:
        dx = op.contract_gathered_dx(dy_k, sel) if need_dx else None
        dw_compact = None
    else:
        dx = op.dx_full(dy_eff) if need_dx else None
        dw_compact = op.contract_gathered_dw(dy_k, sel)
    if sdw:
        dw = scatter_channels(dw_compact, sel.idx, c, op.dw_channel_axis)
    else:
        dw = op.dw_full(dy_eff)
    return dx, dw, db
