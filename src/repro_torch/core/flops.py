"""The paper's backward-FLOPs model (Eq. 6-11), with policy-aware
counts, and the traffic model that decides a conv's backward route.

The port's copy of ``repro.core.flops``, function for function.

**FLOPs.** Counting convention (paper, "Drop Rate Lower Bound"): each
Add, Sub, Mul or Div is one FLOP; sorting is comparisons only (0
FLOPs); the importance reduction adds ``(Bt*H_out*W_out - 1) * C_out``
FLOPs. The ``*_ssprop`` functions take the paper's nominal drop rate;
the ``*_policy`` functions take an :class:`SsPropPolicy` and count what
the backward engine actually executes (block granularity rounds the
keep count to whole blocks, and the kernel route is counted at the
JAX package's 128-aligned tile padding, so the two packages print the
same ledger); the ``*_site`` functions take a plain policy or a
resolved :class:`~repro_torch.core.policy.SitePolicies` table and the
call site's name. The model walks (``models/resnet.py::flops_per_iter``,
``models/ddpm.py::flops_per_iter``) sum them over a network.
:func:`conv_backward_contraction_bounds` and
:func:`dense_backward_contraction_bounds` count only the products each
route runs, the TP fast path and grouped convs included; the sharded
widths come from :func:`repro_torch.core.sparsity.shard_select_width`,
the selection's own sizing.

**Traffic.** :func:`kept_channels`, :func:`conv_backward_bytes_policy`
and :func:`conv_backward_bytes_breakdown`, line for line: the model of
the TPU kernels' HBM traffic that the routing gate reads, kept as it
is so that the port takes the same routes as the JAX package at every
site; a traffic model of the H100 kernels, and routes chosen by it,
are later work.
"""
from __future__ import annotations

from repro_torch.core import sparsity
from repro_torch.core.policy import PolicyLike, SsPropPolicy, policy_for

# ----------------------------------------------------------------------
# backward FLOPs (Eq. 6-11)
# ----------------------------------------------------------------------


def _roundup(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def conv_backward_flops(
    bt: int, h_out: int, w_out: int, c_in: int, c_out: int, k: int
) -> int:
    """Eq. 6: backward FLOPs of one convolution, columnized form.

    ``(Bt*H_out*W_out) * (4*C_in*K^2 + 1) * C_out``
    """
    m = bt * h_out * w_out
    return m * (4 * c_in * k * k + 1) * c_out


def conv_backward_flops_ssprop(
    bt: int, h_out: int, w_out: int, c_in: int, c_out: int, k: int, drop_rate: float
) -> int:
    """Eq. 9 RHS: conv backward FLOPs with ssProp at ``drop_rate``.

    ``[(4MN + M)(1 - D) + M] * C_out`` with ``M = Bt*H_out*W_out`` and
    ``N = C_in*K^2``; the trailing ``M*C_out`` is the importance
    reduction overhead.
    """
    m = bt * h_out * w_out
    n = c_in * k * k
    return int(((4 * m * n + m) * (1.0 - drop_rate) + m) * c_out)


def batchnorm_backward_flops(bt: int, h: int, w: int, c: int) -> int:
    """Eq. 7: ``12*(Bt*H*W*C) + 10*C``."""
    return 12 * (bt * h * w * c) + 10 * c


def dropout_backward_flops(bt: int, h: int, w: int, c: int) -> int:
    """Eq. 8: ``2*(Bt*H*W*C)``."""
    return 2 * (bt * h * w * c)


def drop_rate_lower_bound(c_in: int, k: int) -> float:
    """Eq. 10: minimum drop rate that saves computation.

    ``D > 1 / (4*C_in*K^2 + 1)``; Eq. 11 notes this is <= ~3% for K>=3.
    """
    return 1.0 / (4 * c_in * k * k + 1)


def dense_backward_flops(m: int, d_in: int, d_out: int, bias: bool = True) -> int:
    """Backward FLOPs of ``Y[M, D_out] = X[M, D_in] @ W + b``: dX and dW
    are each a ``2*M*D_in*D_out`` FLOP matmul, the bias gradient an
    ``M*D_out`` reduction (Eq. 6 with K=1)."""
    f = 4 * m * d_in * d_out
    if bias:
        f += m * d_out
    return f


def dense_backward_flops_ssprop(
    m: int, d_in: int, d_out: int, drop_rate: float, bias: bool = True
) -> int:
    """ssProp dense backward: shrunk matmuls + importance reduction."""
    f = 4 * m * d_in * d_out * (1.0 - drop_rate)
    if bias:
        f += m * d_out * (1.0 - drop_rate)
    f += m * d_out  # importance reduction (Eq. 9's +M per channel)
    return int(f)


def gather_width(c_out: int, policy: SsPropPolicy, n_shards: int = 1) -> int:
    """The engine's gathered contraction width (``Selection.k``).

    Unlike :func:`kept_channels` this is not capped at ``C``: with a
    ragged tail block the engine gathers ``keep_count * block_size``
    columns (the phantom slots zeroed by the ``valid`` mask). Sharded
    selection keeps ``k_loc`` channels per shard with a shard-local
    block size."""
    if n_shards > 1:
        k_loc, _ = sparsity.shard_select_width(c_out, policy, n_shards)
        return n_shards * k_loc
    if policy.granularity == "channel":
        return policy.keep_count(c_out)
    return policy.keep_count(c_out) * policy.block_size


def effective_drop_rate(c_out: int, policy: SsPropPolicy) -> float:
    """The drop rate the backward actually realizes at ``c_out`` channels
    (block rounding makes this coarser than ``policy.drop_rate``)."""
    return 1.0 - kept_channels(c_out, policy) / c_out


def conv_backward_flops_policy(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    policy: SsPropPolicy,
) -> int:
    """Eq. 9 with the engine's real keep counts instead of the nominal D.

    ``(4MN + M) * kept + M*C_out`` with ``M = Bt*H_out*W_out``,
    ``N = C_in*K^2`` and ``kept = kept_channels(C_out, policy)``; each
    side shrinks only when its ``sparsify_*`` flag is on. On the kernel
    route (``use_pallas``, block granularity) the two gathered products
    are counted at the JAX package's TPU tiles: M and N padded to 128,
    kept padded to whole blocks.
    """
    m = bt * h_out * w_out
    n = c_in * k * k
    sdx, sdw = policy.sparsify_dx, policy.sparsify_dw
    if not policy.active or not (sdx or sdw):
        return conv_backward_flops(bt, h_out, w_out, c_in, c_out, k)
    kept = kept_channels(c_out, policy)
    if policy.use_pallas and policy.granularity == "block":
        m_pad = _roundup(m, 128)
        n_pad = _roundup(n, 128)
        kept_pad = policy.keep_count(c_out) * policy.block_size
        gathered = 2 * m_pad * n_pad * kept_pad
        dx_term = gathered if sdx else 2 * m * n * c_out
        dw_term = gathered if sdw else 2 * m * n * c_out
    else:
        dx_term = 2 * m * n * (kept if sdx else c_out)
        dw_term = 2 * m * n * (kept if sdw else c_out)
    db_term = m * (kept if sdw else c_out)
    return int(dx_term + dw_term + db_term + m * c_out)


def dense_backward_flops_policy(
    m: int, d_in: int, d_out: int, policy: SsPropPolicy, bias: bool = True
) -> int:
    """Dense analogue of :func:`conv_backward_flops_policy` (K=1 conv)."""
    sdx, sdw = policy.sparsify_dx, policy.sparsify_dw
    if not policy.active or not (sdx or sdw):
        return dense_backward_flops(m, d_in, d_out, bias=bias)
    kept = kept_channels(d_out, policy)
    if policy.use_pallas and policy.granularity == "block":
        m_pad = _roundup(m, 128)
        d_pad = _roundup(d_in, 128)
        kept_pad = policy.keep_count(d_out) * policy.block_size
        gathered = 2 * m_pad * d_pad * kept_pad
        dx_term = gathered if sdx else 2 * m * d_in * d_out
        dw_term = gathered if sdw else 2 * m * d_in * d_out
    else:
        dx_term = 2 * m * d_in * (kept if sdx else d_out)
        dw_term = 2 * m * d_in * (kept if sdw else d_out)
    f = dx_term + dw_term
    if bias:
        f += m * (kept if sdw else d_out)
    return int(f + m * d_out)


def conv_backward_route(
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

    The kernel routes need a selection with ``block_idx``: a sharded one
    (``sparsity.selection_shards`` > 1) whose shard-local block was shrunk
    below the policy's carries none. The fused route needs
    ``fuse_im2col``, a filter larger than 1×1, whole blocks per group,
    and the traffic model to find the fused kernels moving fewer bytes
    than the materialized patch buffers (the JAX package's gate,
    ``conv.py:159-184`` there). ``core/conv.py`` routes by this function
    and :func:`conv_backward_contraction_bounds` counts by it.
    """
    if not policy.active or not (policy.sparsify_dx or policy.sparsify_dw):
        return "full"
    if policy.mask_mode:
        return "mask"
    if not (policy.use_pallas and policy.granularity == "block"):
        return "gathered"
    bs = policy.block_size
    n_shards = sparsity.selection_shards(policy, c_out, groups)
    if n_shards > 1 and sparsity.shard_select_width(c_out, policy, n_shards)[1] != bs:
        return "gathered"
    if (
        policy.fuse_im2col
        and not (kh == kw == 1)
        and not (groups > 1 and c_out % (groups * bs) != 0)
    ):
        def model(fused):
            return conv_backward_bytes_policy(
                batch, h_out, w_out, c_in, c_out, kh, policy, fused=fused, groups=groups
            )

        if model(True) < model(False):
            return "fused"
    return "canonical" if groups == 1 else "gathered"


def conv_backward_contraction_bounds(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    policy: SsPropPolicy,
    *,
    groups: int = 1,
    h_pad: int | None = None,
) -> tuple[int, int]:
    """``(lo, hi)`` contraction FLOPs of one conv backward on the route
    :func:`conv_backward_route` names, counted as the JAX package counts
    each route (its program auditor's bounds): the products only, no bias
    reduction or importance pass. Groups-aware (``N_g = (C_in/G)*K²``),
    TP-sharded widths from :func:`gather_width`. One difference: where a
    sharded selection's shard-local block shrank, both engines run the
    gathered VJP, which is what this counts; the JAX package's model
    (``_conv_fused_route`` there) counts the kernel route.

    ``lo == hi`` except on the fused route, whose TPU dX kernel sweeps
    every padded-image row and masks invalid taps: ``lo`` is the dW
    kernel alone, ``hi`` adds the dX grid's full ``B*H_pad`` sweep
    (``h_pad`` defaults to ``H_out + K - 1``). The kernel routes count
    the JAX package's 128-padded tiles, as the ledger does."""
    m = bt * h_out * w_out
    cg = c_in // groups
    n_g = cg * k * k
    full_side = 2 * m * n_g * c_out
    sdx, sdw = policy.sparsify_dx, policy.sparsify_dw
    if not policy.active or not (sdx or sdw) or policy.mask_mode:
        return (2 * full_side, 2 * full_side)

    width = gather_width(c_out, policy, sparsity.selection_shards(policy, c_out, groups))
    gathered_side = 2 * m * n_g * width
    route = conv_backward_route(policy, batch=bt, h_out=h_out, w_out=w_out, c_in=c_in,
                                c_out=c_out, kh=k, kw=k, groups=groups)
    if route == "fused":
        if h_pad is None:
            h_pad = h_out + k - 1
        nb = -(-c_out // policy.block_size)
        kept_dx = width if sdx else nb * policy.block_size
        kept_dw = width if sdw else nb * policy.block_size
        dw_term = 2 * m * n_g * kept_dw
        dx_hi = 2 * (bt * h_pad * w_out) * n_g * kept_dx
        return (int(dw_term), int(dx_hi + dw_term))
    if route == "canonical":
        # canonical kernels over 128-padded tiles; a dense side is an
        # unpadded matmul; im2col and col2im are convs with K²
        # identity output channels, 2*M*N*K² FLOPs each
        n = c_in * k * k
        m_pad = _roundup(m, 128)
        n_pad = _roundup(n, 128)
        gathered_pad = 2 * m_pad * n_pad * width
        dx_term = gathered_pad if sdx else full_side
        dw_term = gathered_pad if sdw else full_side
        im2col_term = 2 * (2 * m * n * k * k)
        t = int(dx_term + dw_term + im2col_term)
        return (t, t)

    dx_term = gathered_side if sdx else full_side
    dw_term = gathered_side if sdw else full_side
    t = int(dx_term + dw_term)
    return (t, t)


def dense_backward_contraction_bounds(
    m: int, d_in: int, d_out: int, policy: SsPropPolicy
) -> tuple[int, int]:
    """``(lo, hi)`` contraction FLOPs of one dense backward (always
    ``lo == hi``), route by route as the engine takes them:

    * inactive / mask_mode: two full ``2*M*D_in*D_out`` products,
    * the TP fast path (``tp_shards`` divides ``D_out``, both sides
      sparsified): two unpadded shard-local einsums, before any kernel,
    * ``use_pallas`` block: the gathered sides at 128-padded tiles, a
      dense side unpadded,
    * ``use_pallas`` channel: every operand dim padded to 128 (the JAX
      package's ``matmul`` tiles),
    * the gather route: unpadded products at :func:`gather_width`.
    """
    full_side = 2 * m * d_in * d_out
    sdx, sdw = policy.sparsify_dx, policy.sparsify_dw
    if not policy.active or not (sdx or sdw) or policy.mask_mode:
        return (2 * full_side, 2 * full_side)

    n_shards = sparsity.selection_shards(policy, d_out)
    width = gather_width(d_out, policy, n_shards)
    gathered_side = 2 * m * d_in * width

    if n_shards > 1 and sdx and sdw:
        t = int(2 * gathered_side)
        return (t, t)
    if policy.use_pallas:
        if policy.granularity == "block":
            m_pad = _roundup(m, 128)
            d_pad = _roundup(d_in, 128)
            gathered_pad = 2 * m_pad * d_pad * width
            dx_term = gathered_pad if sdx else full_side
            dw_term = gathered_pad if sdw else full_side
        else:
            padded = (
                2 * _roundup(m, 128) * _roundup(d_in, 128) * _roundup(width, 128)
            )
            dx_term = padded if sdx else full_side
            dw_term = padded if sdw else full_side
        t = int(dx_term + dw_term)
        return (t, t)

    dx_term = gathered_side if sdx else full_side
    dw_term = gathered_side if sdw else full_side
    t = int(dx_term + dw_term)
    return (t, t)


def conv_backward_flops_site(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    policy: PolicyLike,
    site: str = "",
) -> int:
    """:func:`conv_backward_flops_policy` for one named call site:
    ``policy`` is a plain policy (the name is ignored) or a resolved
    :class:`~repro_torch.core.policy.SitePolicies` table."""
    return conv_backward_flops_policy(
        bt, h_out, w_out, c_in, c_out, k, policy_for(policy, site)
    )


def dense_backward_flops_site(
    m: int,
    d_in: int,
    d_out: int,
    policy: PolicyLike,
    site: str = "",
    bias: bool = True,
) -> int:
    """:func:`dense_backward_flops_policy` for one named call site."""
    return dense_backward_flops_policy(m, d_in, d_out, policy_for(policy, site), bias=bias)


def savings_fraction(dense_flops: int, ssprop_flops: int) -> float:
    """Fraction of backward FLOPs saved by ssProp."""
    if dense_flops <= 0:
        return 0.0
    return 1.0 - ssprop_flops / dense_flops


def conv_layer_report(
    bt: int,
    h_out: int,
    w_out: int,
    c_in: int,
    c_out: int,
    k: int,
    drop_rate: float,
    policy: SsPropPolicy | None = None,
) -> dict[str, float]:
    """Per-layer dict of the benchmark tables: with ``policy`` the
    ssProp count uses the engine's real keep counts, otherwise the
    paper's nominal Eq. 9 at ``drop_rate``."""
    dense = conv_backward_flops(bt, h_out, w_out, c_in, c_out, k)
    if policy is not None:
        sparse = conv_backward_flops_policy(bt, h_out, w_out, c_in, c_out, k, policy)
    else:
        sparse = conv_backward_flops_ssprop(bt, h_out, w_out, c_in, c_out, k, drop_rate)
    return {
        "dense_flops": dense,
        "ssprop_flops": sparse,
        "saved": savings_fraction(dense, sparse),
        "lower_bound": drop_rate_lower_bound(c_in, k),
    }


# ----------------------------------------------------------------------
# traffic: the routing gate's model
# ----------------------------------------------------------------------


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
