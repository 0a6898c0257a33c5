"""Honest-savings audit: the census of each site's backward against the
FLOPs model (twin of ``repro.analysis.savings``).

For every sparsifiable site of a model this module runs the *actual*
backward of ``sparse_conv2d`` / ``sparse_dense`` under the site's
resolved policy on ``meta`` tensors (nothing allocated, nothing run on a
device) and counts it with :mod:`~repro_torch.analysis.dispatch_walk`.

* On every route whose products the port runs as torch ops (dense, the
  channel route, the block route through the gather or the mask) the
  census must equal :func:`repro_torch.core.flops.conv_backward_contraction_bounds`
  / ``dense_backward_contraction_bounds`` **exactly**, else the audit errors.
* On the kernel route (``use_pallas``: the gathered, fused and ``matmul``
  kernels) the census counts each launch's tile FLOPs from
  ``kernels/specs.py``. The table models the TPU's 128-wide tiles (and,
  on the canonical conv route, the JAX package's im2col convs), which the
  CUDA kernels do not have, so the audit reports the kernels' tile FLOPs,
  the table's count and their ratio, and errors only where the products
  the kernels were asked for (plus the torch ops') differ from the table's
  unpadded count (the same policy's gather route).

The legacy Eq.-9 tables (``conv_backward_flops_policy`` et al.) are a
sanity band: the audit warns when they drift more than 2x from the
measured count.

Probes are geometry-exact: convs run at stride 1 with ``(K-1)``-total
padding so that ``H_in == H_out`` and the padded image is the ``H_out +
K - 1`` the bounds assume; a strided site audits through its stride-1
twin with the same output geometry. Censuses are cached on ``(geometry,
policy)``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.analysis import dispatch_walk
from repro_torch.analysis.lints import lint_backward_counts
from repro_torch.analysis.report import ERROR, INFO, WARN, Report
from repro_torch.core import flops as ftab
from repro_torch.core import sparse_conv2d, sparse_dense
from repro_torch.core.policy import PolicyLike, SsPropPolicy, policy_for

#: multiplicative sanity band for the legacy Eq.-9 tables (measured over
#: legacy outside [1/2, 2] is a warning)
LEGACY_BAND = 2.0


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta", requires_grad=True)


def _backward_census(fwd, inputs, dy) -> dispatch_walk.Counts:
    """The census of ``autograd.grad`` of ``fwd(*inputs)`` against ``dy``
    (the forward runs outside it)."""
    y = fwd(*inputs)
    with dispatch_walk.Census(args=(inputs, dy)) as c:
        grads = torch.autograd.grad(y, inputs, dy)
    return c.finish(grads)


@functools.lru_cache(maxsize=None)
def conv_backward_counts(bt: int, h_out: int, w_out: int, c_in: int, c_out: int, k: int,
                         policy: SsPropPolicy, groups: int = 1,
                         dtype: str = "float32") -> dispatch_walk.Counts:
    """Census of one conv site's backward, on meta."""
    pl_, pr = (k - 1) // 2, (k - 1) - (k - 1) // 2
    x = _meta(bt, c_in, h_out, w_out, dtype=dtype)
    w = _meta(c_out, c_in // groups, k, k, dtype=dtype)
    b = _meta(c_out, dtype=dtype)
    dy = torch.empty((bt, c_out, h_out, w_out), dtype=getattr(torch, dtype), device="meta")

    def fwd(xa, wa, ba):
        return sparse_conv2d(xa, wa, ba, stride=1, padding=((pl_, pr), (pl_, pr)), groups=groups,
                             policy=policy)

    return _backward_census(fwd, (x, w, b), dy)


@functools.lru_cache(maxsize=None)
def dense_backward_counts(m: int, d_in: int, d_out: int, policy: SsPropPolicy,
                          dtype: str = "bfloat16") -> dispatch_walk.Counts:
    """Census of one dense site's backward, on meta."""
    x, w, b = _meta(m, d_in, dtype=dtype), _meta(d_in, d_out, dtype=dtype), _meta(d_out,
                                                                                   dtype=dtype)
    dy = torch.empty((m, d_out), dtype=getattr(torch, dtype), device="meta")
    return _backward_census(lambda xa, wa, ba: sparse_dense(xa, wa, ba, policy=policy),
                            (x, w, b), dy)


def clear_cache() -> None:
    """Drop cached censuses (tests that patch the engine need this)."""
    conv_backward_counts.cache_clear()
    dense_backward_counts.cache_clear()


# ----------------------------------------------------------------------
# per-site audits
# ----------------------------------------------------------------------


def _legacy_band_check(report, site, measured, legacy, dense_ref) -> None:
    ratio = legacy / (measured or 1)
    sev = INFO if 1 / LEGACY_BAND <= ratio <= LEGACY_BAND else WARN
    report.add("savings", sev, site,
               f"measured backward contraction FLOPs {measured:,} "
               f"({measured / dense_ref:.3f}x dense); legacy table {legacy:,} "
               f"({ratio:.2f}x measured)",
               flops=measured, legacy=legacy, dense_ref=dense_ref,
               ratio_vs_dense=measured / dense_ref)


def _check(report, site, counts, table, unpadded) -> None:
    """Non-kernel routes: the census equals the table. Kernel route: the
    products asked for equal the unpadded table; the tile FLOPs and their
    ratio to the (TPU-padded) table are reported."""
    measured = counts.flops_lo
    if not counts.launches:
        if (measured, measured) != table:
            report.add("savings", ERROR, site,
                       f"census backward FLOPs {measured:,} != table bounds "
                       f"({table[0]:,}, {table[1]:,})", measured=measured, analytic=list(table))
        return
    if measured != unpadded:
        report.add("savings", ERROR, site,
                   f"kernel route: products asked for {measured:,} != the table's unpadded "
                   f"count {unpadded:,}", measured=measured, unpadded=unpadded)
    tiles = counts.total_flops
    report.add("savings", INFO, site,
               f"kernel route: tile FLOPs {tiles:,} ({counts.launches_by_name()}) vs the "
               f"table's TPU-tiled ({table[0]:,}, {table[1]:,}): ratio "
               f"{tiles / (table[1] or 1):.3f}; products {measured:,} = unpadded {unpadded:,}",
               tile_flops=tiles, table=list(table), ratio=tiles / (table[1] or 1),
               product_flops=measured, unpadded=unpadded, launches=counts.launches_by_name())


def audit_conv_site(report: Report, site: str, bt: int, h_out: int, w_out: int, c_in: int,
                    c_out: int, k: int, policy: SsPropPolicy, *, groups: int = 1,
                    dtype: str = "float32") -> dispatch_walk.Counts:
    """Audit one conv site: census against the bounds, lints, band."""
    counts = conv_backward_counts(bt, h_out, w_out, c_in, c_out, k, policy, groups, dtype)
    kw = dict(groups=groups, h_pad=h_out + k - 1)
    table = ftab.conv_backward_contraction_bounds(bt, h_out, w_out, c_in, c_out, k, policy, **kw)
    unpadded = ftab.conv_backward_contraction_bounds(
        bt, h_out, w_out, c_in, c_out, k, dataclasses.replace(policy, use_pallas=False), **kw)[0]
    _check(report, site, counts, table, unpadded)
    if groups == 1:
        legacy = ftab.conv_backward_flops_policy(bt, h_out, w_out, c_in, c_out, k, policy)
        dense_ref = ftab.conv_backward_flops(bt, h_out, w_out, c_in, c_out, k)
        _legacy_band_check(report, site, counts.flops_lo, legacy, dense_ref)
    lint_backward_counts(report, site, counts, policy)
    return counts


def audit_dense_site(report: Report, site: str, m: int, d_in: int, d_out: int,
                     policy: SsPropPolicy, *, dtype: str = "bfloat16") -> dispatch_walk.Counts:
    """Audit one dense site: census against the bounds, lints, band."""
    counts = dense_backward_counts(m, d_in, d_out, policy, dtype)
    table = ftab.dense_backward_contraction_bounds(m, d_in, d_out, policy)
    unpadded = ftab.dense_backward_contraction_bounds(
        m, d_in, d_out, dataclasses.replace(policy, use_pallas=False))[0]
    _check(report, site, counts, table, unpadded)
    legacy = ftab.dense_backward_flops_policy(m, d_in, d_out, policy)
    dense_ref = ftab.dense_backward_flops(m, d_in, d_out)
    _legacy_band_check(report, site, counts.flops_lo, legacy, dense_ref)
    lint_backward_counts(report, site, counts, policy)
    return counts


# ----------------------------------------------------------------------
# per-model audits
# ----------------------------------------------------------------------


def audit_resnet(name: str, image, policy: PolicyLike, *, batch: int) -> Report:
    """Audit every conv site of a ResNet variant at one input shape."""
    from repro_torch.models import resnet

    report = Report(f"savings:{name}")
    for site, c_in, c_out, k, h_out, w_out in resnet.iter_conv_shapes(name, image):
        audit_conv_site(report, site, batch, h_out, w_out, c_in, c_out, k,
                        policy_for(policy, site))
    return report


def audit_ddpm(image, policy: PolicyLike, *, batch: int, base: int = 64) -> Report:
    """Audit every conv site of the DDPM UNet at one input shape."""
    from repro_torch.models import ddpm

    report = Report("savings:ddpm")
    for site, c_in, c_out, k, h_out, w_out in ddpm.iter_conv_shapes(image, base):
        audit_conv_site(report, site, batch, h_out, w_out, c_in, c_out, k,
                        policy_for(policy, site))
    return report


def audit_lm(cfg, policy: PolicyLike, *, batch: int, seq: int) -> Report:
    """Audit every dense projection geometry of a transformer config, one
    audit a distinct geometry (``transformer.iter_dense_shapes``), the
    policy resolved at its representative ``layer_{si}/...`` site."""
    from repro_torch.models import transformer

    report = Report(f"savings:{cfg.name}")
    for site, m, d_in, d_out, count in transformer.iter_dense_shapes(cfg, batch, seq):
        counts = audit_dense_site(report, site, m, d_in, d_out, policy_for(policy, site),
                                  dtype=cfg.dtype)
        report.add("savings", INFO, site,
                   f"x{count} layers: per-layer census {counts.flops_lo:,} "
                   f"(tile FLOPs {counts.total_flops:,})",
                   count=count, flops=counts.flops_lo, tile_flops=counts.total_flops)
    return report


def lm_site_flops(cfg, policy: PolicyLike, *, batch: int, seq: int):
    """Census-measured per-site backward contraction FLOPs:
    ``[(site, count, fwd_flops, bwd_lo, bwd_hi), ...]``, ``fwd_flops`` the
    plain ``2*M*D_in*D_out``, the backward the census's (one number:
    ``bwd_lo == bwd_hi``)."""
    from repro_torch.models import transformer

    rows = []
    for site, m, d_in, d_out, count in transformer.iter_dense_shapes(cfg, batch, seq):
        counts = dense_backward_counts(m, d_in, d_out, policy_for(policy, site), cfg.dtype)
        rows.append((site, count, 2 * m * d_in * d_out, counts.flops_lo, counts.flops_hi))
    return rows
