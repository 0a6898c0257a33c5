"""Program lints over censuses (twin of ``repro.analysis.lints``).

Two scopes:

* :func:`lint_backward_counts` — one site's backward probe: the numerics
  contract (no fp32 contraction, and no kernel launched on fp32 operands,
  inside a ``bwd_dtype="bfloat16"`` region) and no host sync in the
  backward.
* :func:`lint_step_counts` — a whole train or serve step: no host sync
  (in eager PyTorch the twin of the reference's host callback: the step
  stalls until the device catches up), and dead contraction FLOPs, a
  product whose result nothing reads.

Dead FLOPs are a *warning*: a step may keep a debug output on purpose.
Host syncs and dtype leaks are errors: both break a documented contract
(a step never waits for the device; a ``bwd_dtype`` region computes every
contraction in bf16).
"""
from __future__ import annotations

from repro_torch.analysis.dispatch_walk import Counts
from repro_torch.analysis.report import ERROR, INFO, WARN, Report
from repro_torch.core.policy import SsPropPolicy


def lint_dtype(report: Report, site: str, counts: Counts) -> None:
    """An fp32 contraction, or a kernel launched on fp32 operands, inside
    a ``bwd_dtype="bfloat16"`` region: one error each."""
    for c in counts.contractions:
        if c.region_dtype == "bfloat16" and "torch.float32" in c.operand_dtypes:
            report.add("dtype", ERROR, site,
                       f"fp32 contraction inside bwd_dtype=bfloat16 region: {c.op} operands "
                       f"{c.operand_dtypes} at {c.scope}",
                       op=c.op, operand_dtypes=list(c.operand_dtypes), scope=c.scope)
    for k in counts.launches:
        wide = [n for n, (_, it) in k.spec.operands.items() if it == 4 and n not in (
            "block_idx", "block_tables", "qpos")]
        if k.region_dtype == "bfloat16" and wide:
            report.add("dtype", ERROR, site,
                       f"{k.name} launched on fp32 {wide} inside bwd_dtype=bfloat16 region "
                       f"at {k.scope}", kernel=k.name, scope=k.scope)


def lint_syncs(report: Report, name: str, counts: Counts, where: str) -> None:
    """One error a host-syncing op and scope, with its count."""
    seen: dict[tuple[str, str], int] = {}
    for s in counts.syncs:
        seen[(s.op, s.scope)] = seen.get((s.op, s.scope), 0) + 1
    for (op, scope), n in seen.items():
        report.add("transfer", ERROR, name,
                   f"host sync inside {where}: {op} x{n} at {scope or '(top)'}",
                   op=op, scope=scope, count=n)


def lint_backward_counts(report: Report, site: str, counts: Counts,
                         policy: SsPropPolicy) -> None:
    """Dtype-leak and host-sync lints on one backward probe."""
    if policy.bwd_dtype == "bfloat16":
        lint_dtype(report, site, counts)
    lint_syncs(report, site, counts, "the backward")


def lint_step_counts(report: Report, name: str, counts: Counts) -> None:
    """Host-sync, dtype-leak and dead-code lints on one whole step."""
    lint_syncs(report, name, counts, "the step")
    lint_dtype(report, name, counts)
    if counts.dead_flops:
        report.add("dead", WARN, name,
                   f"{counts.dead_flops:,} contraction FLOPs in {counts.dead_ops} op(s) whose "
                   "result nothing reads: a forgotten output or a dead debug branch?",
                   dead_flops=counts.dead_flops, dead_ops=counts.dead_ops)
    else:
        report.add("dead", INFO, name, "no dead contraction", dead_ops=0)
