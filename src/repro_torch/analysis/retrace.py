"""Retrace budgets: how many distinct step signatures a run can see
(twin of ``repro.analysis.retrace``).

The reference counts compiled executables: every distinct (shape,
static-argument) signature a jitted function sees is one XLA compile.
The port runs eagerly, so here an "executable" is a distinct step
signature: a graph that a later capture of the step (CUDA graphs)
would have to record. The counts and budgets are the reference's:

* **Train** — a :class:`~repro_torch.core.policy.PolicyProgram`'s per-step
  site tables. ``Schedule.scale`` is bucket-quantized, so the distinct
  tables over any run are among those the bucket scales produce:
  :func:`train_tables` enumerates ``{0} ∪ {bucket/target}`` and dedups
  the resolved tables. Budget: ``len(schedule.rate_buckets)``.
* **Serve** — the engine's step functions: the target step once a width
  of ``ServeConfig.widths`` (the prefill chunk included); a speculative
  drafter adds its catch-up width and, for ``spec_k > 1``, the width-1
  propose step; an encoder-decoder adds one ``encode`` a plane. Budget:
  :data:`SERVE_JIT_BUDGET` in all.

Both checks error when the static count passes the budget and attach
the enumeration as an info finding otherwise.
"""
from __future__ import annotations

from collections.abc import Sequence

from repro_torch.analysis.report import ERROR, INFO, Report
from repro_torch.core.policy import PolicyProgram, SitePolicies

#: documented ceiling on the serve engine's step signatures (all planes)
SERVE_JIT_BUDGET = 12


def train_tables(program: PolicyProgram, sites: Sequence[str], *,
                 depth: int | None = None) -> list[SitePolicies]:
    """Distinct per-step site tables the program can ever step with."""
    resolved = program.resolve(sites, depth=depth)
    sched = program.schedule
    scales = {0.0}
    if sched.target > 0:
        scales |= {min(b / sched.target, 1.0) for b in sched.rate_buckets}
    seen: list[SitePolicies] = []
    for s in sorted(scales):
        table = resolved.at_scale(s)
        if table not in seen:
            seen.append(table)
    return seen


def check_train_retrace(report: Report, program: PolicyProgram, sites: Sequence[str], *,
                        depth: int | None = None, budget: int | None = None) -> int:
    """Bound the train step's signatures; error when over budget."""
    if budget is None:
        budget = len(program.schedule.rate_buckets)
    n = len(train_tables(program, sites, depth=depth))
    report.add("retrace", ERROR if n > budget else INFO, "train_step",
               f"{n} distinct step table(s) (budget {budget}: one per schedule rate bucket)",
               executables=n, budget=budget, rate_buckets=list(program.schedule.rate_buckets))
    return n


def serve_executables(cfg, serve_cfg) -> dict[str, int]:
    """Step signatures per engine function, from the configs alone."""
    out = {"_step_fn": len(serve_cfg.widths)}
    if serve_cfg.spec_k > 0:
        draft_widths = {serve_cfg.prefill_chunk}
        if serve_cfg.spec_k > 1:
            draft_widths.add(1)
        out["_draft_step_fn"] = len(draft_widths)
    if cfg.family == "encdec":
        out["_encode"] = 1
        if serve_cfg.spec_k > 0:
            out["_draft_encode"] = 1
    return out


def check_serve_retrace(report: Report, cfg, serve_cfg, *, budget: int = SERVE_JIT_BUDGET) -> int:
    """Bound the serve engine's signatures; error when over budget."""
    per_fn = serve_executables(cfg, serve_cfg)
    total = sum(per_fn.values())
    report.add("retrace", ERROR if total > budget else INFO, "serve_engine",
               f"{total} step signature(s) across {len(per_fn)} function(s) (budget {budget}); "
               f"widths {list(serve_cfg.widths)}",
               executables=total, budget=budget, per_fn=per_fn, widths=list(serve_cfg.widths))
    return total
