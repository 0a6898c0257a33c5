"""The program auditor: a census of each step, lints, retrace budgets and
launch checks (twin of ``repro.analysis``).

Nothing here runs on a device: the steps run on ``meta`` tensors under a
``TorchDispatchMode`` (:mod:`~repro_torch.analysis.dispatch_walk`, the
twin of the reference's jaxpr walk), and the kernels' launches are
evaluated from their specs (``kernels/specs.py``). Modules:

* :mod:`~repro_torch.analysis.savings` — each site's backward census
  against the FLOPs model (``core/flops.py``).
* :mod:`~repro_torch.analysis.lints` — dtype-leak, host-sync and
  dead-code lints over censuses.
* :mod:`~repro_torch.analysis.retrace` — step-signature budgets of the
  policy program and the serving engine.
* :mod:`~repro_torch.analysis.launch_check` — in-bounds, ragged-tail,
  shared-memory and traffic checks of the kernels' launches.
* ``launch/analyze.py`` — the CLI that runs all of it for one config;
  ``launch/dryrun.py`` the dry run of every arch x shape cell.
"""
from repro_torch.analysis import dispatch_walk, launch_check, lints, retrace, savings
from repro_torch.analysis.report import ERROR, INFO, WARN, Finding, Report

__all__ = [
    "ERROR",
    "INFO",
    "WARN",
    "Finding",
    "Report",
    "dispatch_walk",
    "launch_check",
    "lints",
    "retrace",
    "savings",
]
