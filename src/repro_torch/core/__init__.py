"""ssProp core in PyTorch: scheduled channel-sparse back-propagation.

The twin of ``repro.core``:

* :mod:`~repro_torch.core.backward`   — the channel-sparse backward engine;
* :mod:`~repro_torch.core.sparsity`   — importance and top-k selection;
* :mod:`~repro_torch.core.schedulers` — drop-rate schedules;
* :mod:`~repro_torch.core.conv` / :mod:`~repro_torch.core.dense` —
  ``sparse_conv2d`` / ``sparse_dense`` as ``torch.autograd.Function``s;
* :mod:`~repro_torch.core.flops`      — the paper's backward-FLOPs
  model and the traffic model the conv routing gate reads;
* :mod:`~repro_torch.core.policy`     — ``SsPropPolicy``, its presets and
  the per-site programs (``PolicyRules``, ``PolicyProgram``,
  ``SitePolicies``).
"""
from repro_torch.core.backward import ChannelSparseOp, channel_sparse_backward
from repro_torch.core.conv import sparse_conv2d
from repro_torch.core.dense import sparse_dense
from repro_torch.core.policy import (
    DENSE,
    PolicyProgram,
    PolicyRules,
    SitePolicies,
    SsPropPolicy,
    paper_default,
    policy_for,
    tpu_default,
)

__all__ = [
    "DENSE",
    "ChannelSparseOp",
    "PolicyProgram",
    "PolicyRules",
    "SitePolicies",
    "SsPropPolicy",
    "channel_sparse_backward",
    "paper_default",
    "policy_for",
    "sparse_conv2d",
    "sparse_dense",
    "tpu_default",
]
