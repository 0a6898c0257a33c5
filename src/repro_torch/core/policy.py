"""ssProp policy configuration for one call site.

The port's copy of the plain-policy half of ``repro.core.policy``:
:class:`SsPropPolicy` with every field and check, :data:`DENSE`,
:func:`paper_default`, :func:`tpu_default` and :func:`policy_for`.
The per-site tables (``SitePolicies``, ``PolicyRules``,
``PolicyProgram``) are not ported yet: :func:`policy_for` refuses
anything but a plain policy.

The keep count K is a Python int per step: the train loop picks the
step's policy (dense or sparse, through the schedule) on the host, and
the backward sizes its gathers from it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.schedulers import SCHEDULE_NAMES


@dataclasses.dataclass(frozen=True)
class SsPropPolicy:
    """Static configuration for scheduled sparse back-propagation.

    Attributes (as in the JAX package):
      drop_rate: fraction of output channels whose gradients are dropped
        in the current step. 0.0 disables sparsification.
      granularity: ``"channel"`` = per-channel top-k (paper-faithful);
        ``"block"`` = top-k over contiguous channel blocks of
        ``block_size``.
      block_size: channel-block width for ``granularity="block"``.
      selection: ``"topk"`` (paper) or ``"random"`` (Fig. 2(b) ablation).
      scheduler: name of the schedule that produced this rate (logging
        and FLOPs accounting only); validated against the registry.
      target_rate: the schedule's target drop rate for this site.
      rate_buckets: allowed drop rates; scheduled rates round to the
        nearest bucket.
      mask_mode: if True, dropped channels are zeroed but the
        contractions stay full-size (the oracle every route must match).
      sparsify_dx / sparsify_dw: apply sparsity to the input-gradient /
        weight-gradient contraction. Paper uses both.
      use_pallas: route the shrunk backward contractions through the
        gathered kernels (the name is the JAX package's; in the port
        these are the hand-written CUDA kernels, and their plain
        versions on the CPU).
      fuse_im2col: with ``use_pallas`` on a conv site, address im2col
        patches inside the fused kernels instead of materializing the
        ``[M, C_in*Kh*Kw]`` patch buffer first.
      tp_shards: >0: per-shard balanced top-k (not ported yet).
      bwd_dtype: ``"bfloat16"``: backward contractions in bf16.
      seed: RNG seed for ``selection="random"``.
    """

    drop_rate: float = 0.0
    granularity: str = "channel"  # "channel" | "block"
    block_size: int = 128
    selection: str = "topk"  # "topk" | "random"
    scheduler: str = "epoch_bar"  # see schedulers.SCHEDULES
    target_rate: float = 0.8
    rate_buckets: tuple[float, ...] = (0.0, 0.25, 0.5, 0.8, 0.95)
    mask_mode: bool = False
    sparsify_dx: bool = True
    sparsify_dw: bool = True
    use_pallas: bool = False
    fuse_im2col: bool = True  # conv sites: patch extraction in-kernel
    tp_shards: int = 0
    bwd_dtype: str = ""  # "bfloat16": backward contractions in bf16
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(f"drop_rate must be in [0, 1), got {self.drop_rate}")
        if self.granularity not in ("channel", "block"):
            raise ValueError(f"bad granularity {self.granularity!r}")
        if self.selection not in ("topk", "random"):
            raise ValueError(f"bad selection {self.selection!r}")
        if self.scheduler not in SCHEDULE_NAMES:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; "
                f"known: {sorted(SCHEDULE_NAMES)}"
            )

    @property
    def active(self) -> bool:
        return self.drop_rate > 0.0

    def keep_count(self, channels: int) -> int:
        """Number of channels (or blocks) retained for ``channels`` outputs.

        Per-channel: K = max(1, round((1-D) * C)).
        Block: computed over ceil(C / block_size) blocks, at least 1 block.
        """
        if self.granularity == "channel":
            return max(1, int(round((1.0 - self.drop_rate) * channels)))
        nblocks = -(-channels // self.block_size)
        return max(1, int(round((1.0 - self.drop_rate) * nblocks)))

    def with_rate(self, rate: float) -> SsPropPolicy:
        return dataclasses.replace(self, drop_rate=float(rate))

    def with_target(self, rate: float) -> SsPropPolicy:
        """Same knobs, retargeted to ``rate`` (and currently at it)."""
        return dataclasses.replace(self, drop_rate=float(rate), target_rate=float(rate))

    def bucketed(self, rate: float) -> SsPropPolicy:
        """Round ``rate`` to the nearest allowed bucket and return a policy."""
        best = min(self.rate_buckets, key=lambda b: abs(b - rate))
        return self.with_rate(best)


DENSE = SsPropPolicy(drop_rate=0.0, target_rate=0.0)
"""The canonical "never sparsify" policy (``target_rate`` pinned to 0)."""


def paper_default(drop_rate: float = 0.8) -> SsPropPolicy:
    """The paper's winning configuration: channel top-k + 2-epoch bar."""
    return SsPropPolicy(
        drop_rate=drop_rate,
        granularity="channel",
        selection="topk",
        scheduler="epoch_bar",
        target_rate=drop_rate,
    )


def tpu_default(drop_rate: float = 0.8) -> SsPropPolicy:
    """128-channel-block top-k (the JAX package's TPU configuration; the
    port keeps its name so both packages route alike)."""
    return SsPropPolicy(
        drop_rate=drop_rate,
        granularity="block",
        block_size=128,
        selection="topk",
        scheduler="epoch_bar",
        target_rate=drop_rate,
    )


def policy_for(policy: SsPropPolicy, site: str) -> SsPropPolicy:
    """The policy for one named call site: a plain :class:`SsPropPolicy`
    applies to every site. Per-site tables are not ported yet."""
    if not isinstance(policy, SsPropPolicy):
        raise NotImplementedError(
            f"{type(policy).__name__} (per-site policy tables and programs) is not "
            "ported yet: pass a plain SsPropPolicy"
        )
    del site
    return policy
