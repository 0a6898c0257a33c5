"""ssProp policy configuration: one call site, and per-site programs.

The port's copy of ``repro.core.policy``: :class:`SsPropPolicy` with
every field and check, :data:`DENSE`, :func:`paper_default`,
:func:`tpu_default`; the per-site tables :class:`SitePolicies`
(resolved site -> policy), :class:`PolicyRules` (ordered glob rules over
site names, with brace sets, negative indices and ranges),
:class:`PolicyProgram` (rules x schedule) and :class:`ResolvedProgram`
(the per-step tables); and :func:`policy_for`, which a model calls at
each named site with either a plain policy or a table.

The keep count K is a Python int per step: the train loop picks the
step's table (through the schedule) on the host, and the backward sizes
its gathers from it.
"""
from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import fnmatch
import re

from repro_torch.core.schedulers import SCHEDULE_NAMES, Constant, Schedule


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


# ----------------------------------------------------------------------
# site tables
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SitePolicies:
    """A resolved site -> policy table (hashable).

    The per-model output of :meth:`PolicyRules.resolve`: one entry per
    enumerated call site. Lookups of names outside the table fall back
    to ``default``, so model code can thread a ``SitePolicies`` anywhere
    a plain :class:`SsPropPolicy` is accepted and every named call site
    picks up its own policy through :func:`policy_for`.
    """

    entries: tuple[tuple[str, SsPropPolicy], ...]
    default: SsPropPolicy = DENSE

    def __post_init__(self):
        object.__setattr__(self, "_table", dict(self.entries))

    def __getitem__(self, name: str) -> SsPropPolicy:
        return self._table.get(name, self.default)

    def __contains__(self, name: str) -> bool:
        return name in self._table

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.entries)

    def scoped(self, prefix: str) -> SitePolicies:
        """The sub-table under ``prefix + "/"``, names stripped of it:
        ``table.scoped("layer_3")["attn/q"] == table["layer_3/attn/q"]``."""
        cut = len(prefix) + 1
        sub = tuple((n[cut:], p) for n, p in self.entries if n.startswith(prefix + "/"))
        return SitePolicies(sub, default=self.default)

    def uniform(self) -> SsPropPolicy | None:
        """The single policy if every entry (and the default) agrees."""
        pols = {p for _, p in self.entries} | {self.default}
        return next(iter(pols)) if len(pols) == 1 else None


PolicyLike = SsPropPolicy | SitePolicies


def policy_for(policy: PolicyLike, site: str) -> SsPropPolicy:
    """The policy for one named call site: a plain :class:`SsPropPolicy`
    applies to every site; a :class:`SitePolicies` table looks the site
    up by name. Anything else (the JAX package's objects included)
    raises."""
    if isinstance(policy, SitePolicies):
        return policy[site]
    if not isinstance(policy, SsPropPolicy):
        raise TypeError(f"policy_for: {type(policy).__name__} is neither SsPropPolicy "
                        "nor SitePolicies")
    return policy


# ----------------------------------------------------------------------
# rule patterns
# ----------------------------------------------------------------------

_BRACE = re.compile(r"\{([^{}]*)\}")
_RANGE = re.compile(r"^(-?\d+)\.\.(-?\d+)$")
_INT = re.compile(r"^-?\d+$")


def _resolve_index(value: int, depth: int | None, pattern: str) -> int:
    if value < 0:
        if depth is None:
            raise ValueError(
                f"pattern {pattern!r} uses a negative index but the model "
                "has no depth to resolve it against"
            )
        value += depth
    return value


def expand_pattern(pattern: str, depth: int | None = None) -> tuple[str, ...]:
    """Expand brace sets into plain glob patterns.

    Items in ``{...}`` may be literals (``{conv1,conv2}``), integers
    (negative ones resolve against ``depth``, Python-style:
    ``layer_{0,-1}``) or inclusive ranges (``layer_{2..5}``,
    ``layer_{0..-2}``). Several groups expand as a cartesian product.
    """
    m = _BRACE.search(pattern)
    if not m:
        return (pattern,)
    head, tail = pattern[: m.start()], pattern[m.end():]
    items = []
    for part in m.group(1).split(","):
        part = part.strip()
        rm = _RANGE.match(part)
        if rm:
            lo = _resolve_index(int(rm.group(1)), depth, pattern)
            hi = _resolve_index(int(rm.group(2)), depth, pattern)
            items.extend(str(v) for v in range(lo, hi + 1))
        elif _INT.match(part):
            items.append(str(_resolve_index(int(part), depth, pattern)))
        else:
            items.append(part)
    out = []
    for it in items:
        out.extend(expand_pattern(head + it + tail, depth))
    return tuple(out)


def pattern_matches(pattern: str, site: str, depth: int | None = None) -> bool:
    """fnmatch-style match of one rule pattern against a site name."""
    return any(fnmatch.fnmatchcase(site, glob) for glob in expand_pattern(pattern, depth))


# ----------------------------------------------------------------------
# rule table
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyRules:
    """Ordered (pattern, policy) rules over site names; first match wins.

    A rule's policy carries the site's *target* rate (``target_rate``);
    the schedule scales every site between 0 and its own target in
    lock-step.
    """

    rules: tuple[tuple[str, SsPropPolicy], ...]
    default: SsPropPolicy = DENSE

    @classmethod
    def single(cls, policy: SsPropPolicy) -> PolicyRules:
        """The trivial one-rule program: ``policy`` at every site."""
        return cls(rules=(("*", policy),), default=policy)

    @classmethod
    def of(cls, *rules, base: SsPropPolicy, default: SsPropPolicy | None = None):
        """Rules from (pattern, rate-or-policy) pairs: a float rate becomes
        ``base.with_target(rate)``; ``default`` falls back to dense."""
        rows = []
        for pattern, rule in rules:
            if not isinstance(rule, SsPropPolicy):
                rule = base.with_target(float(rule))
            rows.append((pattern, rule))
        return cls(
            rules=tuple(rows),
            default=base.with_target(0.0) if default is None else default,
        )

    @classmethod
    def parse(cls, text: str, base: SsPropPolicy) -> PolicyRules:
        """Parse the CLI mini-grammar ``"pattern=rate;pattern=rate"``;
        ``rate`` is a float target drop rate or the word ``dense`` (0.0),
        e.g. ``layer_{0,-1}/*=dense;*/attn/*=0.5;*=0.8``."""
        rows = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            pattern, _, rate = clause.rpartition("=")
            if not pattern:
                raise ValueError(f"bad rule clause {clause!r} (want pattern=rate)")
            rows.append((pattern, 0.0 if rate.strip() == "dense" else float(rate)))
        return cls.of(*rows, base=base)

    def resolve(self, sites: Sequence[str], *, depth: int | None = None) -> SitePolicies:
        """Assign every enumerated site its policy (first match wins)."""
        entries = []
        for site in sites:
            for pattern, pol in self.rules:
                if pattern_matches(pattern, site, depth):
                    entries.append((site, pol))
                    break
            else:
                entries.append((site, self.default))
        return SitePolicies(tuple(entries), default=self.default)


# ----------------------------------------------------------------------
# programs
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyProgram:
    """Rules + schedule: the one ssProp control surface.

    ``program.resolve(sites, depth=...)`` binds the rules to a model; the
    :class:`ResolvedProgram` then answers ``policies_for_step(step)``.
    """

    rules: PolicyRules
    schedule: Schedule

    @classmethod
    def single(cls, policy: SsPropPolicy, schedule: Schedule | None = None) -> PolicyProgram:
        """One global policy, optionally scheduled. Without a schedule the
        program runs exactly this policy every step (a ``Constant`` at its
        ``drop_rate``, the rate added to the buckets if it is not one);
        with a schedule the policy's ``target_rate`` is the peak."""
        if schedule is None:
            policy = policy.with_target(policy.drop_rate)
            if policy.drop_rate not in policy.rate_buckets:
                policy = dataclasses.replace(
                    policy,
                    rate_buckets=tuple(sorted((*policy.rate_buckets, policy.drop_rate))),
                )
            schedule = Constant(target=policy.target_rate, rate_buckets=policy.rate_buckets)
        return cls(rules=PolicyRules.single(policy), schedule=schedule)

    def resolve(self, sites: Sequence[str], *, depth: int | None = None) -> ResolvedProgram:
        return ResolvedProgram(sites=self.rules.resolve(sites, depth=depth),
                               schedule=self.schedule)


@dataclasses.dataclass(frozen=True)
class ResolvedProgram:
    """A program bound to one model's site table.

    ``sites`` holds every site at its *target* rate; the table of a step
    scales each site by the schedule's bucket-quantized activation, so a
    run sees at most ``len(schedule.rate_buckets)`` distinct tables.
    """

    sites: SitePolicies
    schedule: Schedule

    def at_scale(self, scale: float) -> SitePolicies:
        """Every site at ``site_target * scale``, bucket-quantized."""

        def mod(p: SsPropPolicy) -> SsPropPolicy:
            return p.bucketed(p.target_rate * scale)

        return SitePolicies(
            tuple((n, mod(p)) for n, p in self.sites.entries),
            default=mod(self.sites.default),
        )

    def policies_for_step(self, step: int) -> SitePolicies:
        return self.at_scale(self.schedule.scale(step))

    def peak(self) -> SitePolicies:
        """The fully-on table (scale 1): what a sparse epoch runs."""
        return self.at_scale(1.0)
