"""Drop-rate schedules (paper Fig. 2(c)/(d)) — first-class objects.

The port's own copy of ``repro.core.schedulers`` (which imports no JAX),
line for line; ``tests/test_torch_train.py`` holds it to the original.

A :class:`Schedule` maps the training step to a drop rate in
``[0, target]``. Schedules run in the *host* training loop (Python
floats): the keep count K is a Python int per step (see ``policy.py``);
each schedule owns its own :meth:`~Schedule.rate`,
:meth:`~Schedule.average_rate` and bucket quantization.

The paper's winner is the **bar schedule with a 2-epoch period**
(:class:`EpochBar`): dense on even epochs, full target rate on odd
epochs — the average rate over training is ``target / 2`` (≈40% for the
80% target), matching the paper's "nearly 40% computation saved".

The registry :data:`SCHEDULES` maps the legacy string names to classes;
:func:`make_schedule` builds one from a name plus the run shape. The
module-level ``*_schedule`` functions and :func:`drop_rate_for_step` /
:func:`average_rate` remain as thin shims over the objects for older
call sites.
"""
from __future__ import annotations

import dataclasses
import math

_DEFAULT_BUCKETS = (0.0, 0.25, 0.5, 0.8, 0.95)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base class: step → drop rate, plus bucket quantization.

    Attributes:
      target: the schedule's peak drop rate (e.g. 0.8 for the paper's
        bar schedule). ``rate(step)`` never exceeds it.
      rate_buckets: allowed compiled drop rates. :meth:`bucketed_rate`
        rounds the scheduled rate to the nearest bucket so the jit
        cache stays small — at most ``len(rate_buckets)`` distinct
        compiled steps per run, whatever the schedule's shape.
    """

    target: float = 0.8
    rate_buckets: tuple[float, ...] = _DEFAULT_BUCKETS

    def rate(self, step: int) -> float:
        """Raw scheduled drop rate at ``step`` (subclasses implement)."""
        raise NotImplementedError

    def bucketed_rate(self, step: int) -> float:
        """``rate(step)`` rounded to the nearest allowed bucket."""
        r = self.rate(step)
        return min(self.rate_buckets, key=lambda b: abs(b - r))

    def scale(self, step: int) -> float:
        """Activation fraction in [0, 1]: bucketed rate / target.

        This is what a :class:`~repro.core.policy.PolicyProgram` uses to
        modulate *per-site* target rates: every site runs at
        ``site_target * scale(step)``, so a bar schedule flips all sites
        between dense and their own targets in lock-step. Quantized
        through the schedule's buckets, so a whole run sees at most
        ``len(rate_buckets)`` distinct scales (and therefore at most
        that many compiled executables).
        """
        if self.target <= 0.0:
            return 0.0
        return min(self.bucketed_rate(step) / self.target, 1.0)

    def average_rate(self, total_steps: int) -> float:
        """Mean raw drop rate over ``total_steps`` (drives total-FLOPs
        accounting). Exact summation; subclasses with a closed form
        override."""
        if total_steps <= 0:
            return 0.0
        return sum(self.rate(s) for s in range(total_steps)) / total_steps


@dataclasses.dataclass(frozen=True)
class Constant(Schedule):
    """Fixed drop rate for the whole run (paper's 'constant' baseline)."""

    def rate(self, step: int) -> float:
        del step
        return self.target

    def average_rate(self, total_steps: int) -> float:
        return self.target if total_steps > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class Linear(Schedule):
    """Ramp 0 → target linearly from first to last step."""

    total_steps: int = 100

    def rate(self, step: int) -> float:
        progress = step / max(self.total_steps - 1, 1)
        return self.target * min(max(progress, 0.0), 1.0)


@dataclasses.dataclass(frozen=True)
class Cosine(Schedule):
    """Ramp 0 → target with a cosine ease-in."""

    total_steps: int = 100

    def rate(self, step: int) -> float:
        progress = step / max(self.total_steps - 1, 1)
        p = min(max(progress, 0.0), 1.0)
        return self.target * 0.5 * (1.0 - math.cos(math.pi * p))


@dataclasses.dataclass(frozen=True)
class Bar(Schedule):
    """Step function: 0 for the first half of training, target after."""

    total_steps: int = 100

    def rate(self, step: int) -> float:
        progress = step / max(self.total_steps - 1, 1)
        return self.target if progress >= 0.5 else 0.0


@dataclasses.dataclass(frozen=True)
class EpochBar(Schedule):
    """The paper's best config: 2-epoch period bar.

    Epoch 0, 2, 4, ... train dense; epoch 1, 3, 5, ... train at the
    target rate. (Paper numbers epochs from 1 and trains normally in
    epochs 1, 3, 5 — identical parity pattern.) Over a whole run the
    average rate is ``target / 2`` — the paper's ~40% saving at 0.8.
    """

    steps_per_epoch: int = 1

    def rate(self, step: int) -> float:
        epoch = step // max(self.steps_per_epoch, 1)
        return self.target if (epoch % 2 == 1) else 0.0

    def average_rate(self, total_steps: int) -> float:
        # Closed form target/2 (the paper's saving claim) holds exactly
        # for whole 2-epoch periods; partial runs sum the true per-step
        # rates — a 1-epoch run trains entirely dense and must report 0.
        if total_steps <= 0:
            return 0.0
        if total_steps % (2 * max(self.steps_per_epoch, 1)) == 0:
            return self.target / 2.0
        return super().average_rate(total_steps)


@dataclasses.dataclass(frozen=True)
class PeriodicBar(Schedule):
    """Iteration-periodic bar (paper Fig. 2(d), 30–300-iteration periods).

    First half of each period dense, second half at target rate.
    """

    period: int = 100

    def __post_init__(self):
        if self.period <= 0:
            raise ValueError("period must be positive")

    def rate(self, step: int) -> float:
        return self.target if (step % self.period) >= (self.period // 2) else 0.0

    def average_rate(self, total_steps: int) -> float:
        if total_steps <= 0:
            return 0.0
        if total_steps % self.period == 0:
            sparse = self.period - self.period // 2
            return self.target * sparse / self.period
        return super().average_rate(total_steps)


SCHEDULES = {
    "constant": Constant,
    "linear": Linear,
    "cosine": Cosine,
    "bar": Bar,
    "epoch_bar": EpochBar,
    "periodic_bar": PeriodicBar,
}

SCHEDULE_NAMES = tuple(SCHEDULES)


def make_schedule(
    name: str,
    *,
    target: float,
    total_steps: int = 100,
    steps_per_epoch: int = 1,
    period: int = 100,
    rate_buckets: tuple[float, ...] = _DEFAULT_BUCKETS,
) -> Schedule:
    """Build a :class:`Schedule` from its legacy string name.

    Only the shape parameter the named schedule uses is consumed
    (``total_steps`` for linear/cosine/bar, ``steps_per_epoch`` for
    epoch_bar, ``period`` for periodic_bar).
    """
    try:
        cls = SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; known: {sorted(SCHEDULES)}"
        ) from None
    kw = {"target": target, "rate_buckets": rate_buckets}
    if cls in (Linear, Cosine, Bar):
        kw["total_steps"] = total_steps
    elif cls is EpochBar:
        kw["steps_per_epoch"] = steps_per_epoch
    elif cls is PeriodicBar:
        kw["period"] = period
    return cls(**kw)


# ----------------------------------------------------------------------
# legacy functional API — thin shims over the Schedule objects
# ----------------------------------------------------------------------


def constant_schedule(progress: float, target: float) -> float:
    del progress
    return target


def linear_schedule(progress: float, target: float) -> float:
    return target * min(max(progress, 0.0), 1.0)


def cosine_schedule(progress: float, target: float) -> float:
    p = min(max(progress, 0.0), 1.0)
    return target * 0.5 * (1.0 - math.cos(math.pi * p))


def bar_schedule(progress: float, target: float) -> float:
    return target if progress >= 0.5 else 0.0


def epoch_bar_schedule(epoch: int, target: float) -> float:
    return target if (epoch % 2 == 1) else 0.0


def periodic_bar_schedule(step: int, period: int, target: float) -> float:
    if period <= 0:
        raise ValueError("period must be positive")
    return target if (step % period) >= (period // 2) else 0.0


def drop_rate_for_step(
    scheduler: str,
    *,
    step: int,
    steps_per_epoch: int,
    total_steps: int,
    target: float,
    period: int = 0,
) -> float:
    """Legacy entry point: resolve one step's rate from a string name."""
    sched = make_schedule(
        scheduler,
        target=target,
        total_steps=total_steps,
        steps_per_epoch=steps_per_epoch,
        period=period,
    )
    return sched.rate(step)


def average_rate(
    scheduler: str,
    *,
    total_steps: int,
    steps_per_epoch: int,
    target: float,
    period: int = 0,
) -> float:
    """Legacy entry point: mean drop rate over a whole run."""
    sched = make_schedule(
        scheduler,
        target=target,
        total_steps=total_steps,
        steps_per_epoch=steps_per_epoch,
        period=period,
    )
    return sched.average_rate(total_steps)
