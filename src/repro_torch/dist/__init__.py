"""Distributed training layer: fault tolerance and the file-based process group.

The twin of ``repro.dist``'s fault-tolerance half. Its sharding rules
(``repro.dist.sharding``) wait for meshes, which are not ported yet.

``repro_torch.dist.compat`` provides ``initialize()`` — the
``jax.distributed``-style multi-process entry point, coordinated
through a shared filesystem directory instead of a service — and
the :class:`~repro_torch.dist.compat.ProcessGroup` control-plane
collectives (barrier / gather / broadcast of JSON payloads, never
tensors).

``repro_torch.dist.fault`` implements the file-based **rank-complete**
fault-tolerance protocol used by the training driver:

  * ``Heartbeat`` — EVERY rank touches ``<dir>/rank_<r>`` at most
    every ``interval_s`` seconds; the file mtime IS the liveness
    signal (no server, works on any shared filesystem).
  * ``HeartbeatMonitor.dead_ranks()`` — ranks whose heartbeat file
    mtime is older than ``timeout_s``, judged against the monitor's
    own same-filesystem sentinel mtime (clock-skew safe).
  * ``FleetSupervisor`` — aggregates all heartbeats into membership
    *epochs* (atomically-published ``membership.json``): stale beat ⇒
    evict, rejoin request + fresh beat ⇒ un-evict; each bumps the
    epoch. The supervisor seat is the lowest active rank and fails
    over deterministically. Workers guard each step with
    ``check_epoch`` and abort with ``MembershipChanged`` on drift;
    the restart layer reshards them around the new active set, and a
    recovered rank re-enters through ``request_rejoin`` +
    ``wait_active``. See ``docs/distributed.md`` for the state
    machine.
  * ``StragglerTracker`` — per-rank step-time EWMA; a rank is a
    straggler when its EWMA exceeds ``slack`` × the median EWMA of
    the other ranks (leave-one-out, so it can't shift its own
    baseline).
  * ``StragglerSupervisor`` — detection → response: after ``patience``
    consecutive straggler verdicts it raises ``StragglerEvicted`` to
    abort the attempt.
  * ``RestartPolicy.run(attempt)`` — bounded-restart supervisor with
    exponential backoff; the driver resumes from the latest committed
    checkpoint on each attempt. ``StragglerEvicted`` aborts add the
    rank to ``RestartPolicy.excluded_ranks`` and restart immediately
    (no backoff, no budget slot); the attempt function reads the
    excluded-rank list on entry and reshards around the survivors.
"""
from repro_torch.dist.compat import (  # noqa: F401
    ProcessGroup,
    ProcessGroupTimeout,
    initialize,
    registered_ranks,
)
from repro_torch.dist.fault import (  # noqa: F401
    FleetSupervisor,
    Heartbeat,
    HeartbeatMonitor,
    HeartbeatThread,
    Membership,
    MembershipChanged,
    MembershipView,
    RestartPolicy,
    StragglerEvicted,
    StragglerSupervisor,
    StragglerTracker,
)
