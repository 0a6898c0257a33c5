"""Distributed training layer: sharding rules + fault tolerance.

The twin of ``repro.dist``. ``repro_torch.dist.sharding`` holds the
partition-spec rules that the JAX package's train / dryrun / serve paths
share. Specs are assigned by parameter *name* over a param tree in the
JAX package's layout and then repaired against a concrete mesh shape by
:func:`sharding.fit_spec`, so one rule table covers every registry
architecture at every mesh size. On a device mesh
(``launch/mesh.py``) a fitted spec gives each rank a block of a leaf,
and :func:`sharding.shard_tree` / :func:`sharding.gather_tree` give each
rank its local shards and the full tensors back; the specs also drive
:func:`repro_torch.checkpoint.ckpt.plan_from_specs`.
``repro_torch.dist.parallel`` holds the collectives of a step on the
mesh, each an ``autograd.Function`` with its backward written out.

Sharding rule table (tensor → mesh axis placement):

  ===========================  ==========================  ============
  tensor                       shape                       spec
  ===========================  ==========================  ============
  embed table                  [V, d]                      ("model", -)
  attn q/k/v kernel            [np, d, H*hd]               (-, -, "model")
  attn o kernel                [np, H*hd, d]               (-, "model", -)
  mlp up/gate kernel           [np, d, ff]                 (-, -, "model")
  mlp down kernel              [np, ff, d]                 (-, "model", -)
  MoE expert gate/up           [np, E, d, ff]              (-, "model", -, -)
  MoE expert down              [np, E, ff, d]              (-, "model", -, -)
  ssm in_proj kernel           [np, d, X]                  (-, -, "model")
  ssm out_proj kernel          [np, di, d]                 (-, "model", -)
  norms / biases / router      any                         replicated
  batch inputs                 [B, ...]                    (dp, -, ...)
  KV cache k/v                 [np, B, T, KV, hd]          (-, dp, -, "model", -)
    (seq_shard=True moves "model" to the T dim for long decode)
  paged KV pool k/v            [np, NB, bs, KV, hd]        (-, -, -, "model", -)
    (paged=True: page axis replicated — block tables index the
     pool globally, so dp-sharding pages would make every gather
     a collective; block tables themselves are replicated)
  swap-staged KV pages         [np, n, bs, KV, hd]         (-, -, -, "model", -)
  swap-staged ssm state row    [np, H, N, P]               (-, "model", -, -)
  swap-staged conv row         [np, K-1, C]                (-, -, "model")
    (``swap_specs``: host-staged swap-preemption bundles land
     laid out like the pool they scatter into)
  ===========================  ==========================  ============

``dp`` is the data-parallel axis group — ``("pod", "data")`` on the
multi-pod mesh, ``"data"`` otherwise. Any placement whose dim is not
divisible by the mesh axis size is relocated by ``fit_spec`` to the
nearest divisible free dim (ties prefer the later dim), falling back to
replication when no dim is legal. A *tuple* of axes whose product does
not divide its dim is split jointly: the largest divisible sub-tuple
stays put and the leftover axes relocate one by one (the multi-pod
``("pod", "data")`` batch split at ``batch < dp_size`` keeps ``pod``
on batch and moves ``data`` to the seq dim).

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
