"""File-based fault tolerance: heartbeats, membership, bounded restart.

The protocol needs nothing but a shared filesystem (the checkpoint
directory): each rank touches ``<dir>/rank_<r>``; a monitor reads the
mtimes. On top of the per-rank signals sits the **rank-complete**
supervisor layer:

* every rank beats (not just rank 0); :class:`HeartbeatMonitor`
  aggregates all of them against its own filesystem-clock sentinel;
* :class:`FleetSupervisor` turns stale heartbeats into *membership
  epochs* — an atomically-published ``membership.json`` that names the
  active and evicted ranks. Evicting and un-evicting both bump the
  epoch; workers that observe a new epoch abort their attempt with
  :class:`MembershipChanged` and reshard around the new active set;
* a recovered rank **rejoins**: it touches its heartbeat again, files a
  rejoin request, and waits; the supervisor un-evicts it on the next
  poll, the epoch bumps, and every rank (the rejoiner included)
  restarts on the grown mesh from the last committed checkpoint.

The twin of ``repro.dist.fault`` (a copy: the port imports nothing of
the JAX package), with the same semantics and defaults. See the module
docstring of ``repro_torch.dist`` for the full contract.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
import dataclasses
import json
import os
import statistics
import time

_PREFIX = "rank_"
_SENTINEL = "monitor.sentinel"


class Heartbeat:
    """One rank's liveness signal: touch ``<dir>/rank_<r>`` on beat().

    ``interval_s`` throttles filesystem traffic from the train loop —
    ``beat()`` is a no-op until the interval has elapsed (``force=True``
    bypasses the throttle, e.g. the first beat after (re)start).
    """

    def __init__(self, hb_dir: str, rank: int, interval_s: float = 5.0):
        self.hb_dir = hb_dir
        self.rank = rank
        self.interval_s = interval_s
        self.path = os.path.join(hb_dir, f"{_PREFIX}{rank:05d}")
        self._last = 0.0

    def beat(self, *, force: bool = False) -> bool:
        now = time.time()
        if not force and now - self._last < self.interval_s:
            return False
        os.makedirs(self.hb_dir, exist_ok=True)
        with open(self.path, "w") as f:
            f.write(str(now))
        self._last = now
        return True


class HeartbeatThread:
    """Background beater: keeps a rank's heartbeat fresh through long
    main-thread stalls — long first steps (kernel builds), blocking checkpoint
    commits, restore replays. The heartbeat then signals *process
    liveness*, which is the contract the eviction protocol wants: a
    SIGKILL takes the thread down with the process (detected within
    ``timeout_s``), while a rank that is merely busy compiling is NOT
    falsely evicted. Slow-but-alive ranks are the straggler layer's
    job, not the heartbeat's.

    Daemon thread; ``stop()`` is graceful but optional.
    """

    def __init__(self, hb: Heartbeat):
        import threading

        self.hb = hb
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.hb.beat(force=True)
            self._stop.wait(self.hb.interval_s)

    def start(self) -> "HeartbeatThread":
        self.hb.beat(force=True)  # visible before the thread spins up
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2 * self.hb.interval_s + 1.0)


class HeartbeatMonitor:
    """Reads every rank's heartbeat mtime; stale ⇒ dead.

    Heartbeat mtimes are stamped by the *filesystem* (an NFS server's
    clock), so comparing them against the monitor host's ``time.time()``
    invites clock skew: a monitor running ahead of the file server
    falsely evicts live ranks, one running behind never evicts dead
    ones. By default ``dead_ranks`` therefore touches its **own
    sentinel file** on the same filesystem and uses that file's mtime as
    ``now`` — both sides of the comparison then share the one clock that
    stamped them. Pass an explicit ``now`` to override (tests, or a
    caller that already holds a same-filesystem timestamp).
    """

    def __init__(self, hb_dir: str, timeout_s: float = 60.0):
        self.hb_dir = hb_dir
        self.timeout_s = timeout_s
        self._sentinel = os.path.join(hb_dir, _SENTINEL)

    def last_seen(self) -> dict[int, float]:
        """rank → heartbeat file mtime (empty when no dir/beats yet)."""
        out: dict[int, float] = {}
        if not os.path.isdir(self.hb_dir):
            return out
        for name in os.listdir(self.hb_dir):
            if not name.startswith(_PREFIX):
                continue
            try:
                rank = int(name[len(_PREFIX):])
                out[rank] = os.path.getmtime(os.path.join(self.hb_dir, name))
            except (ValueError, OSError):
                continue  # foreign file, or beat racing the scan
        return out

    def filesystem_now(self) -> float:
        """Touch the monitor's sentinel; return its mtime — a timestamp
        from the same clock that stamps the heartbeat files."""
        os.makedirs(self.hb_dir, exist_ok=True)
        with open(self._sentinel, "w") as f:
            f.write("monitor clock sentinel\n")
        return os.path.getmtime(self._sentinel)

    def dead_ranks(self, now: float | None = None) -> list[int]:
        seen = self.last_seen()
        if not seen:
            return []
        if now is None:
            now = self.filesystem_now()
        return sorted(r for r, t in seen.items() if now - t > self.timeout_s)


# ----------------------------------------------------------------------
# fleet membership: rank-complete eviction + un-evict/rejoin
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Membership:
    """One epoch of the fleet view: who is in, who is out.

    Immutable and totally ordered by ``epoch``; workers compare the
    epoch they trained under against the published one and reshard on
    any change (grow or shrink — both are just "the mesh is different
    now").
    """

    epoch: int
    active: tuple[int, ...]
    evicted: tuple[int, ...]

    @property
    def leader(self) -> int:
        """The supervisor seat: lowest active rank (fails over
        deterministically when the leader itself is evicted)."""
        return min(self.active) if self.active else -1

    def evict(self, ranks: Sequence[int]) -> "Membership":
        gone = [r for r in self.active if r in set(ranks)]
        if not gone:
            return self
        return Membership(
            epoch=self.epoch + 1,
            active=tuple(r for r in self.active if r not in set(gone)),
            evicted=tuple(sorted(set(self.evicted) | set(gone))),
        )

    def unevict(self, ranks: Sequence[int]) -> "Membership":
        back = [r for r in self.evicted if r in set(ranks)]
        if not back:
            return self
        return Membership(
            epoch=self.epoch + 1,
            active=tuple(sorted(set(self.active) | set(back))),
            evicted=tuple(r for r in self.evicted if r not in set(back)),
        )


class MembershipChanged(RuntimeError):
    """Abort signal: the fleet membership epoch moved under this attempt.

    Raised by workers when the published :class:`Membership` epoch
    differs from the one the attempt started on (a rank was evicted, or
    an evicted rank rejoined). :meth:`RestartPolicy.run` treats it like
    an eviction: restart *immediately* (no backoff, no restart-budget
    slot — the fleet changed shape, nothing is broken) so the attempt
    function re-reads the membership and reshards.
    """

    def __init__(self, membership: Membership):
        super().__init__(
            f"membership epoch {membership.epoch}: "
            f"active={list(membership.active)} evicted={list(membership.evicted)}"
        )
        self.membership = membership


class MembershipView:
    """The atomically-published fleet view (``<dir>/membership.json``).

    Readers never block and never observe a torn file (tmp + rename);
    concurrent supervisor writes are last-write-wins, which is safe
    because every would-be writer derives the same decision from the
    same heartbeat files — see :class:`FleetSupervisor`.
    """

    def __init__(self, coord_dir: str, world_size: int):
        self.path = os.path.join(coord_dir, "membership.json")
        self.world_size = world_size

    def initial(self) -> Membership:
        return Membership(0, tuple(range(self.world_size)), ())

    def read(self) -> Membership:
        try:
            with open(self.path) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            return self.initial()  # not yet published (or mid-rename)
        return Membership(
            int(obj["epoch"]),
            tuple(obj["active"]),
            tuple(obj["evicted"]),
        )

    def write(self, m: Membership) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "epoch": m.epoch,
                    "active": list(m.active),
                    "evicted": list(m.evicted),
                    "world_size": self.world_size,
                },
                f,
            )
        os.replace(tmp, self.path)


class FleetSupervisor:
    """Rank-complete fault supervision: every rank beats, the supervisor
    aggregates, eviction AND rejoin decisions cover any rank.

    One ``poll()`` pass:

    1. stale heartbeats among the active set ⇒ evict (epoch bump) —
       unless the rank left a ``<coord>/done/rank_<r>*`` completion
       marker (orderly leave, see :meth:`completed_ranks`);
    2. rejoin requests (``<coord>/rejoin/rank_<r>``) from evicted ranks
       whose heartbeat is *fresh again* ⇒ un-evict (epoch bump) and
       clear the request.

    The supervisor seat is the lowest active rank, but the decision
    procedure is a pure function of the shared files, so when the
    leader itself dies the next rank takes over by simply running
    ``poll()`` — duplicate writers converge on the same content
    (last-write-wins on an atomic rename).
    """

    def __init__(
        self,
        coord_dir: str,
        world_size: int,
        *,
        timeout_s: float = 60.0,
        monitor: HeartbeatMonitor | None = None,
    ):
        self.coord_dir = coord_dir
        self.view = MembershipView(coord_dir, world_size)
        self.monitor = (
            monitor
            if monitor is not None
            else HeartbeatMonitor(os.path.join(coord_dir, "hb"), timeout_s)
        )
        self._rejoin_dir = os.path.join(coord_dir, "rejoin")

    # -- worker-side rejoin request ------------------------------------

    def request_rejoin(self, rank: int) -> None:
        os.makedirs(self._rejoin_dir, exist_ok=True)
        with open(os.path.join(self._rejoin_dir, f"{_PREFIX}{rank:05d}"), "w") as f:
            f.write(str(os.getpid()))

    def _rejoin_requests(self) -> list[int]:
        if not os.path.isdir(self._rejoin_dir):
            return []
        out = []
        for name in os.listdir(self._rejoin_dir):
            if name.startswith(_PREFIX):
                try:
                    out.append(int(name[len(_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def _clear_rejoin(self, rank: int) -> None:
        try:
            os.remove(os.path.join(self._rejoin_dir, f"{_PREFIX}{rank:05d}"))
        except OSError:
            pass

    # -- worker-side orderly completion --------------------------------

    def completed_ranks(self) -> list[int]:
        """Ranks that finished the job and exited on purpose: a
        ``<coord>/done/rank_<r>*`` marker (written by the driver right
        before exit). Their heartbeats go silent exactly like a dead
        rank's, but completion is an orderly leave, NOT a fault — the
        supervisor exempts them from eviction so ranks that finish
        first don't trigger a reshard storm while stragglers drain."""
        done_dir = os.path.join(self.coord_dir, "done")
        if not os.path.isdir(done_dir):
            return []
        out = set()
        for name in os.listdir(done_dir):
            if name.startswith(_PREFIX):
                try:
                    out.add(int(name[len(_PREFIX):].split(".")[0]))
                except ValueError:
                    continue
        return sorted(out)

    # -- supervisor-side decision pass ---------------------------------

    def poll(self) -> Membership:
        """One supervision pass; returns the (possibly bumped) view."""
        m = self.view.read()
        now = self.monitor.filesystem_now()
        seen = self.monitor.last_seen()
        done = set(self.completed_ranks())

        # 1. eviction: active ranks whose beat is stale — or missing
        # entirely (initialize() guarantees every rank beat once, so a
        # missing file means the rank died before this poll ever saw
        # it). Ranks that COMPLETED are silent too, but on purpose —
        # never evicted.
        dead = [
            r
            for r in m.active
            if r not in done
            and (r not in seen or now - seen[r] > self.monitor.timeout_s)
        ]
        m2 = m.evict(dead)

        # 2. rejoin: an evicted rank asking back in must prove liveness
        # with a *fresh* heartbeat, else a stale request file from a
        # rank that died again would flap the membership.
        back = [
            r
            for r in self._rejoin_requests()
            if r in m2.evicted
            and r in seen
            and now - seen[r] <= self.monitor.timeout_s
        ]
        m3 = m2.unevict(back)
        for r in back:
            self._clear_rejoin(r)

        if m3.epoch != m.epoch:
            self.view.write(m3)
            return m3
        return m

    def should_poll(self, rank: int, m: Membership | None = None) -> bool:
        """Does ``rank`` currently hold (or inherit) the supervisor seat?

        The leader polls; any other active rank takes over only when the
        leader's own heartbeat has gone stale — otherwise exactly one
        writer runs per pass in the steady state.
        """
        m = self.view.read() if m is None else m
        if rank not in m.active:
            return False
        done = set(self.completed_ranks())
        # seat order skips completed ranks: a finished leader has
        # exited, so the lowest still-running active rank inherits
        live = [r for r in m.active if r not in done]
        if not live:
            return False
        lead = min(live)
        if rank == lead:
            return True
        others = [r for r in live if r != lead]
        if not others:
            return False
        seen = self.monitor.last_seen()
        if lead not in seen:
            return rank == min(others)
        now = self.monitor.filesystem_now()
        if now - seen[lead] > self.monitor.timeout_s:
            return rank == min(others)
        return False

    def check_epoch(self, epoch: int) -> Membership:
        """Worker-side guard: raise :class:`MembershipChanged` when the
        published epoch differs from the one this attempt trains on."""
        m = self.view.read()
        if m.epoch != epoch:
            raise MembershipChanged(m)
        return m

    def wait_active(self, rank: int, *, timeout_s: float, poll_s: float = 0.05) -> Membership:
        """Block until ``rank`` is in the active set (rejoin handshake)."""
        deadline = time.monotonic() + timeout_s
        while True:
            m = self.view.read()
            if rank in m.active:
                return m
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {rank} never re-admitted (view: {m})"
                )
            time.sleep(poll_s)


class StragglerTracker:
    """Per-rank step-time EWMA; a rank is a straggler when its EWMA
    exceeds ``slack`` × the median EWMA of the *other* ranks.

    The leave-one-out median keeps a slow rank from shifting the
    baseline it is judged against (decisive at 2-3 ranks, where a
    fleet-wide median would absorb the outlier). Ranks with fewer than
    ``min_records`` observations are not judged (warmup/compile steps).
    """

    def __init__(self, slack: float = 2.0, alpha: float = 0.2, min_records: int = 3):
        self.slack = slack
        self.alpha = alpha
        self.min_records = min_records
        self._ewma: dict[int, float] = {}
        self._n: dict[int, int] = {}

    def record(self, rank: int, step_time_s: float) -> None:
        prev = self._ewma.get(rank)
        self._ewma[rank] = (
            step_time_s
            if prev is None
            else (1.0 - self.alpha) * prev + self.alpha * step_time_s
        )
        self._n[rank] = self._n.get(rank, 0) + 1

    def ewma(self, rank: int) -> float | None:
        return self._ewma.get(rank)

    def forget(self, rank: int) -> None:
        """Drop a rank's history (evicted ranks must not keep inflating
        the leave-one-out baseline the survivors are judged against)."""
        self._ewma.pop(rank, None)
        self._n.pop(rank, None)

    def stragglers(self) -> list[int]:
        judged = {
            r: t
            for r, t in self._ewma.items()
            if self._n.get(r, 0) >= self.min_records
        }
        if len(judged) < 2:
            return []  # a lone rank is its own baseline
        out = []
        for r, t in judged.items():
            # leave-one-out baseline: a slow rank must not shift the
            # median it is judged against (matters most at 2-3 ranks)
            others = [v for q, v in judged.items() if q != r]
            if t > self.slack * statistics.median(others):
                out.append(r)
        return sorted(out)


class StragglerEvicted(RuntimeError):
    """Abort signal: a persistently slow rank must be resharded around.

    Raised from inside a training attempt (by
    :class:`StragglerSupervisor`); :meth:`RestartPolicy.run` catches it,
    records the rank on its excluded-rank list, and restarts the attempt
    immediately — the attempt function re-reads
    ``RestartPolicy.excluded_ranks`` and builds its mesh/data split
    around the survivors.
    """

    def __init__(self, rank: int, ewma_s: float, baseline_s: float):
        super().__init__(
            f"rank {rank} straggling (EWMA {ewma_s:.3f}s vs baseline "
            f"{baseline_s:.3f}s) — evicting for reshard"
        )
        self.rank = rank
        self.ewma_s = ewma_s
        self.baseline_s = baseline_s


class StragglerSupervisor:
    """Detection → response: turns :class:`StragglerTracker` verdicts
    into :class:`StragglerEvicted` aborts.

    A rank is evicted only after it has been flagged on ``patience``
    *consecutive* checks (one transient slow step — GC, checkpoint
    flush, preemption notice — must not shrink the fleet), and never if
    it is already on the caller's excluded list.
    """

    def __init__(
        self, tracker: StragglerTracker | None = None, patience: int = 3
    ):
        self.tracker = tracker if tracker is not None else StragglerTracker()
        self.patience = patience
        self._streak: dict[int, int] = {}

    def record(self, rank: int, step_time_s: float) -> None:
        self.tracker.record(rank, step_time_s)

    def check(self, excluded: Sequence[int] = ()) -> None:
        """Raise :class:`StragglerEvicted` for the worst persistent
        straggler, if any. Call once per step after ``record``."""
        # Excluded ranks must not linger in the tracker: a stale slow
        # EWMA would inflate the median baseline and mask real
        # stragglers among the survivors.
        for r in excluded:
            self.tracker.forget(r)
            self._streak.pop(r, None)
        flagged = self.tracker.stragglers()
        for r in list(self._streak):
            if r not in flagged:
                self._streak.pop(r)
        worst: int | None = None
        for r in flagged:
            self._streak[r] = self._streak.get(r, 0) + 1
            if self._streak[r] >= self.patience:
                if worst is None or self.tracker.ewma(r) > self.tracker.ewma(worst):
                    worst = r
        if worst is not None:
            judged = {
                q: t for q, t in self.tracker._ewma.items() if q != worst
            }
            baseline = statistics.median(judged.values()) if judged else 0.0
            ewma = self.tracker.ewma(worst)
            self._streak.pop(worst, None)
            self.tracker.forget(worst)
            raise StragglerEvicted(worst, ewma, baseline)


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-restart supervisor with exponential backoff.

    ``run(attempt)`` calls ``attempt(attempt_idx)`` until it returns;
    on an exception it backs off and retries up to ``max_restarts``
    times, then re-raises. The driver's attempt function restores from
    the latest committed checkpoint, so each retry resumes rather than
    recomputes.

    Straggler response: a :class:`StragglerEvicted` raised from inside
    the attempt adds its rank to ``excluded_ranks`` and restarts
    *immediately* (no backoff — the fleet just shrank, there is nothing
    to wait out) without consuming a restart budget slot. The attempt
    function reads ``excluded_ranks`` on entry to reshard around the
    evicted ranks. Evictions are bounded by ``max_evictions`` (a fleet
    cannot shrink forever), and a rank that is already excluded cannot
    be evicted twice — either overrun degrades the signal to an
    ordinary bounded restart (backoff included), so ``run`` always
    terminates.

    Membership response: a :class:`MembershipChanged` raised from
    inside the attempt (the supervisor moved the fleet epoch — a rank
    died, or a recovered rank rejoined) also restarts immediately and
    budget-free, bounded by ``max_reshards``. The attempt function
    re-reads the published membership on entry. ``unexclude(rank)``
    re-admits a previously evicted straggler (the un-evict half of the
    rejoin protocol): the next attempt reshards *with* the rank again,
    and the rank becomes evictable afresh.
    """

    max_restarts: int = 3
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    max_evictions: int = 16
    max_reshards: int = 64
    excluded_ranks: list[int] = dataclasses.field(default_factory=list)

    def unexclude(self, rank: int) -> bool:
        """Re-admit an evicted rank (rejoin). Returns True if it was
        excluded. The rank regains a fresh eviction-budget slot: a
        recovered machine that degrades again must be evictable."""
        if rank in self.excluded_ranks:
            self.excluded_ranks.remove(rank)
            return True
        return False

    def run(
        self,
        attempt: Callable[[int], object],
        *,
        on_restart: Callable[[int, BaseException], None] | None = None,
        on_evict: Callable[[int, "StragglerEvicted"], None] | None = None,
        on_reshard: Callable[[Membership], None] | None = None,
    ):
        delay = self.backoff_s
        restarts = 0
        evictions = 0
        reshards = 0
        i = 0
        while True:
            try:
                return attempt(i)
            except MembershipChanged as e:
                if reshards >= self.max_reshards:
                    # a flapping fleet must not restart forever; degrade
                    # to the bounded-restart budget like eviction storms
                    if restarts >= self.max_restarts:
                        raise
                    if on_restart is not None:
                        on_restart(restarts, e)
                    time.sleep(delay)
                    delay *= self.backoff_mult
                    restarts += 1
                else:
                    reshards += 1
                    if on_reshard is not None:
                        on_reshard(e.membership)
            except StragglerEvicted as e:
                fresh = e.rank not in self.excluded_ranks
                if fresh:
                    self.excluded_ranks.append(e.rank)
                    if on_evict is not None:
                        on_evict(e.rank, e)
                if fresh and evictions < self.max_evictions:
                    evictions += 1
                else:
                    # double eviction (supervisor misuse) or an eviction
                    # storm: degrade to an ordinary bounded restart so
                    # the loop stays finite and backs off.
                    if restarts >= self.max_restarts:
                        raise
                    if on_restart is not None:
                        on_restart(restarts, e)
                    time.sleep(delay)
                    delay *= self.backoff_mult
                    restarts += 1
            except Exception as e:
                if restarts >= self.max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(restarts, e)
                time.sleep(delay)
                delay *= self.backoff_mult
                restarts += 1
            i += 1
