"""The port's fault tolerance and process group against the JAX package's.

``tests/test_dist.py``'s scenarios for the heartbeat, straggler,
membership, supervisor, restart-policy and process-group classes, each
test body run against both packages' classes (the fixture ``F``):
``repro.dist`` and its copy ``repro_torch.dist``, which must behave the
same.
"""
import types

import pytest

from repro.dist import compat as jcompat
from repro.dist import fault as jfault
from repro_torch.dist import compat as tcompat
from repro_torch.dist import fault as tfault


@pytest.fixture(params=["repro", "repro_torch"])
def F(request):
    """One package's fault classes, with its process group as ``compat``."""
    fault, compat = (jfault, jcompat) if request.param == "repro" else (tfault, tcompat)
    return types.SimpleNamespace(**{k: getattr(fault, k) for k in dir(fault)
                                    if not k.startswith("_")}, compat=compat)


def test_same_defaults_and_signatures():
    import inspect

    for name in ("Heartbeat", "HeartbeatMonitor", "FleetSupervisor", "StragglerTracker",
                 "StragglerSupervisor", "RestartPolicy", "MembershipView"):
        assert inspect.signature(getattr(jfault, name)) == inspect.signature(getattr(tfault, name))
    for name in ("ProcessGroup", "initialize", "registered_ranks"):
        assert inspect.signature(getattr(jcompat, name)) == inspect.signature(getattr(tcompat, name))
    for meth in ("poll", "should_poll", "check_epoch", "wait_active", "request_rejoin",
                 "completed_ranks"):
        assert inspect.signature(getattr(jfault.FleetSupervisor, meth)) == \
            inspect.signature(getattr(tfault.FleetSupervisor, meth))
    assert inspect.signature(jfault.RestartPolicy.run) == inspect.signature(tfault.RestartPolicy.run)


class TestHeartbeat:
    def test_empty_dir_no_dead_ranks(self, F, tmp_path):
        mon = F.HeartbeatMonitor(str(tmp_path), timeout_s=0.0)
        assert mon.dead_ranks() == []
        # a directory that doesn't exist yet is also fine
        mon = F.HeartbeatMonitor(str(tmp_path / "missing"), timeout_s=0.0)
        assert mon.dead_ranks() == []

    def test_single_rank_alive_then_dead(self, F, tmp_path):
        d = str(tmp_path)
        hb = F.Heartbeat(d, rank=0, interval_s=0.0)
        hb.beat(force=True)
        assert F.HeartbeatMonitor(d, timeout_s=3600.0).dead_ranks() == []
        assert F.HeartbeatMonitor(d, timeout_s=-1.0).dead_ranks() == [0]

    def test_interval_throttles_beats(self, F, tmp_path):
        hb = F.Heartbeat(str(tmp_path), rank=1, interval_s=3600.0)
        assert hb.beat() is True
        assert hb.beat() is False  # throttled
        assert hb.beat(force=True) is True

    def test_foreign_files_ignored(self, F, tmp_path):
        d = str(tmp_path)
        (tmp_path / "rank_notanumber").write_text("x")
        (tmp_path / "unrelated.txt").write_text("x")
        F.Heartbeat(d, rank=2, interval_s=0.0).beat(force=True)
        assert F.HeartbeatMonitor(d, timeout_s=-1.0).dead_ranks() == [2]


class TestStragglerTracker:
    def test_single_rank_never_straggles(self, F):
        t = F.StragglerTracker(slack=2.0)
        for _ in range(10):
            t.record(0, 100.0)
        assert t.stragglers() == []

    def test_warmup_records_not_judged(self, F):
        t = F.StragglerTracker(slack=2.0, min_records=3)
        t.record(0, 1.0)
        t.record(1, 50.0)
        assert t.stragglers() == []

    def test_slack_boundary(self, F):
        # EWMA exactly at slack x median is NOT a straggler; above is.
        t = F.StragglerTracker(slack=2.0, alpha=1.0, min_records=1)
        for r in (0, 1, 2):
            t.record(r, 1.0)
        t.record(3, 2.0)
        assert t.stragglers() == []  # 2.0 == 2.0 * median(1.0)
        t.record(3, 2.0 + 1e-6)
        assert t.stragglers() == [3]

    def test_two_rank_fleet_flags_the_slow_rank(self, F):
        # leave-one-out baseline: the slow rank must not shift the
        # median it is judged against
        t = F.StragglerTracker(slack=2.0, alpha=1.0, min_records=1)
        t.record(0, 1.0)
        t.record(1, 1000.0)
        assert t.stragglers() == [1]

    def test_recovered_rank_drops_off(self, F):
        t = F.StragglerTracker(slack=2.0, alpha=1.0, min_records=1)
        for r in range(4):
            t.record(r, 1.0)
        t.record(3, 10.0)
        assert t.stragglers() == [3]
        t.record(3, 1.0)  # alpha=1.0 -> instant recovery
        assert t.stragglers() == []


class TestStragglerEviction:
    """ROADMAP "Straggler response": detection wired to F.RestartPolicy
    through an excluded-rank list."""

    @staticmethod
    def _sup(F, patience=3):
        return F.StragglerSupervisor(
            F.StragglerTracker(slack=2.0, alpha=1.0, min_records=1),
            patience=patience,
        )

    def _feed(self, sup, slow_rank=3, slow=10.0, ranks=4):
        for r in range(ranks):
            sup.record(r, slow if r == slow_rank else 1.0)

    def test_patience_gates_eviction(self, F):
        sup = self._sup(F, patience=3)
        for _ in range(2):
            self._feed(sup)
            sup.check()  # streaks 1, 2: no eviction yet
        self._feed(sup)
        with pytest.raises(F.StragglerEvicted) as ei:
            sup.check()
        assert ei.value.rank == 3
        assert ei.value.ewma_s > ei.value.baseline_s

    def test_transient_slowness_resets_streak(self, F):
        sup = self._sup(F, patience=2)
        self._feed(sup)
        sup.check()
        self._feed(sup, slow=1.0)  # alpha=1.0: instant recovery
        sup.check()  # streak cleared
        self._feed(sup)
        sup.check()  # streak back to 1 — still no eviction
        self._feed(sup)
        with pytest.raises(F.StragglerEvicted):
            sup.check()

    def test_excluded_rank_never_re_evicted(self, F):
        sup = self._sup(F, patience=1)
        for _ in range(5):
            self._feed(sup)
            sup.check(excluded=[3])  # must not raise

    def test_restart_policy_records_rank_and_reshards(self, F):
        pol = F.RestartPolicy(max_restarts=0, backoff_s=0.0)
        seen = []

        def attempt(i):
            seen.append(tuple(pol.excluded_ranks))
            if not pol.excluded_ranks:
                raise F.StragglerEvicted(3, 10.0, 1.0)
            return "ok"

        evicted = []
        assert pol.run(attempt, on_evict=lambda r, e: evicted.append(r)) == "ok"
        assert pol.excluded_ranks == [3]
        assert evicted == [3]
        assert seen == [(), (3,)]  # second attempt saw the eviction

    def test_eviction_does_not_consume_restart_budget(self, F):
        pol = F.RestartPolicy(max_restarts=1, backoff_s=0.0)
        calls = []

        def attempt(i):
            calls.append(i)
            if len(calls) == 1:
                raise F.StragglerEvicted(1, 5.0, 1.0)
            if len(calls) == 2:
                raise RuntimeError("boom")
            return "ok"

        # one eviction + one crash still succeeds on a budget of 1
        assert pol.run(attempt) == "ok"
        assert len(calls) == 3

    def test_double_eviction_degrades_to_bounded_restart(self, F):
        pol = F.RestartPolicy(max_restarts=0, backoff_s=0.0)

        def attempt(i):
            raise F.StragglerEvicted(2, 9.0, 1.0)

        with pytest.raises(F.StragglerEvicted):
            pol.run(attempt)
        assert pol.excluded_ranks == [2]  # added once, then budget-bounded

    def test_evicted_rank_ewma_does_not_mask_survivors(self, F):
        # rank 2 evicted at EWMA 10.0; its stale entry must not inflate
        # the baseline rank 1 is judged against afterwards
        sup = self._sup(F, patience=1)
        sup.record(0, 1.0)
        sup.record(1, 1.0)
        sup.record(2, 10.0)
        with pytest.raises(F.StragglerEvicted) as ei:
            sup.check()
        assert ei.value.rank == 2
        sup.record(0, 1.0)
        sup.record(1, 3.9)  # straggler vs median 1.0 — but not vs 5.5
        with pytest.raises(F.StragglerEvicted) as ei:
            sup.check(excluded=[2])
        assert ei.value.rank == 1

    def test_eviction_storm_is_bounded(self, F):
        # never-repeating rank ids must not grant unlimited free restarts
        pol = F.RestartPolicy(max_restarts=0, backoff_s=0.0, max_evictions=3)
        seen = {"n": 0}

        def attempt(i):
            seen["n"] += 1
            raise F.StragglerEvicted(seen["n"], 9.0, 1.0)

        with pytest.raises(F.StragglerEvicted):
            pol.run(attempt)
        # 3 budgeted evictions + the one that degraded to a bounded restart
        assert len(pol.excluded_ranks) == 4

    def test_eviction_path_end_to_end(self, F):
        sup = self._sup(F, patience=2)
        pol = F.RestartPolicy(max_restarts=0, backoff_s=0.0)

        def attempt(i):
            ranks = [r for r in range(4) if r not in pol.excluded_ranks]
            for _ in range(3):
                for r in ranks:
                    sup.record(r, 10.0 if r == 2 else 1.0)
                sup.check(excluded=pol.excluded_ranks)
            return ranks

        assert pol.run(attempt) == [0, 1, 3]
        assert pol.excluded_ranks == [2]


class TestRestartPolicy:
    def test_retries_then_succeeds(self, F):
        calls = []

        def attempt(i):
            calls.append(i)
            if i < 2:
                raise RuntimeError("boom")
            return "ok"

        pol = F.RestartPolicy(max_restarts=3, backoff_s=0.0)
        restarts = []
        out = pol.run(attempt, on_restart=lambda i, e: restarts.append(i))
        assert out == "ok"
        assert calls == [0, 1, 2]
        assert restarts == [0, 1]

    def test_exhausted_restarts_reraise(self, F):
        pol = F.RestartPolicy(max_restarts=1, backoff_s=0.0)
        with pytest.raises(RuntimeError, match="always"):
            pol.run(lambda i: (_ for _ in ()).throw(RuntimeError("always")))


# ----------------------------------------------------------------------
# clock skew: heartbeat mtimes vs the monitor's wall clock
# ----------------------------------------------------------------------


class TestMonitorClockSkew:
    def test_skewed_monitor_clock_does_not_evict_live_ranks(
        self, F, tmp_path, monkeypatch
    ):
        """Regression: ``dead_ranks()`` used to compare file mtimes
        against the monitor host's ``time.time()``; a monitor running
        ahead of the file server's clock falsely evicted live ranks.
        The default ``now`` is a sentinel-file mtime from the SAME
        filesystem clock, so process-clock skew is invisible."""
        import time as _time

        hb = F.Heartbeat(str(tmp_path), rank=0, interval_s=0.0)
        hb.beat(force=True)
        mon = F.HeartbeatMonitor(str(tmp_path), timeout_s=5.0)

        real = _time.time
        monkeypatch.setattr(_time, "time", lambda: real() + 10_000.0)
        assert mon.dead_ranks() == []

    def test_skewed_monitor_clock_behind_still_detects_dead(
        self, F, tmp_path, monkeypatch
    ):
        """The converse skew (monitor clock behind the file server)
        must not mask a genuinely stale heartbeat."""
        import os as _os
        import time as _time

        hb = F.Heartbeat(str(tmp_path), rank=0, interval_s=0.0)
        hb.beat(force=True)
        # fake a rank that stopped beating 100s ago (skewed mtimes)
        past = _os.path.getmtime(hb.path) - 100.0
        _os.utime(hb.path, (past, past))
        mon = F.HeartbeatMonitor(str(tmp_path), timeout_s=5.0)

        real = _time.time
        monkeypatch.setattr(_time, "time", lambda: real() - 10_000.0)
        assert mon.dead_ranks() == [0]

    def test_explicit_now_overrides_sentinel(self, F, tmp_path):
        import os as _os

        hb = F.Heartbeat(str(tmp_path), rank=3, interval_s=0.0)
        hb.beat(force=True)
        mon = F.HeartbeatMonitor(str(tmp_path), timeout_s=5.0)
        mtime = _os.path.getmtime(hb.path)
        assert mon.dead_ranks(now=mtime + 1.0) == []
        assert mon.dead_ranks(now=mtime + 100.0) == [3]


class TestHeartbeatThread:
    def test_background_beater_keeps_beating_through_main_stall(
        self, F, tmp_path
    ):
        """The beater thread models a rank whose MAIN thread is stuck
        in a long XLA compile: the heartbeat must stay fresh anyway
        (process liveness, not step progress)."""
        import os as _os
        import time as _time

        hb = F.Heartbeat(str(tmp_path), rank=0, interval_s=0.05)
        t = F.HeartbeatThread(hb).start()
        try:
            first = _os.path.getmtime(hb.path)
            deadline = _time.monotonic() + 5.0
            while _os.path.getmtime(hb.path) <= first:
                assert _time.monotonic() < deadline, "beater never beat again"
                _time.sleep(0.05)  # the "stalled" main thread
        finally:
            t.stop()

    def test_stop_is_graceful_and_idempotent(self, F, tmp_path):
        hb = F.Heartbeat(str(tmp_path), rank=1, interval_s=0.05)
        t = F.HeartbeatThread(hb).start()
        t.stop()
        t.stop()
        assert not t._thread.is_alive()


# ----------------------------------------------------------------------
# membership epochs: evict / un-evict / leader failover
# ----------------------------------------------------------------------


class TestMembership:
    def test_evict_bumps_epoch_and_moves_rank(self, F):
        m = F.Membership(0, (0, 1, 2, 3), ())
        m2 = m.evict([2])
        assert (m2.epoch, m2.active, m2.evicted) == (1, (0, 1, 3), (2,))

    def test_evict_noop_for_inactive_rank_keeps_epoch(self, F):
        m = F.Membership(0, (0, 1), (2,))
        assert m.evict([2]) is m
        assert m.evict([7]) is m

    def test_unevict_restores_rank_and_bumps_epoch(self, F):
        m = F.Membership(1, (0, 1, 3), (2,))
        m2 = m.unevict([2])
        assert (m2.epoch, m2.active, m2.evicted) == (2, (0, 1, 2, 3), ())

    def test_leader_fails_over_deterministically(self, F):
        m = F.Membership(0, (0, 1, 2), ())
        assert m.leader == 0
        assert m.evict([0]).leader == 1
        assert m.evict([0, 1]).leader == 2
        assert m.evict([0, 1, 2]).leader == -1

    def test_view_roundtrip_and_initial(self, F, tmp_path):
        view = F.MembershipView(str(tmp_path), 4)
        assert view.read() == view.initial() == F.Membership(0, (0, 1, 2, 3), ())
        m = view.initial().evict([1])
        view.write(m)
        assert view.read() == m


class TestFleetSupervisor:
    def _beat_all(self, F, coord, ranks):
        for r in ranks:
            F.Heartbeat(str(coord / "hb"), rank=r, interval_s=0.0).beat(force=True)

    def _stale(self, coord, rank, ago=100.0):
        import os as _os

        path = str(coord / "hb" / f"rank_{rank:05d}")
        past = _os.path.getmtime(path) - ago
        _os.utime(path, (past, past))

    def test_poll_evicts_stale_rank(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(3))
        sup = F.FleetSupervisor(str(tmp_path), 3, timeout_s=5.0)
        self._stale(tmp_path, 2)
        m = sup.poll()
        assert (m.epoch, m.active, m.evicted) == (1, (0, 1), (2,))

    def test_poll_evicts_rank_that_never_beat(self, F, tmp_path):
        self._beat_all(F, tmp_path, [0, 2])
        sup = F.FleetSupervisor(str(tmp_path), 3, timeout_s=5.0)
        m = sup.poll()
        assert m.evicted == (1,)

    def test_rejoin_needs_request_and_fresh_beat(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(2))
        sup = F.FleetSupervisor(str(tmp_path), 2, timeout_s=5.0)
        self._stale(tmp_path, 1)
        assert sup.poll().evicted == (1,)

        # a rejoin request alone (beat still stale) is not enough: a
        # stale request file from a rank that died again must not flap
        sup.request_rejoin(1)
        assert sup.poll().evicted == (1,)

        # fresh beat + request ⇒ un-evicted, epoch bumped again
        self._beat_all(F, tmp_path, [1])
        m = sup.poll()
        assert (m.epoch, m.active, m.evicted) == (2, (0, 1), ())
        # the request was consumed: the next poll is a no-op
        assert sup.poll().epoch == 2

    def test_completed_rank_is_never_evicted(self, F, tmp_path):
        """Orderly leave: a rank that wrote its done marker stops
        heartbeating on purpose — silence is completion, not death."""
        self._beat_all(F, tmp_path, range(2))
        (tmp_path / "done").mkdir()
        (tmp_path / "done" / "rank_00001.json").write_text("{}")
        sup = F.FleetSupervisor(str(tmp_path), 2, timeout_s=5.0)
        self._stale(tmp_path, 1)
        m = sup.poll()
        assert (m.epoch, m.active, m.evicted) == (0, (0, 1), ())
        assert sup.completed_ranks() == [1]

    def test_check_epoch_raises_on_drift(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(2))
        sup = F.FleetSupervisor(str(tmp_path), 2, timeout_s=5.0)
        assert sup.check_epoch(0).epoch == 0
        self._stale(tmp_path, 1)
        sup.poll()
        with pytest.raises(F.MembershipChanged) as exc:
            sup.check_epoch(0)
        assert exc.value.membership.epoch == 1

    def test_should_poll_leader_and_failover(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(3))
        sup = F.FleetSupervisor(str(tmp_path), 3, timeout_s=5.0)
        assert sup.should_poll(0)
        assert not sup.should_poll(1)
        assert not sup.should_poll(2)
        # leader heartbeat goes stale: the NEXT rank inherits the seat
        # (exactly one standby — rank 2 still defers)
        self._stale(tmp_path, 0)
        assert sup.should_poll(1)
        assert not sup.should_poll(2)

    def test_should_poll_skips_completed_leader(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(3))
        (tmp_path / "done").mkdir()
        (tmp_path / "done" / "rank_00000.json").write_text("{}")
        sup = F.FleetSupervisor(str(tmp_path), 3, timeout_s=5.0)
        # rank 0 finished: the lowest still-running rank is the leader
        assert not sup.should_poll(0)
        assert sup.should_poll(1)
        assert not sup.should_poll(2)

    def test_wait_active_times_out_with_actionable_error(self, F, tmp_path):
        self._beat_all(F, tmp_path, range(2))
        sup = F.FleetSupervisor(str(tmp_path), 2, timeout_s=5.0)
        self._stale(tmp_path, 1)
        sup.poll()
        with pytest.raises(TimeoutError, match="rank 1 never re-admitted"):
            sup.wait_active(1, timeout_s=0.1)


class TestRestartPolicyUnexclude:
    def test_unexclude_readmits_and_reports(self, F):
        p = F.RestartPolicy(max_restarts=0)
        p.excluded_ranks.append(3)
        assert p.unexclude(3) is True
        assert p.excluded_ranks == []
        assert p.unexclude(3) is False

    def test_unexcluded_rank_is_evictable_afresh(self, F):
        """The rejoin half of the protocol: after unexclude, a repeat
        eviction of the same rank must again restart budget-free."""
        p = F.RestartPolicy(max_restarts=0, backoff_s=0.0)
        calls = []

        def attempt(i):
            calls.append(i)
            if len(calls) == 1:
                raise F.StragglerEvicted(3, 1.0, 0.1)
            if len(calls) == 2:
                p.unexclude(3)
                raise F.StragglerEvicted(3, 1.0, 0.1)
            return "ok"

        assert p.run(attempt) == "ok"
        assert len(calls) == 3


# ----------------------------------------------------------------------
# ProcessGroup: filesystem-backed control-plane collectives
# ----------------------------------------------------------------------


class TestProcessGroup:
    def _group(self, F, tmp_path, world=2, **kw):
        return [
            F.compat.ProcessGroup(str(tmp_path), r, world, **kw)
            for r in range(world)
        ]

    def test_put_get_roundtrip(self, F, tmp_path):
        a, b = self._group(F, tmp_path)
        a.put("x.0", {"v": 1})
        assert b.get("x.0", 0, timeout_s=1.0) == {"v": 1}
        assert b.try_get("x.0", 1) is None

    def test_gather_returns_every_participant(self, F, tmp_path):
        a, b = self._group(F, tmp_path)
        a.put("g.0", "from0")
        got = b.gather("g.0", "from1", timeout_s=1.0)
        assert got == {0: "from0", 1: "from1"}

    def test_collectives_among_survivor_subset(self, F, tmp_path):
        """After an eviction the survivors pass ``ranks=`` and never
        wait on the dead rank."""
        pgs = self._group(F, tmp_path, world=3)
        pgs[0].put("s.0", 0)
        got = pgs[2].gather("s.0", 2, ranks=[0, 2], timeout_s=1.0)
        assert got == {0: 0, 2: 2}
        pgs[0].put("bar.b.0", None)
        pgs[2].barrier("b.0", ranks=[0, 2], timeout_s=1.0)

    def test_broadcast_from_src(self, F, tmp_path):
        a, b = self._group(F, tmp_path)
        a.broadcast("cfg.0", {"seed": 7})
        assert b.broadcast("cfg.0", src=0, timeout_s=1.0) == {"seed": 7}

    def test_missing_peer_times_out_not_hangs(self, F, tmp_path):
        (a,) = self._group(F, tmp_path, world=1)
        pg = F.compat.ProcessGroup(str(tmp_path), 0, 2)
        with pytest.raises(F.compat.ProcessGroupTimeout, match="rank 1"):
            pg.get("never.0", 1, timeout_s=0.05)

    def test_rank_outside_world_rejected(self, F, tmp_path):
        with pytest.raises(ValueError, match="outside world"):
            F.compat.ProcessGroup(str(tmp_path), 5, 2)

    def test_initialize_registers_and_unblocks(self, F, tmp_path):
        """initialize blocks until every peer registers, so the two
        ranks must initialize concurrently (as real processes would)."""
        import threading

        d = str(tmp_path)
        pgs = {}

        def init(r):
            pgs[r] = F.compat.initialize(
                d, process_id=r, num_processes=2, timeout_s=10.0
            )

        threads = [threading.Thread(target=init, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15.0)
        assert sorted(pgs) == [0, 1]
        assert F.compat.registered_ranks(d) == [0, 1]
        pgs[0].put("hello.0", "hi")
        assert pgs[1].get("hello.0", 0, timeout_s=1.0) == "hi"

    def test_initialize_times_out_on_missing_peer(self, F, tmp_path):
        with pytest.raises(
            F.compat.ProcessGroupTimeout, match="never registered"
        ):
            F.compat.initialize(
                str(tmp_path), process_id=0, num_processes=2, timeout_s=0.1
            )
