"""The port's multi-process fleet: real ranks as OS subprocesses on the CPU.

The twin of ``tests/test_multiprocess.py``'s fleet tests for
``repro_torch.launch.train``: every rank is its own process sharing a
tmpdir (heartbeats, membership epochs, per-rank sharded checkpoints).
Compute is replicated across ranks, so a fleet's loss trajectory equals
a single rank's bit for bit (every process runs one torch thread, so
the CPU's sums are the same in each):

* a 2-rank fleet's losses equal a single rank's, and it leaves a
  sharded checkpoint (a shard a rank, a manifest the leader committed);
* a single process resumes from that checkpoint (a reshaped fleet) and
  its losses equal the uninterrupted run's;
* a rank SIGKILLed mid-run is evicted, the survivors restart from the
  last committed step, the relaunched rank rejoins, and every rank's
  trajectory equals the uninterrupted run's. The test waits on
  conditions (losses logged, committed steps, membership epochs), each
  with a bound, never on a fixed sleep.

Each subprocess has its own timeout.
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from repro_torch.checkpoint import ckpt
from repro_torch.dist.fault import FleetSupervisor

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
HB_TIMEOUT_S = 3.0
RUN_TIMEOUT_S = 300  # a whole rank process, start to exit
WAIT_S = 120  # one awaited condition


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _cmd(coord, rank, *, steps, world, ckpt_dir=None, every=4, step_delay=0.0):
    return [
        sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
        "--arch", "qwen2.5-3b", "--reduced", "--use-pallas",
        "--steps", str(steps), "--seq-len", "16", "--global-batch", "2",
        "--steps-per-epoch", "4", "--log-every", "1",
        "--ckpt-dir", ckpt_dir or os.path.join(coord, "ckpt"), "--ckpt-every", str(every),
        "--coord-dir", coord, "--world-size", str(world), "--rank", str(rank),
        "--hb-interval", "0.2", "--hb-timeout", str(HB_TIMEOUT_S),
        "--commit-timeout", "60", "--rejoin-timeout", str(RUN_TIMEOUT_S),
        "--step-delay", str(step_delay),
    ]


def _spawn(cmd, log_path):
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, env=_env(), stdout=log, stderr=subprocess.STDOUT)


def _tail(log_path, n=3000):
    try:
        with open(log_path) as f:
            return f.read()[-n:]
    except OSError:
        return "<no log>"


def _run(cmd, log_path):
    proc = _spawn(cmd, log_path)
    try:
        rc = proc.wait(timeout=RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, _tail(log_path)


def _losses(coord, rank=0):
    """step -> loss from a rank's append-only log, the last occurrence
    of a replayed step winning."""
    out = {}
    path = os.path.join(coord, "loss", f"rank_{rank:05d}.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    out[rec["step"]] = rec["loss"]
    return out


def _membership(coord):
    try:
        with open(os.path.join(coord, "membership.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _wait_for(cond, what, procs=(), on_poll=None, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while not cond():
        for p in procs:
            assert p.poll() in (None, 0), f"a rank exited with {p.returncode} waiting for {what}"
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        if on_poll is not None:
            on_poll()
        time.sleep(0.05)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One rank, 12 steps, uninterrupted: the reference trajectory."""
    coord = str(tmp_path_factory.mktemp("single"))
    _run(_cmd(coord, 0, steps=12, world=1), os.path.join(coord, "log"))
    losses = _losses(coord)
    assert sorted(losses) == list(range(12))
    return losses


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two ranks, 8 steps, a sharded checkpoint every 4."""
    coord = str(tmp_path_factory.mktemp("fleet"))
    procs = [_spawn(_cmd(coord, r, steps=8, world=2), os.path.join(coord, f"log{r}"))
             for r in (0, 1)]
    try:
        for r, p in enumerate(procs):
            assert p.wait(timeout=RUN_TIMEOUT_S) == 0, _tail(os.path.join(coord, f"log{r}"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return coord


def test_fleet_losses_equal_a_single_rank(fleet, single):
    for r in (0, 1):
        assert _losses(fleet, r) == {s: single[s] for s in range(8)}, f"rank {r}"
        with open(os.path.join(fleet, "done", f"rank_{r:05d}.json")) as f:
            assert json.load(f) == {"rank": r, "final_loss": single[7], "steps": 8}
    ckpt_dir = os.path.join(fleet, "ckpt")
    assert ckpt.list_steps(ckpt_dir) == [4, 8]
    step_dir = os.path.join(ckpt_dir, "step_00000008")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded" and manifest["ranks"] == [0, 1]
    assert {p["shard"] for m in manifest["keys"].values() for p in m["pieces"]} == {0, 1}
    assert sorted(n for n in os.listdir(step_dir) if n.startswith("shard_")) == \
        ["shard_0.msgpack", "shard_1.msgpack"]


def test_single_rank_resumes_from_the_fleets_sharded_checkpoint(fleet, single, tmp_path):
    coord = str(tmp_path)
    log = os.path.join(coord, "log")
    _run(_cmd(coord, 0, steps=12, world=1, ckpt_dir=os.path.join(fleet, "ckpt")), log)
    assert "resumed from step 8" in _tail(log, 100000)
    assert _losses(coord) == {s: single[s] for s in range(8, 12)}


def test_chaos_kill_evict_rejoin_loss_parity(tmp_path):
    """SIGKILL a live rank mid-run: it is evicted, the survivors restart
    from the last committed step, the relaunched rank rejoins through the
    un-evict protocol, and every rank's trajectory equals an
    uninterrupted run's exactly."""
    steps, world, victim = 48, 3, 1
    ref = str(tmp_path / "ref")
    coord = str(tmp_path / "fleet")
    os.makedirs(ref)
    os.makedirs(coord)
    _run(_cmd(ref, 0, steps=steps, world=1), os.path.join(ref, "log"))
    ref_losses = _losses(ref)
    assert sorted(ref_losses) == list(range(steps))

    def log(r, again=False):
        return os.path.join(coord, f"rank{r}{'_re' if again else ''}.log")

    procs = {r: _spawn(_cmd(coord, r, steps=steps, world=world, step_delay=0.2), log(r))
             for r in range(world)}
    sup = FleetSupervisor(coord, world, timeout_s=HB_TIMEOUT_S)
    ckpt_dir = os.path.join(coord, "ckpt")
    try:
        # strike once the fleet is past a committed checkpoint
        _wait_for(lambda: len(_losses(coord, victim)) >= 6 and ckpt.list_steps(ckpt_dir),
                  "fleet progress past a committed checkpoint", procs.values())
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        live = [p for r, p in procs.items() if r != victim]
        _wait_for(lambda: victim in _membership(coord).get("evicted", []),
                  f"rank {victim} evicted", live, on_poll=sup.poll)
        evicted_at = _membership(coord)["epoch"]
        procs[victim] = _spawn(_cmd(coord, victim, steps=steps, world=world, step_delay=0.2),
                               log(victim, True))
        _wait_for(lambda: victim in _membership(coord).get("active", []),
                  f"rank {victim} re-admitted", procs.values(), on_poll=sup.poll)
        admitted = _membership(coord)
        for r, p in procs.items():
            assert p.wait(timeout=RUN_TIMEOUT_S) == 0, f"rank {r}: " + _tail(log(r, r == victim))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()

    assert admitted["epoch"] == evicted_at + 1 >= 2
    final = _membership(coord)
    assert sorted(final["active"]) == list(range(world)) and final["evicted"] == []
    assert "resumed from step" in _tail(log(victim, True), 100000)
    for r in range(world):
        assert _losses(coord, r) == ref_losses, f"rank {r} trajectory diverged"
        with open(os.path.join(coord, "done", f"rank_{r:05d}.json")) as f:
            assert json.load(f)["final_loss"] == ref_losses[steps - 1]
    last = ckpt.latest_step(ckpt_dir)
    step_dir = os.path.join(ckpt_dir, f"step_{last:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded"
    assert {p["shard"] for m in manifest["keys"].values() for p in m["pieces"]} == set(range(world))
