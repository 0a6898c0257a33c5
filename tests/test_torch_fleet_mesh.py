"""A fleet whose ranks each train on a device mesh, on the CPU.

Every fleet rank is one launcher (``python -m repro_torch.launch.train
--coord-dir C --world-size 2 --rank r --data-mesh 1 --model-mesh 2``) as
an OS subprocess, which spawns its two mesh ranks over gloo; one torch
thread a process, reduced qwen2.5-3b in fp32, S=16, B=2, ``--use-pallas``.
Compute is replicated across fleet ranks (each mesh steps the full global
batch), so:

* (a) both fleet ranks' losses are equal bit for bit, and equal a
  world-1 run on a 1x2 mesh bit for bit; they match the JAX package's
  one-device ``repro.launch.train.run`` on the same command line within
  1e-5 relative, after the first sparse step's kept sets (compared first)
  are equal. Every run starts from one step-0 checkpoint of the JAX init;
* (b) the committed checkpoint is the fleet's format: ``ranks == [0, 1]``,
  ``shard_0`` and ``shard_1`` alone, every key's pieces the JAX package's
  ``make_shard_plan`` over the active fleet ranks, read by its ``restore``
  into the world-1 run's gathered params exactly;
* (c) a world-1 run on a 2x1 mesh resumes from that checkpoint, within
  1e-5 of the uninterrupted run;
* (d) a fleet rank's launcher SIGKILLed after a committed checkpoint
  leaves none of its mesh ranks (their pids under ``C/pids``) alive within
  ``--hb-timeout`` + 10 s; the survivor evicts it and restarts from the
  committed step, the relaunched rank rejoins, and every rank's
  trajectory (the last occurrence of each step) equals the uninterrupted
  run's exactly;
* (e) a membership change that mesh rank 0 sees at step k makes every
  mesh rank raise ``MembershipChanged`` at step k, and the restart runs
  on all of them (``train.lead_verdict``); an error one rank sees reaches
  the others (``parallel.raise_any``); bounded by a timeout.

Besides: a launcher SIGKILLed while its mesh ranks ignore SIGINT takes
them with it; the parts of each fleet piece that mesh rank 0 gathers
(``sharding.block_sources``) fill it once, each from its lowest holder;
a fleet on a mesh asked for the card without one raises.

The test waits on conditions, each with a bound, never on a fixed sleep;
every subprocess has its own timeout.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jax_get_config
from repro.core import policy as jpolicy
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import model as jlm
from repro_torch.checkpoint import ckpt
from repro_torch.dist.fault import FleetSupervisor
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain

ARCH = "qwen2.5-3b"
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
B, S, STEPS, EVERY, EPOCH = 2, 16, 8, 4, 4  # steps 4-7 sparse
CHAOS_STEPS = 24
TOL = 1e-5
HB_TIMEOUT_S = 3.0
RUN_TIMEOUT_S = 240  # a whole launcher, start to exit
WAIT_S = 120  # one awaited condition
# the command line both packages' CLIs take
COMMON = ["--arch", ARCH, "--reduced", "--seq-len", str(S), "--global-batch", str(B),
          "--steps-per-epoch", str(EPOCH), "--log-every", "1", "--ckpt-every", str(EVERY)]


def _port_argv(ckpt_dir, steps=STEPS, mesh=(1, 2), *extra):
    return ["--device", "cpu", "--use-pallas", *COMMON, "--steps", str(steps), "--ckpt-dir",
            ckpt_dir, "--data-mesh", str(mesh[0]), "--model-mesh", str(mesh[1]), *extra]


def _fleet_argv(coord, ckpt_dir, rank, steps=STEPS, step_delay=0.0):
    return _port_argv(ckpt_dir, steps, (1, 2), "--coord-dir", coord, "--world-size", "2",
                      "--rank", str(rank), "--hb-interval", "0.2", "--hb-timeout",
                      str(HB_TIMEOUT_S), "--commit-timeout", "60", "--rejoin-timeout",
                      str(RUN_TIMEOUT_S), "--step-delay", str(step_delay))


def _spawn(argv, log_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                                env=env, stdout=log, stderr=subprocess.STDOUT)


def _tail(log_path, n=3000):
    try:
        with open(log_path) as f:
            return f.read()[-n:]
    except OSError:
        return "<no log>"


def _finish(procs, logs):
    try:
        for name, p in procs.items():
            assert p.wait(timeout=RUN_TIMEOUT_S) == 0, f"{name}: " + _tail(logs[name])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def _losses(coord, rank):
    """step -> loss from a fleet rank's log, the last occurrence winning."""
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
            assert p.poll() in (None, 0), f"a launcher exited with {p.returncode} ({what})"
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        if on_poll is not None:
            on_poll()
        time.sleep(0.05)


def _alive(pid):
    """Whether ``pid`` runs (a zombie, dead but not yet reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


def _copy_init(init_dir, tmp_path_factory, name, *, drop=()):
    d = str(tmp_path_factory.mktemp(name))
    shutil.copytree(init_dir, d, dirs_exist_ok=True,
                    ignore=lambda _, names: [n for n in names if n in drop])
    return d


def _named_jax(tree, n_layers):
    """``name -> array`` in the port's ``train.named_params`` naming."""
    out = {}

    def walk(node, prefix, li=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/", li)
        else:
            a = np.asarray(node)
            out[prefix[:-1]] = a if li is None else a[li]

    walk({k: v for k, v in tree.items() if k != "stack"}, "")
    for li in range(n_layers):
        walk(tree["stack"]["slots"][0], f"layer_{li}/", li)
    return out


@pytest.fixture(scope="module")
def jcfg():
    return jax_get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def init(jcfg, tmp_path_factory):
    """The JAX init (numpy) and a step-0 checkpoint of it with zero
    moments, the state every run of (a)-(c) resumes from."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    d = str(tmp_path_factory.mktemp("init"))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    jckpt.save(d, 0, {"params": tree, "m": zeros, "v": zeros})
    return tree, d


@pytest.fixture(scope="module")
def solo(init, tmp_path_factory):
    """The world-1 run on a 1x2 mesh: losses, kept channels, final params."""
    d = _copy_init(init[1], tmp_path_factory, "solo")
    args = ttrain.build_parser().parse_args(_port_argv(d))
    return ttrain.run(args, collect=("kept", "params"), timeout_s=RUN_TIMEOUT_S)


@pytest.fixture(scope="module")
def fleet(init, tmp_path_factory):
    """Two launchers, each on a 1x2 mesh: the coord dir (losses, done
    markers, pids; the checkpoints under ``ckpt``)."""
    coord = str(tmp_path_factory.mktemp("fleet"))
    ckpt_dir = _copy_init(init[1], tmp_path_factory, "fleet_ckpt")
    logs = {r: os.path.join(coord, f"log{r}") for r in (0, 1)}
    procs = {r: _spawn(_fleet_argv(coord, ckpt_dir, r), logs[r]) for r in (0, 1)}
    _finish(procs, logs)
    return coord, ckpt_dir


@pytest.fixture(scope="module")
def jax_run(jcfg, init, tmp_path_factory):
    """The JAX CLI on the same command line from the same step-0
    checkpoint: its losses, and the kept channels of its first sparse step
    (the nonzero columns of each site's dW at step 4, from its checkpoint
    of step 4)."""
    tree, init_dir = init
    d = _copy_init(init_dir, tmp_path_factory, "jax")
    jargs = jtrain.build_parser().parse_args([*COMMON, "--steps", str(STEPS), "--ckpt-dir", d])
    history = jtrain.run(jargs)["history"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    params = jckpt.restore(d, EPOCH, {"params": tree, "m": zeros, "v": zeros})["params"]
    sites, depth = jlm.site_names(jcfg)
    table = jtrain.build_program(jargs, jpolicy.paper_default(0.8)).resolve(
        sites, depth=depth).policies_for_step(EPOCH)
    pipe = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(jcfg.vocab, S, B, seed=0))
    batch = jax.tree.map(jnp.asarray, pipe.batch_at(EPOCH))
    grads = jax.grad(lambda p: jlm.loss_fn(jcfg, p, batch, table)[0])(
        jax.tree.map(jnp.asarray, params))
    named = _named_jax(grads, jcfg.n_layers)
    kept = {s: np.flatnonzero(np.abs(named[f"{s}/w"]).sum(0)).tolist() for s in sites}
    return history, kept


def test_fleet_losses_equal_one_mesh_and_the_jax_package(fleet, solo, jax_run):
    coord, _ = fleet
    assert solo["steps"] == list(range(STEPS))
    assert [r > 0 for r in solo["rates"]] == [False] * 4 + [True] * 4
    history, kept = jax_run
    assert sorted(solo["kept"][EPOCH]) == sorted(kept)
    for site, cols in kept.items():
        assert solo["kept"][EPOCH][site] == cols, site
    want = dict(enumerate(solo["history"]))
    for r in (0, 1):
        assert _losses(coord, r) == want, f"fleet rank {r}"
        with open(os.path.join(coord, "done", f"rank_{r:05d}.json")) as f:
            assert json.load(f) == {"rank": r, "final_loss": want[STEPS - 1], "steps": STEPS}
    for a, b in zip(solo["history"], history, strict=True):
        assert abs(a - b) <= TOL * abs(b), (solo["history"], history)
    # a process a mesh rank, each its pid under the coord dir
    assert sorted(os.listdir(os.path.join(coord, "pids"))) == [
        f"rank_{r:05d}_mesh_{m}" for r in (0, 1) for m in (0, 1)]


def test_the_fleets_checkpoint_is_the_jax_fleets_format(fleet, solo, jcfg, init):
    _, ckpt_dir = fleet
    assert ckpt.list_steps(ckpt_dir) == [0, EPOCH, STEPS]
    step_dir = os.path.join(ckpt_dir, f"step_{STEPS:08d}")
    assert sorted(os.listdir(step_dir)) == ["COMMITTED", "manifest.json", "shard_0.msgpack",
                                            "shard_1.msgpack"]
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded" and manifest["ranks"] == [0, 1]
    items = [(k, jax.ShapeDtypeStruct(tuple(m["shape"]), np.float32))
             for k, m in manifest["keys"].items()]
    plan = jckpt.make_shard_plan(items, [0, 1])
    for key, meta in manifest["keys"].items():
        assert meta["pieces"] == [{"shard": p.shard, "index": [list(se) for se in p.index]}
                                  for p in plan[key]], key
    tree, _ = init
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    state = jckpt.restore(ckpt_dir, STEPS, {"params": tree, "m": zeros, "v": zeros})
    named = _named_jax(jax.tree.map(np.asarray, state["params"]), jcfg.n_layers)
    assert sorted(named) == sorted(solo["params"])
    for name, p in solo["params"].items():
        np.testing.assert_array_equal(p.numpy(), named[name], err_msg=name)


def test_a_reshaped_mesh_resumes_from_the_fleets_checkpoint(fleet, solo, tmp_path_factory):
    """A world-1 run on 2x1 resumes from the fleet's step-4 checkpoint
    (its step 8 left out of the copy) and trains steps 4-7."""
    _, ckpt_dir = fleet
    d = _copy_init(ckpt_dir, tmp_path_factory, "reshaped", drop=(f"step_{STEPS:08d}",))
    args = ttrain.build_parser().parse_args(_port_argv(d, STEPS, (2, 1)))
    out = ttrain.run(args, timeout_s=RUN_TIMEOUT_S)
    assert [r["step"] for r in out["ckpt"]["restores"]] == [EPOCH]
    assert out["steps"] == list(range(EPOCH, STEPS))
    for a, b in zip(out["history"], solo["history"][EPOCH:], strict=True):
        assert abs(a - b) <= TOL * abs(b), (out["history"], solo["history"])


def test_chaos_kill_a_launcher_evict_rejoin(tmp_path):
    """SIGKILL fleet rank 1's launcher once step 4 is committed: its mesh
    ranks end with it, rank 0 evicts it and restarts from the committed
    step, the relaunched launcher rejoins, and both trajectories equal an
    uninterrupted world-1 run's on the same mesh exactly."""
    victim = 1
    ref = ttrain.run(ttrain.build_parser().parse_args(
        _port_argv(str(tmp_path / "ref"), CHAOS_STEPS)), timeout_s=RUN_TIMEOUT_S)
    ref_losses = dict(enumerate(ref["history"]))
    coord = str(tmp_path / "fleet")
    ckpt_dir = os.path.join(coord, "ckpt")
    os.makedirs(coord)

    def log(r, again=False):
        return os.path.join(coord, f"rank{r}{'_re' if again else ''}.log")

    def launch(r, again=False):
        return _spawn(_fleet_argv(coord, ckpt_dir, r, CHAOS_STEPS, step_delay=0.3),
                      log(r, again))

    procs = {r: launch(r) for r in (0, 1)}
    sup = FleetSupervisor(coord, 2, timeout_s=HB_TIMEOUT_S)
    try:
        _wait_for(lambda: len(_losses(coord, victim)) >= 6 and ckpt.list_steps(ckpt_dir),
                  "fleet progress past a committed checkpoint", procs.values())
        pids = []
        for m in (0, 1):
            with open(os.path.join(coord, "pids", f"rank_{victim:05d}_mesh_{m}")) as f:
                pids.append(int(f.read()))
        assert all(_alive(p) for p in pids)
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        live = [procs[0]]
        _wait_for(lambda: not any(_alive(p) for p in pids), f"mesh ranks {pids} gone", live,
                  timeout_s=HB_TIMEOUT_S + 10)
        _wait_for(lambda: victim in _membership(coord).get("evicted", []),
                  f"rank {victim} evicted", live, on_poll=sup.poll)
        evicted_at = _membership(coord)["epoch"]
        procs[victim] = launch(victim, again=True)
        _wait_for(lambda: victim in _membership(coord).get("active", []),
                  f"rank {victim} re-admitted", procs.values(), on_poll=sup.poll)
        admitted = _membership(coord)
        _finish(procs, {0: log(0), victim: log(victim, True)})
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()

    assert admitted["epoch"] == evicted_at + 1 >= 2
    final = _membership(coord)
    assert final["active"] == [0, 1] and final["evicted"] == []
    assert "resumed from step" in _tail(log(0), 200000)  # the survivor's restart
    assert "resumed from step" in _tail(log(victim, True), 200000)
    for r in (0, 1):
        assert _losses(coord, r) == ref_losses, f"fleet rank {r} trajectory diverged"
        with open(os.path.join(coord, "done", f"rank_{r:05d}.json")) as f:
            assert json.load(f)["final_loss"] == ref_losses[CHAOS_STEPS - 1]
    with open(os.path.join(ckpt_dir, f"step_{CHAOS_STEPS:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["ranks"] == [0, 1]


_LINGER = """
import sys
sys.path.insert(0, {tests!r})
import torch_mesh_ranks
from repro_torch.launch.mesh import run_on_mesh
run_on_mesh(torch_mesh_ranks.linger, 1, 2, "cpu", {pid_dir!r})
"""


def test_a_mesh_rank_ends_with_its_launcher(tmp_path):
    """A launcher SIGKILLed while its mesh ranks ignore SIGINT (the signal
    torch's spawn asks for on a parent's death, which a rank blocked in a
    collective does not act on): the ranks end all the same."""
    pid_dir = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = _LINGER.format(tests=os.path.dirname(os.path.abspath(__file__)), pid_dir=pid_dir)
    launcher = subprocess.Popen([sys.executable, "-c", code], env=env)
    pids = []
    try:
        names = ("mesh_0", "mesh_1")
        _wait_for(lambda: all(os.path.exists(os.path.join(pid_dir, n)) for n in names),
                  "the mesh ranks' pids", [launcher])
        for n in names:
            with open(os.path.join(pid_dir, n)) as f:
                pids.append(int(f.read()))
        launcher.send_signal(signal.SIGKILL)
        launcher.wait(timeout=30)
        _wait_for(lambda: not any(_alive(p) for p in pids), f"mesh ranks {pids} gone",
                  timeout_s=10)
    finally:
        if launcher.poll() is None:
            launcher.kill()
        for p in pids:
            if _alive(p):
                os.kill(p, signal.SIGKILL)


def test_a_membership_change_aborts_every_mesh_rank_at_one_step(tmp_path):
    at = 2
    every = tmesh.run_on_mesh(ranks.fleet_abort, 1, 2, "cpu", str(tmp_path), at, timeout_s=120)
    for raised, finished, _ in every:
        assert raised == [(at, 1)] and finished == 1
    # an error one rank sees: its own there, a RuntimeError on the others
    assert [e for _, _, e in every] == [["TimeoutError", "RuntimeError"],
                                        ["RuntimeError", "KeyError"]]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_sources_cover_each_fleet_piece_once(shape):
    """The parts of each fleet piece that mesh rank 0 gathers: every part in
    its rank's own block, the parts disjoint and filling the piece, each
    read from the lowest rank holding it (reduced qwen2.5-3b's params, m
    and v in the JAX layout, the fleet plan over 2 and 3 fleet ranks)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as tlm

    cfg = get_config(ARCH).reduced()
    mesh_shape = {"data": shape[0], "model": shape[1]}
    params = tlm.init_params(cfg, 0, device="cpu")
    tree = {k: tlm.jax_layout(cfg, params, ckpt.Stacked) for k in ("params", "m", "v")}
    items = ckpt.leaf_items(ckpt.like_of(tree))
    specs = [shd.fit_spec(sp, t.shape, mesh_shape) for sp, (_, t) in zip(
        ttrain._spec_leaves(shd.param_specs(tlm.jax_layout(cfg, params, tlm.StackShape))) * 3,
        items, strict=True)]
    world = shape[0] * shape[1]
    for ranks_ in ([0, 1], [0, 1, 2]):
        plan = ckpt.make_shard_plan(items, ranks_)
        for (key, leaf), spec in zip(items, specs, strict=True):
            blocks = {r: shd.local_index(spec, leaf.shape, tmesh.shape_mesh(mesh_shape, r))
                      for r in range(world)}
            for p in plan[key]:
                covered = np.zeros([e - s for s, e in p.index], dtype=np.int64)
                for r, box, origin in shd.block_sources(spec, leaf.shape, mesh_shape, p.index):
                    blk = blocks[r]
                    assert origin == tuple(sl.start or 0 for sl in blk), (key, r)
                    for (a, b), sl, d in zip(box, blk, leaf.shape, strict=True):
                        assert (sl.start or 0) <= a < b <= (d if sl.stop is None else sl.stop)
                    assert all(blocks[q] != blk for q in range(r)), (key, r)  # lowest holder
                    covered[tuple(slice(a - s, b - s) for (a, b), (s, _) in
                                  zip(box, p.index, strict=True))] += 1
                assert (covered == 1).all(), (key, p)


def test_a_fleet_on_a_mesh_wants_a_card_with_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = ttrain.build_parser().parse_args(
        [*COMMON, "--steps", "2", "--device", "cuda", "--coord-dir", str(tmp_path),
         "--world-size", "2", "--model-mesh", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(args)
