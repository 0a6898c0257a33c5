"""The port's mesh training against the JAX package's one-device step.

Reduced qwen2.5-3b in fp32. The JAX package makes the params (seed 0);
they reach the port's CLI as a step-0 checkpoint in ``--ckpt-dir`` (the
JAX package's format), which every run resumes from. The mesh shapes of
each size (1x2 and 2x1; 2x2 and 1x4) share one spawn of gloo ranks (one
torch thread a rank, a 120-s timeout) that runs all of those shapes'
cases through the training CLI's rank body (``train.run_rank``):

* 3 steps (dense, then two sparse: ``--scheduler bar``) at
  ``paper_default(0.8)`` and at ``tpu_default(0.8)``, both with
  ``--use-pallas``: the losses and every final param within 1e-5 of the
  JAX package's one-device steps, and the kept channels of every sparse
  step equal to the JAX step's at every site. 1x4 puts half a KV head on
  a rank: k/v are gathered on use. The learning rate is 5e-5: Adam moves
  an element about lr whatever its gradient, so where a gradient is
  rounding noise the last-bit differences move it by a share of lr, and
  the param differences scale with lr (measured at 1e-4: the one-device
  port 6.3e-6 from the JAX step, 1x4 1.09e-5; at 5e-5 half of each);
* at 1x2, ``tp_shards`` = 2 through ``make_train_step``: each rank's own
  top-k of its shard, on the kernel route (``kops.matmul`` called as the
  launch table says), against the JAX step's balanced selection;
* at 1x2, a crash at step 2 and a resume from the mesh's own sharded
  checkpoint, equal to the uninterrupted run bit for bit, and that
  checkpoint read by the JAX package's ``restore`` equal to the gathered
  params;
* at 2x2, the JAX CLI's own command line (``--reduced --steps 3
  --steps-per-epoch 1 --global-batch 4 --seq-len 16``) against the JAX
  CLI under ``--data-mesh 2 --model-mesh 2`` on 4 host devices, in a
  subprocess.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jax_get_config
from repro.core import policy as jpolicy
from repro.core import schedulers as jsched
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro.optim import adam as jadam
from repro_torch.launch import mesh as tmesh

ARCH = "qwen2.5-3b"
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
B, S, LR, STEPS = 4, 16, 5e-5, 3
TOL = 1e-5
TIMEOUT_S = 120
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
POLICIES = {"paper": ("channel", jpolicy.paper_default(0.8)),
            "tpu": ("block", jpolicy.tpu_default(0.8))}


def _argv(ckpt_dir, granularity, shape, *extra):
    return ["--device", "cpu", "--reduced", "--steps", str(STEPS), "--scheduler", "bar",
            "--global-batch", str(B), "--seq-len", str(S), "--lr", str(LR),
            "--granularity", granularity, "--use-pallas", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "100", "--log-every", "100", "--data-mesh", str(shape[0]),
            "--model-mesh", str(shape[1]), *extra]


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
    """The JAX init (numpy tree) and a step-0 checkpoint of it with zero
    moments, the state every port run resumes from."""
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    d = str(tmp_path_factory.mktemp("init"))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    jckpt.save(d, 0, {"params": tree, "m": zeros, "v": zeros})
    return tree, d


def _jax_run(jcfg, tree, pol):
    """The JAX package's one-device steps (dense, then two at ``pol``),
    as the port's CLI schedules them (``bar`` over 3 steps): the losses,
    the kept channels of each sparse step (the nonzero columns of that
    step's dW at every site) and the final params."""
    sites, depth = jlm.site_names(jcfg)
    program = jpolicy.PolicyProgram(jpolicy.PolicyRules.single(pol), jsched.make_schedule(
        "bar", target=0.8, total_steps=STEPS)).resolve(sites, depth=depth)
    ocfg = jadam.AdamConfig(lr=LR, clip_norm=1.0, total_steps=STEPS)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jadam.init(params)
    pipe = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(jcfg.vocab, S, B, seed=0))
    losses, kept, jitted = [], {}, {}  # one compile for each rate's (grad, step)
    for step in range(STEPS):
        rate = program.schedule.rate(step)
        if rate not in jitted:
            table = program.policies_for_step(step)
            jitted[rate] = (jax.jit(jax.grad(lambda p, b, table=table: jlm.loss_fn(
                jcfg, p, b, table)[0])), jax.jit(jsteps.make_train_step(jcfg, table, ocfg)))
        grad, train_step = jitted[rate]
        batch = jax.tree.map(jnp.asarray, pipe.batch_at(step))
        if rate > 0:
            named = _named_jax(grad(params, batch), jcfg.n_layers)
            kept[step] = {s: np.flatnonzero(np.abs(named[f"{s}/w"]).sum(0)).tolist()
                          for s in sites}
        params, opt, m = train_step(params, opt, batch)
        losses.append(float(m["loss"]))
    return dict(history=losses, kept=kept, params=_named_jax(params, jcfg.n_layers))


@pytest.fixture(scope="module")
def jax_runs(jcfg, init):
    tree, _ = init
    out = {name: _jax_run(jcfg, tree, pol) for name, (_, pol) in POLICIES.items()}
    out["tp"] = _jax_run(jcfg, tree, dataclasses.replace(jpolicy.paper_default(0.8),
                                                         tp_shards=2))
    return out


@pytest.fixture(scope="module")
def port_runs(init, tmp_path_factory):
    """Every mesh shape's runs, one spawn for the shapes of each size:
    ``{shape: {case: out}}``."""
    tree, d = init
    out, calls, names = {}, {}, {}
    for shape in SHAPES:
        argvs = {name: _argv(d, gran, shape) for name, (gran, _) in POLICIES.items()}
        tp = None
        if shape == (1, 2):
            crash = str(tmp_path_factory.mktemp("crash"))
            shutil.copytree(d, crash, dirs_exist_ok=True)
            argvs["crash"] = _argv(crash, "channel", shape) + ["--ckpt-every", "1",
                                                               "--fail-at-step", "2"]
            tp = (tree, LR)
        if shape == (2, 2):  # the JAX CLI's command line, from the same init
            argvs["cli"] = ["--device", "cpu", "--reduced", "--steps", "3", "--steps-per-epoch",
                            "1", "--global-batch", "4", "--seq-len", "16", "--ckpt-dir", d,
                            "--ckpt-every", "100", "--data-mesh", "2", "--model-mesh", "2"]
        calls[shape] = (ranks.train_cases, (list(argvs.values()), tp))
        names[shape] = [*argvs, *(["tp"] if tp else [])]
    for world in sorted({a * b for a, b in SHAPES}):
        group = {sh: c for sh, c in calls.items() if sh[0] * sh[1] == world}
        res = tmesh.run_on_mesh(ranks.on_shapes, *next(iter(group)), "cpu", group,
                                timeout_s=TIMEOUT_S)
        for shape, got in res.items():
            out[shape] = dict(zip(names[shape], got, strict=True))
    out[(1, 2)]["crash_dir"] = crash
    return out


def _assert_matches(got, want, what):
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["history"], want["history"], strict=True))
    assert rel <= TOL, (what, got["history"], want["history"])
    for step, sites in want["kept"].items():
        for site, cols in sites.items():
            assert got["kept"][step][site] == cols, (what, step, site)
    assert sorted(got["params"]) == sorted(want["params"])
    for name, p in got["params"].items():
        err = float(np.abs(p.numpy() - want["params"][name]).max())
        assert err <= TOL, (what, name, err)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_steps_match_the_jax_one_device_steps(port_runs, jax_runs, shape, policy):
    got = port_runs[shape][policy]
    _assert_matches(got, jax_runs[policy], f"{shape} {policy}")
    assert [r > 0 for r in got["rates"]] == [False, True, True]
    assert got["launches_by_rank"] == got["launch_table_by_rank"] or all(
        v == 0 for r in got["launches_by_rank"] for v in r.values())  # plain versions on the CPU


def test_tp_shards_on_the_kernel_route(port_runs, jax_runs):
    """``tp_shards`` = 2 at 1x2: each rank's selection is its own top-k
    of its columns and takes the kernel route (``matmul`` called twice a
    sparse column-parallel site and a row-parallel one not on the fast
    path), where the one-device step takes the TP fast path; the numbers
    are the JAX step's."""
    got = port_runs[(1, 2)]["tp"]
    _assert_matches(got, jax_runs["tp"], "tp_shards=2")
    assert got["matmul_calls"] == got["matmul_table"]
    # q/k/v/up/gate on both layers, 2 sparse steps, dX and dW: o/down take the fast path
    assert got["matmul_table"] == [2 * 2 * 5 * 2] * 2


def test_crash_and_resume_on_a_mesh(port_runs):
    """A crash as step 2 begins, on 1x2, after the run (resumed from the
    step-0 init) saved steps 1 and 2, resumes from the mesh's step-2
    checkpoint (a ``shard_<r>.msgpack`` a rank) and ends where the
    uninterrupted run ends, bit for bit: every loss and every param."""
    crash, whole = port_runs[(1, 2)]["crash"], port_runs[(1, 2)]["paper"]
    assert crash["steps"] == [0, 1, 2]
    assert [r["step"] for r in crash["ckpt"]["restores"]] == [0, 2]
    last = dict(zip(crash["steps"], crash["history"], strict=True))
    assert [last[i] for i in range(STEPS)] == whole["history"]
    for name, p in whole["params"].items():
        assert torch.equal(crash["params"][name], p), name


def test_a_mesh_checkpoint_restores_in_the_jax_package(port_runs, jcfg, init):
    """The crashed run's last checkpoint, written a shard a rank and
    committed by rank 0, is the JAX package's sharded format: its
    ``restore`` gives the port's gathered params."""
    tree, _ = init
    d = port_runs[(1, 2)]["crash_dir"]
    with open(os.path.join(d, f"step_{STEPS:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded" and manifest["ranks"] == [0, 1]
    assert sorted(os.listdir(os.path.join(d, f"step_{STEPS:08d}"))) == [
        "COMMITTED", "manifest.json", "shard_0.msgpack", "shard_1.msgpack"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    state = jckpt.restore(d, STEPS, {"params": tree, "m": zeros, "v": zeros})
    named = _named_jax(jax.tree.map(np.asarray, state["params"]), jcfg.n_layers)
    got = port_runs[(1, 2)]["crash"]["params"]
    assert sorted(named) == sorted(got)
    for name, p in got.items():
        np.testing.assert_array_equal(p.numpy(), named[name], err_msg=name)


_JAX_CLI = """
import json, sys
sys.path.insert(0, {src!r})
from repro.launch import train
args = train.build_parser().parse_args({argv!r})
print("RESULT " + json.dumps(train.run(args)["history"]))
"""


def test_the_jax_clis_command_line_on_a_2x2_mesh(port_runs):
    """The JAX CLI's 2x2 run (4 host devices, GSPMD) and the port's 2x2
    run (4 gloo ranks) of the same command line from the same init give
    the same losses within 1e-5."""
    argv = ["--reduced", "--steps", "3", "--steps-per-epoch", "1", "--global-batch", "4",
            "--seq-len", "16", "--data-mesh", "2", "--model-mesh", "2", "--log-every", "100"]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_CLI.format(src=SRC, argv=argv)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    want = json.loads(next(ln for ln in proc.stdout.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])
    got = port_runs[(2, 2)]["cli"]["history"]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want, strict=True):
        assert abs(a - b) <= TOL * abs(b), (got, want)
