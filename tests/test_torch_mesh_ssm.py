"""The SSM family on device meshes against the JAX package's one-device
step and engine, on the CPU.

Reduced mamba2-1.3b in fp32 (8 SSM heads), the JAX package's params from
``PRNGKey(0)``. The mesh shapes of one size (1x2 and 2x1) share one spawn
of gloo ranks (one torch thread a rank, a 120-s timeout):

* 3 steps (dense, then two at ``paper_default(0.8)`` with ``use_pallas``,
  lr 5e-5) through ``make_train_step``: at 1x2 each rank runs 4 heads
  (``in_proj`` gathered on use, the gated norm's sum of squares summed
  over ``model``, ``out_proj`` row-parallel); the losses and every final
  param within 1e-5 of the JAX steps, the kept channels of every site
  equal, and each rank's ``matmul`` calls equal to the launch table's;
* serving on ``--model-mesh 2`` (each rank's state heads and conv
  channels) in the modes greedy-kernel, sampled-kernel and swap: every
  rank's streams and the counters equal the JAX engine's token for
  token, a swap staging the rank's own rows;
* a 1x2 training CLI run of reduced kimi-k2 (experts split over
  ``model``) and of mamba2, each checkpointed at its last step: the JAX
  package's ``restore`` reads each sharded checkpoint as the gathered
  params.
"""
import os

import jax
import numpy as np
import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro.checkpoint import ckpt as jckpt

ARCH = "mamba2-1.3b"
# S: two SSM chunks of 16. At S=24 one element of layer 0's in_proj lands
# 1.12e-5 from the JAX step at 1x2: its dense-step gradient is -1.1e-9 in
# JAX, under Adam's eps (1e-8), where an update moves lr * g / eps and the
# fp32 rounding of g (~1e-9 here, the one-device port's too) decides it
B, S, LR = 4, 32, 5e-5
TIMEOUT_S = 120
MAX_SEQ = 24
SAMPLED = dict(n_requests=4, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=5,
               temperature=0.8, top_k=50, top_p=0.95)
GREEDY = dict(SAMPLED, temperature=0.0, seed=6)
PAGED = dict(max_slots=3, block_size=4, n_blocks=18)
MODES = {
    "greedy-kernel": (GREEDY, dict(PAGED, attn_kernel=True), False, False),
    "sampled-kernel": (SAMPLED, dict(PAGED, attn_kernel=True), False, False),
    "swap": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=7, preempt="swap"), False, False),
}
CKPT_ARCHS = ("kimi-k2-1t-a32b", ARCH)
CKPT_STEPS = 3


@pytest.fixture(scope="module")
def model():
    jcfg = ref.config(ARCH)
    return jcfg, ref.init(jcfg), ref.batches(jcfg, B, S)


@pytest.fixture(scope="module")
def jax_runs(model):
    jcfg, tree, data = model
    return ref.train(jcfg, tree, data, LR), ref.engine_runs(jcfg, ref.jax_params(tree), MODES,
                                                            MAX_SEQ)


def _ckpt_argv(arch, d):
    return ["--device", "cpu", "--reduced", "--arch", arch, "--steps", str(CKPT_STEPS),
            "--steps-per-epoch", "1", "--global-batch", "4", "--seq-len", "16", "--use-pallas",
            "--ckpt-dir", d, "--ckpt-every", str(CKPT_STEPS), "--log-every", "100",
            "--model-mesh", "2"]


@pytest.fixture(scope="module")
def port_runs(model, tmp_path_factory):
    _, tree, data = model
    dirs = {a: str(tmp_path_factory.mktemp(a)) for a in CKPT_ARCHS}
    calls = {
        (1, 2): (ranks.in_turn, ([
            (ranks.family_train, (ARCH, tree, {}, data, LR)),
            (ranks.serve_cases, (tree, None, MODES, MAX_SEQ, None, ARCH)),
            (ranks.train_cases, ([_ckpt_argv(a, dirs[a]) for a in CKPT_ARCHS],)),
        ],)),
        (2, 1): (ranks.in_turn, ([(ranks.family_train, (ARCH, tree, {}, data, LR))],)),
    }
    keys = {(1, 2): [("train", (1, 2)), "serve", "ckpt"], (2, 1): [("train", (2, 1))]}
    return dict(ranks.spawn_shapes(calls, keys, TIMEOUT_S), dirs=dirs)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_steps_match_the_jax_one_device_steps(port_runs, jax_runs, shape):
    got = port_runs["train", shape]
    ref.assert_matches(got, jax_runs[0], f"{ARCH} {shape}")
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_model_mesh_streams_are_the_jax_engines(port_runs, jax_runs, mode):
    port = port_runs["serve"][mode]
    ref.assert_streams(port, jax_runs[1][mode], f"{ARCH} {mode}")
    if mode == "swap":
        assert port[1]["swap_preemptions"] > 0
        assert np.all(np.asarray(port[3]) > 0)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_a_mesh_checkpoint_restores_in_the_jax_package(port_runs, arch):
    """A 1x2 run's last checkpoint (a ``shard_<r>.msgpack`` a rank; the
    experts or the SSM's ``in_proj`` / ``out_proj`` split over ``model``)
    is the JAX package's sharded format: its ``restore`` gives the port's
    gathered params, bit for bit."""
    d = port_runs["dirs"][arch]
    step = os.path.join(d, f"step_{CKPT_STEPS:08d}")
    assert sorted(os.listdir(step)) == ["COMMITTED", "manifest.json", "shard_0.msgpack",
                                        "shard_1.msgpack"]
    jcfg = ref.config(arch)
    like = ref.init(jcfg)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), like)
    state = jckpt.restore(d, CKPT_STEPS, {"params": like, "m": zeros, "v": zeros})
    want = ref.named(jax.tree.map(np.asarray, state["params"]), jcfg)
    got = port_runs["ckpt"][CKPT_ARCHS.index(arch)]["params"]
    assert sorted(want) == sorted(got)
    for name, p in got.items():
        np.testing.assert_array_equal(p.numpy(), want[name], err_msg=name)
