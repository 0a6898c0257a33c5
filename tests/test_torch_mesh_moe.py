"""The MoE and hybrid families on device meshes against the JAX package's
one-device step and engine, on the CPU.

The reduced kimi-k2, llama4 and jamba configs in fp32, the JAX package's
params from ``PRNGKey(0)``, at capacity factor 0.75, where the JAX step
drops tokens. The mesh shapes of each size share one spawn of gloo ranks
(1x2 and 2x1; 2x2; one torch thread a rank, a 120-s timeout):

* 3 steps (dense, then two at ``paper_default(0.8)`` with ``use_pallas``,
  lr 5e-5) through ``make_train_step``: the losses and every final param
  within 1e-5 of the JAX steps, the kept channels of every site and of
  every routed expert equal, and each MoE layer's ``dropped`` equal to
  the JAX step's. 2x1 and 2x2 at ``moe_dp_groups=0`` run the global
  dispatch over the data ranks; kimi-k2 at 2x1 with ``moe_dp_groups=2``
  dispatches within each data rank's group. Each rank's ``matmul`` calls
  equal the launch table's (its own experts);
* serving on ``--model-mesh 2`` (experts split over the ranks) in the
  modes greedy-kernel, sampled-kernel and swap: every rank's streams and
  the counters equal the JAX engine's token for token.
"""
import numpy as np
import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks


ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
SHAPES = [(1, 2), (2, 1), (2, 2)]
B, S, LR, CF = 4, 16, 5e-5, 0.75
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
# (arch, moe_dp_groups) -> the mesh shapes it trains on
CASES = {(a, 0): SHAPES for a in ARCHS}
CASES[("kimi-k2-1t-a32b", 2)] = [(2, 1)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = ref.config(arch, capacity_factor=CF)
        out[arch] = (jcfg, ref.init(jcfg), ref.batches(jcfg, B, S))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    out = {}
    for arch, groups in CASES:
        _, tree, data = models[arch]
        jcfg = ref.config(arch, capacity_factor=CF, moe_dp_groups=groups)
        out[arch, groups] = ref.train(jcfg, tree, data, LR)
    return out


@pytest.fixture(scope="module")
def jax_serve(models):
    return {arch: ref.engine_runs(ref.config(arch), ref.jax_params(models[arch][1]), MODES,
                                  MAX_SEQ) for arch in ARCHS}


@pytest.fixture(scope="module")
def port_runs(models):
    """``{(shape, arch, groups): out}`` and ``{("serve", arch): out}``, one
    spawn for the shapes of each size."""
    calls, keys = {}, {}
    for shape in SHAPES:
        fns = []
        for (arch, groups), shapes in CASES.items():
            if shape in shapes:
                _, tree, data = models[arch]
                fns.append(((shape, arch, groups), (
                    ranks.family_train,
                    (arch, tree, dict(capacity_factor=CF, moe_dp_groups=groups), data, LR))))
        if shape == (1, 2):  # serving: the config's own capacity (decode drops nothing)
            for arch in ARCHS:
                fns.append((("serve", arch), (ranks.serve_cases, (
                    models[arch][1], None, MODES, MAX_SEQ, None, arch))))
        keys[shape] = [k for k, _ in fns]
        calls[shape] = (ranks.in_turn, ([c for _, c in fns],))
    return ranks.spawn_shapes(calls, keys, TIMEOUT_S)


TRAIN = [(shape, arch, groups) for (arch, groups), shapes in CASES.items() for shape in shapes]


@pytest.mark.parametrize("shape, arch, groups", TRAIN,
                         ids=[f"{a}-g{g}-{s[0]}x{s[1]}" for s, a, g in TRAIN])
def test_mesh_steps_match_the_jax_one_device_steps(port_runs, jax_runs, shape, arch, groups):
    got, want = port_runs[shape, arch, groups], jax_runs[arch, groups]
    ref.assert_matches(got, want, f"{arch} g{groups} {shape}")
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


def test_the_global_dispatch_drops_what_the_jax_step_drops(port_runs, jax_runs):
    """At 2x1 with ``moe_dp_groups=0`` the capacity is global over the
    batch: the JAX step drops tokens, and every data rank's dispatch,
    placed by the all-gathered routing ids, drops the same share."""
    for arch in ARCHS:
        want = jax_runs[arch, 0]["dropped"]
        assert max(max(d) for d in want) > 0, arch
        assert port_runs[(2, 1), arch, 0]["dropped"] == want, arch


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_mesh_streams_are_the_jax_engines(port_runs, jax_serve, arch, mode):
    port = port_runs["serve", arch][mode]
    ref.assert_streams(port, jax_serve[arch][mode], f"{arch} {mode}")
    if mode == "swap":
        assert port[1]["swap_preemptions"] > 0
        assert np.all(np.asarray(port[3]) > 0)
