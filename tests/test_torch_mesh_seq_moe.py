"""The MoE and hybrid families on a mesh whose data axis does not divide
the global batch, against the JAX package's one-device step, on the CPU.

The reduced kimi-k2 and jamba configs in fp32 at capacity factor 0.75
(the JAX step drops tokens), batch 3 of 16 tokens on 2x1: ``data`` moves
to the sequence, 8 positions a rank. 3 steps (dense, then two at
``paper_default(0.8)`` with ``use_pallas``, lr 5e-5) through
``make_train_step`` (``torch_mesh_ranks.seq_train``), at
``moe_dp_groups`` 0 (one global dispatch) and 2 (the reference's two
groups of 24 consecutive tokens of the flattened batch, each spanning
both ranks): the losses and every final param within 1e-5 of the JAX
steps, the kept channels of every site and routed expert equal, each MoE
layer's ``dropped`` equal to the JAX step's (the dispatch orders the
tokens by their global index, ``row * S + position``), and each rank's
``matmul`` calls equal to the launch table's. One spawn of 2 ranks (one
torch thread a rank, a 120-s timeout).
"""
import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro_torch.launch import mesh as tmesh

ARCHS = ("kimi-k2-1t-a32b", "jamba-1.5-large-398b")
GROUPS = (0, 2)
B, S, LR, CF = 3, 16, 5e-5, 0.75
TIMEOUT_S = 120
CASES = [(a, g) for a in ARCHS for g in GROUPS]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = ref.config(arch, capacity_factor=CF)
        out[arch] = (ref.init(jcfg), ref.batches(jcfg, B, S))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return {(a, g): ref.train(ref.config(a, capacity_factor=CF, moe_dp_groups=g),
                              *models[a], LR) for a, g in CASES}


@pytest.fixture(scope="module")
def port_runs(models):
    calls = [(ranks.seq_train, ((1, 2, 1), a, models[a][0],
                                dict(capacity_factor=CF, moe_dp_groups=g), models[a][1], LR))
             for a, g in CASES]
    got = tmesh.run_on_mesh(ranks.in_turn, 2, 1, "cpu", calls, timeout_s=TIMEOUT_S)
    return dict(zip(CASES, got, strict=True))


@pytest.mark.parametrize("arch, groups", CASES, ids=[f"{a}-g{g}" for a, g in CASES])
def test_seq_split_moe_steps_match_the_jax_one_device_steps(port_runs, jax_runs, arch, groups):
    got, want = port_runs[arch, groups], jax_runs[arch, groups]
    ref.assert_matches(got, want, f"{arch} g{groups}")
    assert max(max(d) for d in want["dropped"]) > 0, "the JAX step drops no token"
    assert (tuple(got["rows"]), tuple(got["seq"])) == ((0, B), (0, S // 2))
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])
