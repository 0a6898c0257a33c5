"""The encoder-decoder and VLM families on device meshes against the JAX
package's one-device step and engine, on the CPU.

Reduced whisper-large-v3 (2 + 2 layers, 2 KV heads) and paligemma-3b (one
KV head, 8 patches) in fp32, the JAX package's params from
``PRNGKey(0)``. The mesh shapes of one size (1x2 and 2x1) share one spawn
of gloo ranks (one torch thread a rank, a 120-s timeout):

* 3 steps (dense, then two at ``paper_default(0.8)`` with ``use_pallas``,
  lr 5e-5) through ``make_train_step``, the frames or patches in the
  batch: the encoder and the cross-decoder (cross-attention's K/V
  projected from the replicated encoder output) on the rank's heads,
  paligemma's one KV head gathered on use; the losses and every final
  param within 1e-5 of the JAX steps, the kept channels of every site
  equal, each rank's ``matmul`` calls equal to the launch table's;
* serving on ``--model-mesh 2`` in the modes greedy-kernel,
  sampled-kernel and swap: whisper's encoder a request on the mesh,
  paligemma's KV head cached by both ranks (each with its 2 q heads);
  every rank's streams and the counters equal the JAX engine's token for
  token.
"""
import numpy as np
import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

ARCHS = ("whisper-large-v3", "paligemma-3b")
SHAPES = [(1, 2), (2, 1)]
# At S=16 one element of paligemma's layer-0 attn/o lands 1.44e-5 from the
# JAX step at 1x2: its dense-step gradient is -4.2e-9 in JAX, under Adam's
# eps (1e-8), where an update moves lr * g / eps and the fp32 rounding of
# g (~1e-8 here, the one-device port's too) decides it
B, S, LR = 4, 24, 5e-5
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


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = ref.config(arch)
        out[arch] = (jcfg, ref.init(jcfg), ref.batches(jcfg, B, S))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return {arch: (ref.train(jcfg, tree, data, LR),
                   ref.engine_runs(jcfg, ref.jax_params(tree), MODES, MAX_SEQ))
            for arch, (jcfg, tree, data) in models.items()}


@pytest.fixture(scope="module")
def port_runs(models):
    calls, keys = {}, {}
    for shape in SHAPES:
        fns = [((shape, arch), (ranks.family_train, (arch, tree, {}, data, LR)))
               for arch, (_, tree, data) in models.items()]
        if shape == (1, 2):
            fns += [(("serve", arch), (ranks.serve_cases, (tree, None, MODES, MAX_SEQ, None,
                                                           arch)))
                    for arch, (_, tree, _) in models.items()]
        keys[shape] = [k for k, _ in fns]
        calls[shape] = (ranks.in_turn, ([c for _, c in fns],))
    return ranks.spawn_shapes(calls, keys, TIMEOUT_S)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_match_the_jax_one_device_steps(port_runs, jax_runs, arch, shape):
    got = port_runs[shape, arch]
    ref.assert_matches(got, jax_runs[arch][0], f"{arch} {shape}")
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_mesh_streams_are_the_jax_engines(port_runs, jax_runs, arch, mode):
    port = port_runs["serve", arch][mode]
    ref.assert_streams(port, jax_runs[arch][1][mode], f"{arch} {mode}")
    if mode == "swap":
        assert port[1]["swap_preemptions"] > 0
        assert np.all(np.asarray(port[3]) > 0)
