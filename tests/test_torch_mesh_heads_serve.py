"""Serving on a model mesh that does not divide the q heads, against the
JAX package's one-device engines, on the CPU.

Each rank runs the heads its q columns touch
(``models/layers.py::head_span``) and caches their KV heads whole (the
reference's ``fit_spec`` puts ``model`` on the cache's head dim there;
the port keeps whole heads, ``models/model.py::shard_cache``). The
reduced configs of ``tests/test_torch_mesh_heads.py`` in fp32, the JAX
package's params from ``PRNGKey(0)``: llama4-like (10 q heads on 2 KV
heads), whisper-like (6 and 6, its encoder a request on the mesh) and
paligemma-like (2 on one) on 1x4, and 3 q and 3 KV heads on 2x2 (the
slots split over ``data``). Every rank's streams must be the JAX
engine's token for token, with its counters:

* the paged engine (greedy on the kernel route, sampled with swap
  preemption, whose swapped bundles hold the rank's KV heads) and the
  contiguous engine;
* the lock-step engine (``serve.generate_lockstep``, the reference's
  ``make_serve_step``), and the same with ``decode_seq_shard``: the k/v
  kernels whole, the contiguous K/V's sequence over ``model``, every
  head's partial softmax combined over the model ranks and the rank's
  span kept; the JAX package's one-device ``generate_lockstep``'s
  tokens.

One spawn of 4 gloo ranks for both shapes, one torch thread a rank, a
timeout. On the CPU the paged-attention wrapper runs its plain version,
so no launch is counted.
"""
import jax
import numpy as np
import pytest
import torch
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro.serve import generate_lockstep as jax_generate_lockstep

TIMEOUT_S = 150
MAX_SEQ = 24
SAMPLED = dict(n_requests=4, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=5,
               temperature=0.8, top_k=50, top_p=0.95)
GREEDY = dict(SAMPLED, temperature=0.0, seed=6)
MODES = {
    "greedy-kernel": (GREEDY, dict(max_slots=4, block_size=4, n_blocks=24, attn_kernel=True),
                      False, False),
    "swap": (SAMPLED, dict(max_slots=4, block_size=4, n_blocks=7, preempt="swap"), False, False),
    "contiguous": (SAMPLED, dict(max_slots=4), False, False),
}
# name -> (arch, config overrides, (data, model))
CASES = {
    "llama4-like-1x4": ("llama4-maverick-400b-a17b", dict(n_heads=10, n_kv_heads=2), (1, 4)),
    "whisper-like-1x4": ("whisper-large-v3", dict(n_heads=6, n_kv_heads=6), (1, 4)),
    "paligemma-like-1x4": ("paligemma-3b", dict(n_heads=2, n_kv_heads=1), (1, 4)),
    "three-heads-2x2": ("qwen2.5-3b", dict(n_heads=3, n_kv_heads=3), (2, 2)),
}
PROMPTS = np.random.default_rng(11).integers(0, 512, (4, 5)).astype(np.int32)
LOCK_GEN = 6
LOCK = ("lockstep", "lockstep-seq-model")


def _frames(jcfg):
    if jcfg.family != "encdec":
        return None
    return np.random.default_rng(12).standard_normal(
        (len(PROMPTS), jcfg.enc_seq, jcfg.d_model), dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (arch, overrides, _) in CASES.items():
        jcfg = ref.config(arch, **overrides)
        out[name] = (jcfg, ref.init(jcfg))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """The one-device JAX engine's streams and counters in every mode, and
    its lock-step tokens."""
    out = {}
    for name, (jcfg, tree) in models.items():
        jparams = ref.jax_params(tree)
        res = jax_generate_lockstep(jcfg, jparams, PROMPTS, [LOCK_GEN] * len(PROMPTS),
                                    max_seq=MAX_SEQ, frames=_frames(jcfg))
        out[name] = (ref.engine_runs(jcfg, jparams, MODES, MAX_SEQ),
                     np.stack([np.asarray(t) for t in res["tokens"]]))
    return out


@pytest.fixture(scope="module")
def port_runs(models):
    calls, keys = {}, {}
    for shape in ((1, 4), (2, 2)):
        todo, names = [], []
        for name, (arch, overrides, sh) in CASES.items():
            if sh != shape:
                continue
            jcfg, tree = models[name]
            todo.append((ranks.serve_cases, (tree, None, MODES, MAX_SEQ, None, arch, overrides)))
            lock = {case: (PROMPTS, LOCK_GEN, dict(overrides, decode_seq_shard=case != LOCK[0]),
                           _frames(jcfg)) for case in LOCK}
            todo.append((ranks.lockstep_streams, (arch, jax.tree.map(np.asarray, tree), lock,
                                                  MAX_SEQ)))
            names += [(name, "engine"), (name, "lockstep")]
        calls[shape] = (ranks.in_turn, (todo,))
        keys[shape] = names
    return ranks.spawn_shapes(calls, keys, TIMEOUT_S)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_streams_are_the_jax_engines(port_runs, jax_runs, name, mode):
    port = port_runs[name, "engine"][mode]
    ref.assert_streams(port, jax_runs[name][0][mode], f"{name} {mode}")
    if mode == "swap":
        assert port[1]["swap_preemptions"] > 0
        assert np.all(np.asarray(port[3]) > 0)  # every rank swapped its KV heads


@pytest.mark.parametrize("case", LOCK)
@pytest.mark.parametrize("name", sorted(CASES))
def test_lockstep_streams_are_the_jax_lockstep(port_runs, jax_runs, name, case):
    """The lock-step engine's tokens, every rank's alike, equal the JAX
    package's one-device ``generate_lockstep``'s; the seq-sharded case's
    layout splits the K/V's sequence over ``model``."""
    tokens, (slots, seq), same = port_runs[name, "lockstep"][case]
    assert same
    assert seq == ("model" if case == "lockstep-seq-model" else None)
    assert (slots != (0, len(PROMPTS))) == (CASES[name][2][0] > 1)
    np.testing.assert_array_equal(tokens, jax_runs[name][1])
