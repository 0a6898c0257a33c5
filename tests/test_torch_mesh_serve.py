"""Serving on a model mesh against the JAX engine, on the CPU.

Reduced qwen2.5-3b (fp32, 2 KV heads), the JAX package's params. One
spawn of 2 gloo ranks (``--model-mesh 2``, one KV head a rank; one torch
thread a rank, a 120-s timeout) runs the engine in every mode below and
the serving CLI's rank body; every mode's streams and counters must be
the one-device JAX engine's token for token, on every rank, and the CLI
must print the one-device CLI's tokens. A spawn of 4 ranks
(``--model-mesh 4``: half a KV head a rank, so each caches the head its
q head reads) holds two modes to the JAX engine the same way. On the
CPU the paged-attention wrapper runs its plain version, so no launch is
counted.
"""
import jax
import numpy as np
import pytest
import torch_mesh_ranks as ranks

from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jlm
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve

ARCH = "qwen2.5-3b"
MAX_SEQ = 24
TIMEOUT_S = 120
GREEDY = dict(n_requests=6, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(6, 12), seed=5)
SAMPLED = dict(GREEDY, temperature=0.8, top_k=50, top_p=0.95)
PAGED = dict(max_slots=3, block_size=4, n_blocks=18)
# mode -> (workload, ServeConfig fields, drafter?, every other request greedy?)
MODES = {
    "greedy-kernel": (GREEDY, dict(PAGED, attn_kernel=True), False, False),
    "greedy-gather": (GREEDY, dict(PAGED, attn_kernel=False), False, False),
    "sampled-kernel": (SAMPLED, dict(PAGED, attn_kernel=True), False, False),
    "sampled-gather": (SAMPLED, dict(PAGED, attn_kernel=False), False, False),
    "swap": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=7, preempt="swap"), False, False),
    "auto": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=7, preempt="auto"), False, True),
    "contiguous": (SAMPLED, dict(max_slots=3), False, False),
    "spec-drafter": (SAMPLED, dict(PAGED, spec_k=2), True, False),
}
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps", "swapped_bytes")
CLI = ["--device", "cpu", "--reduced", "--batch", "2", "--requests", "4", "--prompt-len", "12",
       "--gen", "8", "--prefill-chunk", "4", "--block-size", "4"]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    jdcfg = jcfg.reduced(n_layers=1)
    return dict(jcfg=jcfg, jdcfg=jdcfg, jparams=jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                jdparams=jlm.init_params(jdcfg, jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def jax_runs(model):
    """The one-device JAX engine's streams and counters in every mode."""
    out = {}
    for name, (wkw, skw, draft, mixed) in MODES.items():
        skw = {k: v for k, v in skw.items() if k != "attn_kernel"}
        kw = dict(draft_cfg=model["jdcfg"], draft_params=model["jdparams"]) if draft else {}
        eng = JaxEngine(model["jcfg"], model["jparams"],
                        JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw), **kw)
        reqs = jax_poisson_workload(model["jcfg"], **wkw)
        if mixed:
            for r in reqs[::2]:
                r.sampling = type(r.sampling)()
        for r in reqs:
            eng.submit(r)
        out[name] = ({rid: list(map(int, t)) for rid, t in eng.run().items()}, eng.stats())
    return out


@pytest.fixture(scope="module")
def port_runs(model):
    tree = jax.tree.map(np.asarray, model["jparams"])
    dtree = jax.tree.map(np.asarray, model["jdparams"])
    return tmesh.run_on_mesh(ranks.serve_cases, 1, 2, "cpu", tree, dtree, MODES, MAX_SEQ,
                             CLI + ["--model-mesh", "2"], timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_model_mesh_streams_are_the_jax_engines(port_runs, jax_runs, mode):
    """Every rank's streams are the JAX engine's, and so are the counters;
    a swap stages each rank's own KV heads, so the ranks' swapped bytes
    sum to the JAX engine's."""
    streams, stats, launches, swapped, same = port_runs[mode]
    want, jstats = jax_runs[mode]
    assert same, "the two ranks' streams differ"
    assert streams == want
    for k in COUNTERS:
        got = sum(swapped) if k == "swapped_bytes" else stats[k]
        assert got == jstats[k], k
    assert launches == [0, 0]  # the plain version on the CPU: no kernel launched
    if mode == "swap":
        assert stats["swap_preemptions"] > 0


def test_the_cli_on_a_model_mesh_prints_the_one_device_tokens(port_runs):
    one = tserve.run(tserve.build_parser().parse_args(CLI))["generated"]
    assert port_runs["cli"] == one.tolist()


MESH_4_MODES = ("greedy-kernel", "sampled-kernel")


@pytest.fixture(scope="module")
def port_runs_4(model):
    """The engine on a model mesh of 4 (2 KV heads: each rank caches the
    KV head its q head reads, gathered once at load), in two modes."""
    tree = jax.tree.map(np.asarray, model["jparams"])
    modes = {m: MODES[m] for m in MESH_4_MODES}
    return tmesh.run_on_mesh(ranks.serve_cases, 1, 4, "cpu", tree, None, modes, MAX_SEQ, None,
                             timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("mode", MESH_4_MODES)
def test_a_model_mesh_of_4_streams_are_the_jax_engines(port_runs_4, jax_runs, mode):
    """At ``--model-mesh 4``, which does not divide the 2 KV heads, every
    rank's streams and the counters are the JAX engine's."""
    streams, stats, launches, _, same = port_runs_4[mode]
    want, jstats = jax_runs[mode]
    assert same, "the four ranks' streams differ"
    assert streams == want
    for k in COUNTERS:
        if k != "swapped_bytes":
            assert stats[k] == jstats[k], k
    assert launches == [0] * 4
