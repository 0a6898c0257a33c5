"""Serving the ssm, hybrid and moe families against the JAX engine, on the CPU.

Reduced mamba2-1.3b (SSM layers only: no K/V, no pages), jamba-1.5-large
(attention + Mamba + MoE) and kimi-k2 (MoE with a shared expert, decoded
at full capacity), fp32. Params are made by the JAX package and
converted; workloads come from the same seeds in both packages. Every
mode's token streams and counters must be the JAX engine's exactly: the
paged engine, greedy and sampled, the
contiguous cache, swap preemption (the SSM rows travel with the pages),
speculative decoding self-drafted and with a smaller drafter of the
same family (the SSM state committed as of the accepted prefix), and the
lock-step oracle.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import model as jlm
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro.serve import lockstep_waves as jax_lockstep_waves
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import model as tlm
from repro_torch.serve import (
    ContinuousBatchingEngine,
    ServeConfig,
    generate_lockstep,
    lockstep_waves,
    poisson_workload,
)

pytestmark = pytest.mark.slow

ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b")
MAX_SEQ = 24
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps", "swapped_bytes")
SAMPLED = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=5,
               temperature=0.8, top_k=50, top_p=0.95)
GREEDY = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=6)
# mode -> (workload, ServeConfig fields, drafter or None)
MODES = {
    "greedy-paged": (GREEDY, dict(max_slots=3, block_size=4, n_blocks=18), None),
    "sampled-paged": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18), None),
    "contiguous": (SAMPLED, dict(max_slots=3), None),
    "swap": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=5, preempt="swap"), None),
    "spec-self": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18, spec_k=2), None),
    "spec-drafter": (GREEDY, dict(max_slots=3, block_size=4, n_blocks=18, spec_k=2), "small"),
}
# the paged runs take the kernel route, whose plain version on the CPU is
# the gather route's computation (test_torch_serve_features.py runs both)
RUNS = [(a, m, r) for a in ARCHS for m, r in (
    ("greedy-paged", "kernel"), ("sampled-paged", "kernel"), ("contiguous", "-"),
    ("swap", "kernel"), ("spec-self", "kernel"), ("spec-drafter", "kernel"),
)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, cfg = jget(arch).reduced(), tget(arch).reduced()
        jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        params = tlm.params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
        nd = 2 if cfg.attn_every else 1
        jdcfg, dcfg = jcfg.reduced(n_layers=nd), cfg.reduced(n_layers=nd)
        jdparams = jlm.init_params(jdcfg, jax.random.PRNGKey(1))
        dparams = tlm.params_from_jax(dcfg, jax.tree.map(np.asarray, jdparams), device="cpu")
        _MODELS[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                             jdcfg=jdcfg, dcfg=dcfg, jdparams=jdparams, dparams=dparams)
    return _MODELS[arch]


_JAX = {}


def _jax_run(arch, mode):
    if (arch, mode) not in _JAX:
        m = _model(arch)
        kind, skw, draft = MODES[mode]
        kw = dict(draft_cfg=m["jdcfg"], draft_params=m["jdparams"]) if draft else {}
        eng = JaxEngine(m["jcfg"], m["jparams"],
                        JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw), **kw)
        for r in jax_poisson_workload(m["jcfg"], **kind):
            eng.submit(r)
        _JAX[arch, mode] = (eng.run(), eng.stats())
    return _JAX[arch, mode]


@pytest.mark.parametrize("arch,mode,route", RUNS, ids=[f"{a}-{m}-{r}" for a, m, r in RUNS])
def test_engine_streams_and_counters_match_jax(arch, mode, route):
    """Token for token the JAX engine's streams, with its step count,
    preemptions, swap traffic (the SSM rows included), proposals,
    acceptances and drafter steps; at the end every page is back in the
    pool, every K/V page and every SSM row zero."""
    m = _model(arch)
    kind, skw, draft = MODES[mode]
    kw = dict(draft_cfg=m["dcfg"], draft_params=m["dparams"]) if draft else {}
    if route != "-":
        skw = dict(skw, attn_kernel=route == "kernel")
    eng = ContinuousBatchingEngine(
        m["cfg"], m["params"], ServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw),
        device="cpu", **kw,
    )
    for r in poisson_workload(m["cfg"], **kind):
        eng.submit(r)
    out = eng.run()
    ref, ref_stats = _jax_run(arch, mode)
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=f"rid={rid}")
    stats = eng.stats()
    assert {k: stats[k] for k in COUNTERS} == {k: ref_stats[k] for k in COUNTERS}
    if mode == "swap":
        assert stats["swap_preemptions"] > 0 and stats["swapped_bytes"] > 0
    if mode.startswith("spec"):
        assert stats["spec_proposed"] > 0 and stats["draft_steps"] > 0
    if eng.serve_cfg.paged:
        assert eng.slots.allocator.n_free == eng.slots.n_blocks
        for layer in eng.slots.cache:
            assert not any(t.any() for t in layer.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_matches_jax(arch):
    """The sampled lock-step oracle, wave by wave, is the JAX one's."""
    m = _model(arch)
    kw = dict(SAMPLED, arrival_rate=1e9)
    reqs = poisson_workload(m["cfg"], uniform_prompts=True, **kw)
    jreqs = jax_poisson_workload(m["jcfg"], uniform_prompts=True, **kw)
    for wave, jwave in zip(lockstep_waves(reqs, 3), jax_lockstep_waves(jreqs, 3), strict=True):
        args = (np.stack([r.prompt for r in wave]), [r.max_new_tokens for r in wave])
        ours = generate_lockstep(m["cfg"], m["params"], *args, max_seq=MAX_SEQ,
                                 sampling=[r.sampling for r in wave], device="cpu")
        ref = jax_generate_lockstep(m["jcfg"], m["jparams"], *args, max_seq=MAX_SEQ,
                                    sampling=[r.sampling for r in jwave])
        assert ours["steps"] == ref["steps"]
        for a, b in zip(ours["tokens"], ref["tokens"], strict=True):
            np.testing.assert_array_equal(a, b)


def test_paged_cache_of_an_ssm_stack_holds_no_pages():
    """mamba2 has no attention layer: its paged cache is SSM rows only,
    a row a slot, and swapping a slot out stages exactly those rows."""
    cfg = _model("mamba2-1.3b")["cfg"]
    cache = tlm.init_paged_cache(cfg, 16, 4, torch.float32, "cpu", batch=3)
    assert all(set(layer) == {"conv", "state"} for layer in cache)
    assert all(layer["state"].shape[0] == 3 for layer in cache)
    with pytest.raises(ValueError, match="slot count"):
        tlm.init_paged_cache(cfg, 16, 4, torch.float32, "cpu")
    for layer in cache:
        layer["state"][1] = 1.0
    data = tlm.swap_out_slot(cache, 1, [])
    assert all(float(d["state"].min()) == 1.0 for d in data)
    tlm.reset_paged(cache, np.array([False, True, False]), np.zeros(16, bool))
    assert not any(layer["state"].any() for layer in cache)
    tlm.swap_in_slot(cache, data, 2, [])
    assert all(float(layer["state"][2].min()) == 1.0 for layer in cache)


def test_commit_spec_cache_selects_the_accepted_position():
    """A speculative step's per-position SSM stacks collapse to position
    ``keep - 1`` (position 0 for ``keep == 0``); K/V pass through."""
    cfg = _model("jamba-1.5-large-398b")["cfg"]
    cache = tlm.init_cache(cfg, 3, 8, torch.float32, "cpu")
    spec = []
    for layer in cache:
        if "state" in layer:
            spec.append({k: torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4, *(
                [1] * (t.dim() - 1))).expand(3, 4, *t.shape[1:]).clone() for k, t in
                layer.items()})
        else:
            spec.append(layer)
    out = tlm.commit_spec_cache(spec, torch.tensor([2, 0, 4]))
    for layer, before in zip(out, cache, strict=True):
        if "state" in layer:
            assert tuple(layer["state"].shape) == tuple(before["state"].shape)
            np.testing.assert_array_equal(layer["state"].flatten(1)[:, 0].numpy(), [1, 4, 11])
        else:
            assert layer is before
