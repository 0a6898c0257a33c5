"""Serving the encoder-decoder family (whisper-large-v3) against the JAX engine, on the CPU.

Reduced whisper (2 encoder + 2 decoder layers, 32 frames, fp32), params
made by the JAX package and converted, workloads (frames included) from
the same seeds in both packages. Every mode's token streams and
counters must be the JAX engine's exactly: the paged engine on the
kernel route (its plain version here) and the gather route, greedy and
sampled; the contiguous cache; swap preemption (the request's encoder
output made again at its return); speculative decoding self-drafted
(the drafter's own encoder output); and the lock-step oracle with the
workload's frames.
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

ARCH = "whisper-large-v3"
MAX_SEQ = 24
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps", "swapped_bytes")
SAMPLED = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=5,
               temperature=0.8, top_k=50, top_p=0.95)
GREEDY = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=6)
# mode -> (workload, ServeConfig fields)
MODES = {
    "greedy-paged": (GREEDY, dict(max_slots=3, block_size=4, n_blocks=18)),
    "sampled-paged": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18)),
    "contiguous": (SAMPLED, dict(max_slots=3)),
    "swap": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=5, preempt="swap")),
    "recompute": (GREEDY, dict(max_slots=3, block_size=4, n_blocks=5, preempt="recompute")),
    "spec-self": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18, spec_k=2)),
}
RUNS = [("greedy-paged", "kernel"), ("greedy-paged", "gather"), ("sampled-paged", "kernel"),
        ("sampled-paged", "gather"), ("contiguous", "-"), ("swap", "kernel"),
        ("recompute", "kernel"), ("spec-self", "kernel")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
        jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL.update(jcfg=jcfg, cfg=cfg, jparams=jparams,
                      params=tlm.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                                 device="cpu"))
    return _MODEL


_JAX = {}


def _jax_run(mode):
    if mode not in _JAX:
        m = _model()
        kind, skw = MODES[mode]
        eng = JaxEngine(m["jcfg"], m["jparams"],
                        JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw))
        for r in jax_poisson_workload(m["jcfg"], **kind):
            eng.submit(r)
        _JAX[mode] = (eng.run(), eng.stats())
    return _JAX[mode]


@pytest.mark.parametrize("mode,route", RUNS, ids=[f"{m}-{r}" for m, r in RUNS])
def test_engine_streams_and_counters_match_jax(mode, route):
    """Token for token the JAX engine's streams, with its step count,
    preemptions, swap traffic, proposals, acceptances and drafter steps;
    at the end every page is back in the pool and zero."""
    m = _model()
    kind, skw = MODES[mode]
    if route != "-":
        skw = dict(skw, attn_kernel=route == "kernel")
    eng = ContinuousBatchingEngine(
        m["cfg"], m["params"], ServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw), device="cpu",
    )
    for r in poisson_workload(m["cfg"], **kind):
        eng.submit(r)
    out = eng.run()
    ref, ref_stats = _jax_run(mode)
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=f"rid={rid}")
    stats = eng.stats()
    assert {k: stats[k] for k in COUNTERS} == {k: ref_stats[k] for k in COUNTERS}
    if mode in ("swap", "recompute"):
        assert stats["preemptions"] > 0
    if mode == "swap":
        assert stats["swap_preemptions"] > 0 and stats["swapped_bytes"] > 0
    if mode.startswith("spec"):
        assert stats["spec_proposed"] > 0 and stats["draft_steps"] > 0
    if eng.serve_cfg.paged:
        assert eng.slots.allocator.n_free == eng.slots.n_blocks
        for layer in eng.slots.cache:
            assert not any(t.any() for t in layer.values())


def test_enc_out_rows_are_each_requests_encoding():
    """After admission a slot's row of ``enc_out`` is ``encode`` of its
    request's frames, the drafter's row too when speculating; each
    encoder call's seconds are in ``encode_times``."""
    m = _model()
    eng = ContinuousBatchingEngine(
        m["cfg"], m["params"],
        ServeConfig(max_slots=2, max_seq=MAX_SEQ, prefill_chunk=4, block_size=4, spec_k=2),
        device="cpu",
    )
    reqs = poisson_workload(m["cfg"], n_requests=2, arrival_rate=1e9, prompt_len=4, gen_len=3,
                            seed=1)
    for r in reqs:
        eng.submit(r)
    eng.step()
    for r in reqs:
        with torch.no_grad():
            want = tlm.encode(m["cfg"], m["params"], torch.from_numpy(r.frames)[None])[0]
        torch.testing.assert_close(eng.enc_out[r.slot], want, rtol=0, atol=0)
        torch.testing.assert_close(eng._draft_enc_out[r.slot], want, rtol=0, atol=0)
    assert len(eng.encode_times) == 2 * len(reqs) and min(eng.encode_times) > 0


def test_lockstep_with_frames_matches_jax():
    """The sampled lock-step oracle, wave by wave, over the workload's
    frames, is the JAX one's."""
    m = _model()
    kw = dict(SAMPLED, arrival_rate=1e9)
    reqs = poisson_workload(m["cfg"], uniform_prompts=True, **kw)
    jreqs = jax_poisson_workload(m["jcfg"], uniform_prompts=True, **kw)
    for wave, jwave in zip(lockstep_waves(reqs, 3), jax_lockstep_waves(jreqs, 3), strict=True):
        args = (np.stack([r.prompt for r in wave]), [r.max_new_tokens for r in wave])
        ours = generate_lockstep(m["cfg"], m["params"], *args, max_seq=MAX_SEQ,
                                 frames=np.stack([r.frames for r in wave]),
                                 sampling=[r.sampling for r in wave], device="cpu")
        ref = jax_generate_lockstep(m["jcfg"], m["jparams"], *args, max_seq=MAX_SEQ,
                                    frames=np.stack([r.frames for r in jwave]),
                                    sampling=[r.sampling for r in jwave])
        assert ours["steps"] == ref["steps"]
        for a, b in zip(ours["tokens"], ref["tokens"], strict=True):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="frames"):
        generate_lockstep(m["cfg"], m["params"], *args, max_seq=MAX_SEQ, device="cpu")
