"""The rest of serving against the JAX package, on the CPU: sampling, swap
and auto preemption, speculative decoding, the contiguous cache and the
lock-step oracle.

Reduced qwen2.5-3b (2 layers, d 128, fp32). Params are made by the JAX
package and converted (``params_from_jax``); workloads come from the same
seeds in both packages. Every mode's token streams and counters must be
the JAX engine's exactly: the port draws ``jax.random``'s bits
(``repro_torch.core.prng``). The JAX runs are made once per module.
Then the port's own twins of ``tests/test_serve.py``'s properties.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jlm
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro.serve import lockstep_waves as jax_lockstep_waves
from repro.serve import longtail_workload as jax_longtail_workload
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm
from repro_torch.serve import (
    PREFILL,
    WAITING,
    ContinuousBatchingEngine,
    PagedCacheManager,
    Request,
    SamplingParams,
    Scheduler,
    ServeConfig,
    generate_lockstep,
    generate_reference,
    lockstep_waves,
    longtail_workload,
    poisson_workload,
)

ARCH = "qwen2.5-3b"
MAX_SEQ = 24
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps", "swapped_bytes")
SAMPLED = dict(n_requests=6, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(6, 12), seed=5,
               temperature=0.8, top_k=50, top_p=0.95)
# mode -> (workload, ServeConfig fields, drafter layers or None)
MODES = {
    "sampled-paged": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18), None),
    "contiguous": (SAMPLED, dict(max_slots=3), None),
    "swap": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=7, preempt="swap"), None),
    "auto": ("mixed", dict(max_slots=3, block_size=4, n_blocks=7, preempt="auto"), None),
    "spec-self": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=7, spec_k=2), None),
    "spec-drafter": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18, spec_k=2), 1),
    "spec-contiguous": (SAMPLED, dict(max_slots=3, spec_k=2), 1),
}
# the port's runs: (mode, attention route); "-" where the cache is contiguous
RUNS = [
    ("sampled-paged", "kernel"), ("sampled-paged", "gather"), ("contiguous", "-"),
    ("swap", "kernel"), ("swap", "gather"), ("auto", "kernel"),
    ("spec-self", "kernel"), ("spec-self", "gather"), ("spec-drafter", "kernel"),
    ("spec-contiguous", "-"),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: torch's and XLA's CPU pools contend in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = tlm.params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jdcfg = jcfg.reduced(n_layers=1)
    dcfg = cfg.reduced(n_layers=1)
    jdparams = jlm.init_params(jdcfg, jax.random.PRNGKey(1))
    dparams = tlm.params_from_jax(dcfg, jax.tree.map(np.asarray, jdparams), device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jdcfg=jdcfg, dcfg=dcfg, jdparams=jdparams, dparams=dparams)


def _workload(cfg, make, kind):
    """The mode's requests; "mixed" makes every other one greedy, so
    ``auto`` has both strategies to pick."""
    if kind != "mixed":
        return make(cfg, **kind)
    reqs = make(cfg, **SAMPLED)
    for r in reqs[::2]:
        r.sampling = type(r.sampling)()
    return reqs


@pytest.fixture(scope="module")
def jax_runs(model):
    """Streams and counters of the JAX engine in every mode (gather
    route on the paged cache), made once."""
    out = {}
    for mode, (kind, skw, draft) in MODES.items():
        kw = {}
        if draft:
            kw = dict(draft_cfg=model["jdcfg"], draft_params=model["jdparams"])
        eng = JaxEngine(model["jcfg"], model["jparams"],
                        JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw), **kw)
        for r in _workload(model["jcfg"], jax_poisson_workload, kind):
            eng.submit(r)
        out[mode] = (eng.run(), eng.stats())
    return out


@pytest.mark.parametrize("mode,route", RUNS, ids=[f"{m}-{r}" for m, r in RUNS])
def test_engine_streams_and_counters_match_jax(model, jax_runs, mode, route):
    """Token for token the JAX engine's streams, with its step count,
    preemptions by strategy, swap traffic, proposals, acceptances and
    drafter steps; every page back in the pool and zero at the end."""
    kind, skw, draft = MODES[mode]
    kw = {}
    if draft:
        kw = dict(draft_cfg=model["dcfg"], draft_params=model["dparams"])
    if route != "-":
        skw = dict(skw, attn_kernel=route == "kernel")
    eng = ContinuousBatchingEngine(
        model["cfg"], model["params"], ServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw),
        device="cpu", **kw,
    )
    for r in _workload(model["cfg"], poisson_workload, kind):
        eng.submit(r)
    out = eng.run()
    ref, ref_stats = jax_runs[mode]
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=f"rid={rid}")
    stats = eng.stats()
    assert {k: stats[k] for k in COUNTERS} == {k: ref_stats[k] for k in COUNTERS}
    assert set(stats) == set(ref_stats)
    if mode in ("swap", "spec-self"):
        assert stats["swap_preemptions"] > 0 and stats["swapped_bytes"] > 0
    if mode == "auto":
        assert stats["swap_preemptions"] > 0 and stats["recompute_preemptions"] > 0
    if mode.startswith("spec"):
        assert stats["spec_proposed"] > 0 and stats["draft_steps"] > 0
    if eng.serve_cfg.paged:
        assert eng.slots.allocator.n_free == eng.slots.n_blocks
        for layer in eng.slots.cache:
            assert not layer["k"].any() and not layer["v"].any()


def test_lockstep_matches_jax(model):
    """The sampled lock-step oracle, wave by wave, is the JAX one's."""
    kw = dict(SAMPLED, arrival_rate=1e9)
    reqs = poisson_workload(model["cfg"], uniform_prompts=True, **kw)
    jreqs = jax_poisson_workload(model["jcfg"], uniform_prompts=True, **kw)
    for wave, jwave in zip(lockstep_waves(reqs, 3), jax_lockstep_waves(jreqs, 3), strict=True):
        args = (np.stack([r.prompt for r in wave]), [r.max_new_tokens for r in wave])
        ours = generate_lockstep(model["cfg"], model["params"], *args, max_seq=MAX_SEQ,
                                 sampling=[r.sampling for r in wave], device="cpu")
        ref = jax_generate_lockstep(model["jcfg"], model["jparams"], *args, max_seq=MAX_SEQ,
                                    sampling=[r.sampling for r in jwave])
        assert ours["steps"] == ref["steps"]
        for a, b in zip(ours["tokens"], ref["tokens"], strict=True):
            np.testing.assert_array_equal(a, b)


def test_longtail_workload_matches_jax(model):
    kw = dict(n_requests=10, arrival_rate=0.8, seed=3, tail_frac=0.3)
    for a, r in zip(longtail_workload(model["cfg"], **kw),
                    jax_longtail_workload(model["jcfg"], **kw), strict=True):
        assert (a.rid, a.arrival, a.max_new_tokens) == (r.rid, r.arrival, r.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, r.prompt)


# ----------------------------------------------------------------------
# the port's own twins of tests/test_serve.py's properties
# ----------------------------------------------------------------------


def _run(model, reqs, *, slots=2, draft=False, **skw):
    kw = dict(draft_cfg=model["dcfg"], draft_params=model["dparams"]) if draft else {}
    eng = ContinuousBatchingEngine(
        model["cfg"], model["params"],
        ServeConfig(max_slots=slots, max_seq=MAX_SEQ, prefill_chunk=4, **skw),
        device="cpu", **kw,
    )
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


def _reference(model, r):
    return generate_reference(model["cfg"], model["params"], r.prompt, r.max_new_tokens,
                              max_seq=MAX_SEQ, sampling=r.sampling, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("cache", ["paged", "contiguous"])
def test_engine_equals_generate_reference(model, cache, temperature):
    """Staggered ragged requests through 2 slots: each request's stream is
    its single-request lock-step stream, greedy and sampled."""
    reqs = poisson_workload(model["cfg"], n_requests=4, arrival_rate=0.7, prompt_len=(3, 7),
                            gen_len=(3, 9), seed=42, temperature=temperature, top_k=16,
                            top_p=0.9)
    skw = dict(block_size=4, n_blocks=8) if cache == "paged" else {}
    _, out = _run(model, reqs, **skw)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], _reference(model, r), err_msg=f"rid={r.rid}")


def test_greedy_swap_and_recompute_agree(model):
    def wl():
        return poisson_workload(model["cfg"], n_requests=6, arrival_rate=2.0, prompt_len=(3, 7),
                                gen_len=(6, 12), seed=5)

    swap, swap_out = _run(model, wl(), slots=3, block_size=4, n_blocks=7, preempt="swap")
    rec, rec_out = _run(model, wl(), slots=3, block_size=4, n_blocks=7, preempt="recompute")
    assert swap.swap_preemptions > 0 and swap.recompute_preemptions == 0
    assert rec.recompute_preemptions > 0 and rec.swap_preemptions == 0
    for rid in swap_out:
        np.testing.assert_array_equal(swap_out[rid], rec_out[rid])


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_mid_prefill_preemption_keeps_parity(model, mode):
    """A request evicted half-way through its prefill: swap resumes it
    there, recompute restarts it; both land on the oracle stream."""
    sp = SamplingParams(temperature=0.8, top_k=32, seed=7) if mode == "swap" else SamplingParams()
    req = Request(rid=0, prompt=np.arange(10, dtype=np.int32) % model["cfg"].vocab,
                  max_new_tokens=5, sampling=sp)
    eng = ContinuousBatchingEngine(
        model["cfg"], model["params"],
        ServeConfig(max_slots=2, max_seq=MAX_SEQ, prefill_chunk=4, block_size=4, preempt=mode),
        device="cpu",
    )
    eng.submit(req)
    eng.step()  # 4 of 10 prompt tokens in
    assert req.state == PREFILL and req.prefilled == 4
    eng._preempt(req.slot)
    assert req.preemptions == 1 and req.state == WAITING
    assert (req.swap is not None and req.prefilled == 4) if mode == "swap" else req.prefilled == 0
    np.testing.assert_array_equal(eng.run()[0], _reference(model, req))


def _dirty_slot(model, mgr, slot, n):
    """Real model writes of ``n`` tokens into ``slot``'s pages."""
    toks = torch.from_numpy(np.arange(n, dtype=np.int32)[None].repeat(mgr.n_slots, 0))
    count = np.zeros((mgr.n_slots,), np.int32)
    count[slot] = n
    tlm.decode_slots(model["cfg"], model["params"], toks, mgr.cache,
                     torch.zeros((mgr.n_slots,), dtype=torch.int32), torch.from_numpy(count),
                     block_tables=torch.from_numpy(mgr.block_tables.copy()))
    mgr.pos[slot] = n


def test_swap_round_trip_restores_the_device_state(model):
    """Swap out (slot and pages freed, pages zeroed), swap back into a
    fresh slot at other pages: the bundle lands there bit for bit, with
    the position."""
    mgr = PagedCacheManager(model["cfg"], 2, 16, block_size=4, n_blocks=6, device="cpu")
    slot = mgr.alloc()
    assert mgr.ensure(slot, 7)  # 2 pages
    pages = mgr.block_tables[slot, :2].tolist()
    _dirty_slot(model, mgr, slot, 7)
    before = [t.clone() for p in pages for t in mgr.page_view(p)]
    assert any(t.any() for t in before)
    swapped = mgr.swap_out(slot)
    assert (swapped.pos, swapped.n_pages) == (7, 2)
    assert swapped.nbytes == 2 * model["cfg"].n_layers * 2 * 4 * model["cfg"].n_kv_heads * 32 * 4
    assert mgr.n_free == 2
    for p in pages:  # zero on free holds for swapped-out pages too
        assert not any(t.any() for t in mgr.page_view(p))
    with pytest.raises(ValueError):
        mgr.swap_out(slot)
    other = mgr.alloc()
    assert mgr.ensure(other, 4)  # take the lowest page, so the bundle moves
    slot2 = mgr.alloc()
    assert mgr.swap_in(slot2, swapped)
    assert int(mgr.pos[slot2]) == 7
    new_pages = mgr.block_tables[slot2, :2].tolist()
    assert new_pages != pages
    after = [t for p in new_pages for t in mgr.page_view(p)]
    for a, b in zip(after, before, strict=True):
        assert torch.equal(a, b)
    restored = tlm.swap_out_slot(mgr.cache, slot2, new_pages)
    for layer, saved in zip(restored, swapped.data, strict=True):
        for k in ("k", "v"):
            assert torch.equal(layer[k], saved[k])


def test_swap_in_fails_cleanly_when_the_pool_is_full(model):
    mgr = PagedCacheManager(model["cfg"], 3, 16, block_size=4, n_blocks=4, device="cpu")
    slot = mgr.alloc()
    assert mgr.ensure(slot, 8)  # 2 pages
    mgr.pos[slot] = 8
    swapped = mgr.swap_out(slot)
    hog = mgr.alloc()
    assert mgr.ensure(hog, 13)  # the whole pool
    back = mgr.alloc()
    assert not mgr.swap_in(back, swapped)  # reported, not raised
    assert int(mgr.pos[back]) == 0 and int(mgr.n_table_blocks[back]) == 0
    assert mgr.n_free_blocks == 0


def test_trim_frees_and_zeroes_pages(model):
    mgr = PagedCacheManager(model["cfg"], 2, 16, block_size=4, n_blocks=6, device="cpu")
    slot = mgr.alloc()
    assert mgr.ensure(slot, 11)  # 3 pages
    dropped = int(mgr.block_tables[slot, 2])
    for layer in mgr.cache:
        layer["k"].fill_(1.0)
        layer["v"].fill_(1.0)
    mgr.trim(slot, 6)  # keep 2 pages
    assert int(mgr.n_table_blocks[slot]) == 2 and mgr.n_free_blocks == 4
    assert not any(t.any() for t in mgr.page_view(dropped))
    assert all(t.all() for t in mgr.page_view(int(mgr.block_tables[slot, 0])))
    mgr.trim(slot, 8)  # still needs both: a no-op
    assert int(mgr.n_table_blocks[slot]) == 2


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_self_draft_accepts_every_proposal(model, temperature):
    """Drafter = target: every proposal is the token the target emits,
    so acceptance is 1.0, the stream is the plain engine's, in fewer
    target steps."""
    def wl():
        return poisson_workload(model["cfg"], n_requests=5, arrival_rate=0.7,
                                prompt_len=(3, 6), gen_len=(6, 12), seed=11,
                                temperature=temperature, top_k=16, top_p=0.9)

    spec, spec_out = _run(model, wl(), spec_k=3, block_size=4)
    base, base_out = _run(model, wl(), block_size=4)
    st = spec.stats()
    assert st["spec_proposed"] > 0 and st["acceptance_rate"] == 1.0 and st["draft_steps"] > 0
    assert st["compute_steps"] < base.stats()["compute_steps"]
    for rid in base_out:
        np.testing.assert_array_equal(spec_out[rid], base_out[rid])


@pytest.mark.parametrize("cache", ["paged", "contiguous"])
def test_rejected_drafts_are_fenced(model, cache):
    """A drafter whose every proposal is token 0 (its final norm zeroed:
    all-zero logits, argmax 0) has them rejected; its in-place cache then
    holds the rejected proposals' K/V past its synced position, and the
    target's rolled-back pages or rows hold them past the committed one.
    The stream is still the plain engine's."""
    dparams = dict(model["params"], final_norm={"scale": torch.zeros(model["cfg"].d_model)})

    def wl():
        return poisson_workload(model["cfg"], n_requests=4, arrival_rate=1.0,
                                prompt_len=(3, 6), gen_len=(6, 10), seed=13)

    skw = dict(block_size=4) if cache == "paged" else {}
    eng = ContinuousBatchingEngine(
        model["cfg"], model["params"],
        ServeConfig(max_slots=2, max_seq=MAX_SEQ, prefill_chunk=4, spec_k=3, **skw),
        device="cpu", draft_params=dparams,
    )
    for r in wl():
        eng.submit(r)
    out = eng.run()
    st = eng.stats()
    assert st["spec_proposed"] > 0 and st["spec_accepted"] < st["spec_proposed"] // 4
    _, base_out = _run(model, wl(), **skw)
    for rid in base_out:
        np.testing.assert_array_equal(out[rid], base_out[rid])


def test_width_ladder_and_no_spec(model):
    """``spec_k + 1`` in the width ladder gives verify chunks their own
    width; a ``no_spec`` request decodes one token a step in the same
    engine and never contributes proposals; both stay on the oracle."""
    reqs = poisson_workload(model["cfg"], n_requests=4, arrival_rate=1.0, prompt_len=(3, 6),
                            gen_len=(4, 9), seed=31)
    reqs[0].no_spec = True
    eng, out = _run(model, reqs, spec_k=2, decode_widths=(1, 3), block_size=4)
    assert eng.spec_proposed > 0
    assert eng.serve_cfg.widths == (1, 3, 4)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], _reference(model, r), err_msg=f"rid={r.rid}")
    sched = Scheduler(ServeConfig(max_slots=2, max_seq=MAX_SEQ, prefill_chunk=4, spec_k=2))
    a = Request(rid=0, prompt=np.arange(3), max_new_tokens=8)
    b = Request(rid=1, prompt=np.arange(3), max_new_tokens=8, no_spec=True)
    c = Request(rid=2, prompt=np.arange(3), max_new_tokens=8)
    for r in (a, b, c):
        r.prefilled, r.generated = 3, [1]
    c.generated = [1] * 7  # one token left: nothing to propose
    assert sched.plan({0: a, 1: b, 2: c}) == {0: 3, 1: 1, 2: 1}


def test_kernel_route_launches_once_a_layer_a_verify_step(model, monkeypatch):
    """A speculative paged engine attends through the kernel wrapper at
    every target step, prefill and verify alike; the drafter (contiguous)
    never calls it."""
    from repro_torch.kernels import ops as kops

    calls = []
    real = kops.paged_attention
    monkeypatch.setattr(kops, "paged_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    reqs = poisson_workload(model["cfg"], n_requests=3, arrival_rate=1.0, prompt_len=(3, 6),
                            gen_len=(5, 8), seed=2, temperature=0.7)
    eng, _ = _run(model, reqs, spec_k=2, decode_widths=(1, 3), block_size=4)
    assert len(calls) == model["cfg"].n_layers * eng.compute_steps
    assert any(shape[1] == 3 for shape in calls)  # verify chunks at their own width


@pytest.mark.parametrize("make,match", [
    (lambda: ServeConfig(max_slots=2, max_seq=32, attn_kernel=True), "attn_kernel"),
    (lambda: ServeConfig(max_slots=2, max_seq=32, prefill_chunk=4, spec_k=4), "spec_k"),
    (lambda: ServeConfig(max_slots=2, max_seq=32, spec_k=-1), "spec_k"),
    (lambda: ServeConfig(max_slots=2, max_seq=32, preempt="drop"), "preemption policy"),
    (lambda: ServeConfig(max_slots=2, max_seq=32, decode_widths=(1, 1)), "duplicates"),
    (lambda: ServeConfig(max_slots=2, max_seq=32, prefill_chunk=4, decode_widths=(8,)),
     "exceed"),
    (lambda: SamplingParams(top_k=tsteps.TOP_K_CAP + 1), "top_k"),
    (lambda: SamplingParams(temperature=-0.1), "temperature"),
    (lambda: SamplingParams(top_p=0.0), "top_p"),
])
def test_validation_errors(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_serve_config_resolves_the_kernel_by_cache():
    assert ServeConfig(max_slots=2, max_seq=32).attn_kernel is False
    assert ServeConfig(max_slots=2, max_seq=32, block_size=4).attn_kernel is True
    assert ServeConfig(max_slots=2, max_seq=32, block_size=4, attn_kernel=False).attn_kernel is False


def test_recompute_refuses_a_sampled_request_and_swap_takes_it():
    req = Request(rid=0, prompt=np.arange(4), max_new_tokens=3,
                  sampling=SamplingParams(temperature=0.7))
    with pytest.raises(RuntimeError, match="swap"):
        req.preempt()
    assert req.preemptions == 0
    req.preempt_swap(object())
    assert req.preemptions == 1 and req.state == WAITING


def test_engine_rejects_duplicate_and_oversized_requests(model):
    eng = ContinuousBatchingEngine(model["cfg"], model["params"],
                                   ServeConfig(max_slots=2, max_seq=MAX_SEQ), device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(3), max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(Request(rid=0, prompt=np.arange(3), max_new_tokens=2))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=1, prompt=np.arange(20), max_new_tokens=10))
    bad = dataclasses.replace(model["cfg"], vocab=256)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(model["cfg"], model["params"],
                                 ServeConfig(max_slots=2, max_seq=MAX_SEQ, spec_k=1),
                                 device="cpu", draft_cfg=bad, draft_params=model["params"])


def test_cli_engines_agree_and_return_jax_keys():
    """The CLI's three engines serve the same sampled requests with the
    same tokens (swap preemption, a 1-layer drafter on the paged one),
    and return the JAX CLI's result keys."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--requests", "4",
            "--prompt-len", "6", "--gen", "6", "--prefill-chunk", "4", "--block-size", "4",
            "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
    ap = tserve.build_parser()
    paged = tserve.run(ap.parse_args([*argv, "--n-blocks", "5", "--preempt", "swap",
                                      "--spec-k", "2", "--draft-layers", "1"]))
    cont = tserve.run(ap.parse_args([*argv, "--engine", "continuous"]))
    lock = tserve.run(ap.parse_args([*argv, "--engine", "lockstep"]))
    assert paged["generated"].shape == (4, 6)
    np.testing.assert_array_equal(paged["generated"], cont["generated"])
    np.testing.assert_array_equal(paged["generated"], lock["generated"])
    assert paged["swap_preemptions"] > 0 and paged["spec_proposed"] > 0
    jax_keys = {"generated", "steps", "prefill_s", "decode_s", "tokens_per_s", "tokens_per_step",
                "slot_utilization", "peak_concurrency", "preemptions", "swap_preemptions",
                "recompute_preemptions", "spec_proposed", "spec_accepted", "acceptance_rate",
                "draft_steps"}
    assert jax_keys <= set(paged) and jax_keys <= set(cont)
    assert {"generated", "steps", "prefill_s", "decode_s", "tokens_per_s",
            "slot_utilization"} <= set(lock)
