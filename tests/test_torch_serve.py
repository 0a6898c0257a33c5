"""The port's serving path against the JAX package's, on the CPU.

Reduced qwen2.5-3b (2 layers, d 128, fp32). Params are made by the JAX
package and converted (``params_from_jax``); cache contents and tokens
are made with numpy from a seed and handed to both packages. The port
runs both attention routes: the kernel route takes the kernel's plain
version on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jlm
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tlm
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeConfig
from repro_torch.serve import poisson_workload

ARCH = "qwen2.5-3b"
MAX_SEQ = 24
ROUTES = {"gather": False, "kernel": True}

# the two workloads of tests/test_serve.py this file holds the port to:
# 6 staggered ragged requests through 2 slots, and a pool too small for
# the working set, which forces recompute preemption
WORKLOADS = {
    "staggered": (
        dict(n_requests=6, arrival_rate=0.7, prompt_len=(3, 7), gen_len=(3, 9), seed=42),
        dict(max_slots=2, block_size=4, n_blocks=8),
    ),
    "preempting": (
        dict(n_requests=6, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(6, 12), seed=5),
        dict(max_slots=3, block_size=4, n_blocks=7),
    ),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, tlm.params_from_jax(cfg, tree, device="cpu")


@pytest.mark.parametrize("reduce", [False, True])
def test_config_twins_jax(reduce):
    """Every field of the port's config equals the JAX config's field of
    the same name, at full width and reduced."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_unported_arch_raises(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_config(arch)


def test_params_from_jax_round_trip(model):
    _, cfg, _, tree, params = model
    np.testing.assert_array_equal(params["embed"]["table"].numpy(), tree["embed"]["table"])
    np.testing.assert_array_equal(
        params["final_norm"]["scale"].numpy(), tree["final_norm"]["scale"]
    )
    slot = tree["stack"]["slots"][0]
    assert len(params["stack"]["layers"]) == cfg.n_layers
    for li, layer in enumerate(params["stack"]["layers"]):
        for proj in ("q", "k", "v", "o"):
            for leaf, arr in slot["attn"][proj].items():
                np.testing.assert_array_equal(layer["attn"][proj][leaf].numpy(), arr[li])
        for proj in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                layer["mlp"][proj]["w"].numpy(), slot["mlp"][proj]["w"][li]
            )
        for norm in ("norm1", "norm2"):
            np.testing.assert_array_equal(layer[norm]["scale"].numpy(), slot[norm]["scale"][li])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_slots_matches_jax(model, route):
    """One mixed step: a prefill chunk from 0, a mid-page prefill, a
    decode token deep in the cache and an idle slot, over pools already
    holding history. Logits of the live rows and the pools after the
    writes must match JAX's (rtol=atol=1e-4: fp32, summation order)."""
    jcfg, cfg, jparams, _, params = model
    rng = np.random.default_rng(3)
    b, c, bs_pg, nb, n_pages = 4, 4, 4, 6, 26
    kv, hd, n_l = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    kp = rng.standard_normal((n_l, n_pages, bs_pg, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_l, n_pages, bs_pg, kv, hd)).astype(np.float32)
    tables = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, (b, c)).astype(np.int32)
    slot_pos = np.asarray([0, 6, 21, 3], np.int32)
    count = np.asarray([4, 3, 1, 0], np.int32)

    jcache = ({"k": jnp.asarray(kp), "v": jnp.asarray(vp)},)
    jlogits, jnew = jlm.decode_slots(
        jcfg, jparams, jnp.asarray(tokens), jcache, jnp.asarray(slot_pos),
        jnp.asarray(count), block_tables=jnp.asarray(tables),
        paged_kernel=ROUTES[route],
    )
    # the port's pools end in the sink page, where the idle tokens go
    sink = np.zeros((1, bs_pg, kv, hd), np.float32)
    tcache = [
        {"k": torch.from_numpy(np.concatenate([kp[li], sink])),
         "v": torch.from_numpy(np.concatenate([vp[li], sink]))}
        for li in range(n_l)
    ]
    tlogits, tnew = tlm.decode_slots(
        cfg, params, torch.from_numpy(tokens), tcache, torch.from_numpy(slot_pos),
        torch.from_numpy(count), block_tables=torch.from_numpy(tables),
        paged_kernel=ROUTES[route],
    )
    assert tlogits.dtype == torch.float32
    assert tlogits.shape == (b, cfg.padded_vocab)
    live = count > 0
    np.testing.assert_allclose(
        tlogits.numpy()[live], np.asarray(jlogits)[live], rtol=1e-4, atol=1e-4
    )
    for li in range(n_l):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                tnew[li][leaf][:n_pages].numpy(), np.asarray(jnew[0][leaf][li]),
                rtol=1e-4, atol=1e-4, err_msg=f"layer {li} {leaf}",
            )


def test_poisson_workload_matches_jax(model):
    jcfg, cfg = model[0], model[1]
    for kw, _ in WORKLOADS.values():
        ours = poisson_workload(cfg, **kw)
        ref = jax_poisson_workload(jcfg, **kw)
        assert len(ours) == len(ref)
        for a, r in zip(ours, ref, strict=True):
            assert (a.rid, a.arrival, a.max_new_tokens) == (r.rid, r.arrival, r.max_new_tokens)
            np.testing.assert_array_equal(a.prompt, r.prompt)


@pytest.fixture(scope="module")
def jax_streams(model):
    """Greedy streams of the JAX paged engine (gather route) per workload."""
    jcfg, _, jparams, _, _ = model
    out = {}
    for name, (wkw, skw) in WORKLOADS.items():
        eng = JaxEngine(
            jcfg, jparams, JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw)
        )
        for r in jax_poisson_workload(jcfg, **wkw):
            eng.submit(r)
        out[name] = (eng.run(), eng.preemptions, eng.compute_steps)
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_streams_match_jax(model, jax_streams, workload, route):
    """Token for token equal to the JAX paged engine, with the same
    preemptions and step count; every freed page is zero afterwards."""
    _, cfg, _, _, params = model
    wkw, skw = WORKLOADS[workload]
    eng = ContinuousBatchingEngine(
        cfg, params,
        ServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, attn_kernel=ROUTES[route], **skw),
        device="cpu",
    )
    for r in poisson_workload(cfg, **wkw):
        eng.submit(r)
    out = eng.run()
    ref, ref_preempt, ref_steps = jax_streams[workload]
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=f"rid={rid}")
    assert eng.preemptions == ref_preempt
    assert eng.compute_steps == ref_steps
    if workload == "preempting":
        assert eng.preemptions > 0
    assert eng.slots.allocator.n_free == eng.slots.n_blocks
    for layer in eng.slots.cache:
        assert not layer["k"].any() and not layer["v"].any()


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_engine_refuses_unported_families(family):
    """The encoder-decoder and VLM families are ported: an engine over the
    reduced whisper-large-v3 / paligemma-3b builds, paged and contiguous,
    and its first step admits a request (encoding its frames) and emits
    its first token."""
    arch = {"encdec": "whisper-large-v3", "vlm": "paligemma-3b"}[family]
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    params = tlm.init_params(cfg, 0, device="cpu")
    for skw in (dict(block_size=4), {}):
        eng = ContinuousBatchingEngine(
            cfg, params, ServeConfig(max_slots=2, max_seq=MAX_SEQ + cfg.n_patches, **skw),
            device="cpu",
        )
        (req,) = poisson_workload(cfg, n_requests=1, prompt_len=4, gen_len=3, seed=0)
        eng.submit(req)
        events = eng.step()
        assert [e.rid for e in events] == [0] and 0 <= events[0].token < cfg.vocab
        assert (eng.enc_out is not None) == (family == "encdec")


@pytest.mark.parametrize("mesh", [("--data-mesh", "2"), ("--model-mesh", "4")])
def test_cli_refuses_meshes(mesh):
    """No mesh is refused here any more: a data mesh (the slots split over
    it, the page pool replicated) and a model mesh that does not divide
    the reduced config's 2 KV heads (each of the 4 ranks caches the KV
    head its q head reads) serve, and a short run of each prints the
    one-device CLI's tokens (the JAX engine's on 2x1 and 2x2:
    ``tests/test_torch_mesh_data_serve.py``)."""
    short = ["--reduced", "--device", "cpu", "--batch", "2", "--requests", "3", "--prompt-len",
             "8", "--gen", "6", "--prefill-chunk", "4", "--block-size", "4"]
    one = tserve.run(tserve.build_parser().parse_args(short))["generated"]
    got = tserve.run(tserve.build_parser().parse_args(short + list(mesh)), timeout_s=120)
    assert got["generated"].tolist() == one.tolist()


def test_engine_defaults_to_the_kernel_route(model, monkeypatch):
    """An engine built without naming a route attends through the kernel
    wrapper, once per layer per step; the gather route is opted into."""
    from repro_torch.kernels import ops as kops

    _, cfg, _, _, params = model
    calls = []
    real = kops.paged_attention
    monkeypatch.setattr(kops, "paged_attention", lambda *a: calls.append(1) or real(*a))
    eng = ContinuousBatchingEngine(
        cfg, params, ServeConfig(max_slots=2, max_seq=MAX_SEQ, block_size=4), device="cpu",
    )
    eng.submit(Request(rid=0, prompt=np.arange(3), max_new_tokens=2))
    eng.run()
    assert eng.compute_steps > 0
    assert len(calls) == cfg.n_layers * eng.compute_steps


def test_cli_runs_on_cpu_and_routes_agree():
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--requests", "3",
            "--prompt-len", "5", "--gen", "4", "--block-size", "4",
            "--prefill-chunk", "4", "--arrival-rate", "0.5"]
    ap = tserve.build_parser()
    kernel = tserve.run(ap.parse_args(argv))
    gather = tserve.run(ap.parse_args([*argv, "--no-attn-kernel"]))
    assert kernel["generated"].shape == (3, 4)
    np.testing.assert_array_equal(kernel["generated"], gather["generated"])


def test_cli_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fall-back question does not arise")
    args = tserve.build_parser().parse_args(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.run(args)
