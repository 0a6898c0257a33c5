"""The VLM family (paligemma-3b) against the JAX package, on the CPU.

The config twin (full width and reduced); then, reduced (the JAX
package's own cut: 2 layers, 8 patches, fp32): the site list, the loss
and every gradient leaf of one training step with the patch prefix on
the dense, gather, ``matmul`` (its plain version here; the JAX package
runs its Pallas kernel in interpret mode) and mask routes, the launch
table, ``decode_slots`` over the paged and the contiguous cache, the
engine's greedy paged streams against the JAX engine's, and the serving
CLI's three engines. Params are made by the JAX package and converted
(``params_from_jax``); inputs are numpy draws from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import policy as jpolicy
from repro.models import model as jlm
from repro.models import transformer as jtransformer
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, poisson_workload

ARCH = "paligemma-3b"
ROUTES = ("dense", "gather", "matmul", "mask")
B, S = 2, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
        jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        _MODEL.update(jcfg=jcfg, cfg=cfg, tree=tree, jparams=jparams,
                      params=tlm.params_from_jax(cfg, tree, device="cpu"))
    return _MODEL


def _routes(policy):
    base = policy.paper_default(0.8)
    return {
        "dense": policy.SsPropPolicy(0.0),
        "gather": base,
        "matmul": dataclasses.replace(base, use_pallas=True),
        "mask": dataclasses.replace(base, mask_mode=True),
    }


def _flat(node, prefix=""):
    if isinstance(node, dict):
        return {k2: v2 for k in sorted(node) for k2, v2 in _flat(node[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: node}


def _named_jax(tree, cfg):
    out = {f"{k}/{p}": v for k in ("embed", "final_norm") for p, v in _flat(tree[k]).items()}
    plen = len(jtransformer.period_pattern(cfg))
    for j, slot in enumerate(tree["stack"]["slots"]):
        for p, v in _flat(slot).items():
            for i in range(cfg.n_layers // plen):
                out[f"layer_{i * plen + j}/{p}"] = np.asarray(v)[i]
    return out


def _named_port(tree):
    out = {f"{k}/{p}": v for k in ("embed", "final_norm") for p, v in _flat(tree[k]).items()}
    for li, layer in enumerate(tree["stack"]["layers"]):
        out.update({f"layer_{li}/{p}": v for p, v in _flat(layer).items()})
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "patches": rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32),
    }


# --- configs ----------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True])
def test_config_twins_jax(reduce):
    """Every field of the port's config equals the JAX config's, with
    ``param_count``, the layer pattern (a dense gated-gelu stack) and
    the site list, full width (18 layers, 8 query heads on one KV head
    of 256, 256 patches) and reduced (8 patches)."""
    jcfg, cfg = jget(ARCH), tget(ARCH)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.n_patches == (8 if reduce else 256)
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.param_count() == jcfg.param_count()
    assert [dataclasses.astuple(s) for s in ttransformer.period_pattern(cfg)] == [
        dataclasses.astuple(s) for s in jtransformer.period_pattern(jcfg)]
    assert tlm.site_names(cfg) == jlm.site_names(jcfg)


def test_params_from_jax_round_trip():
    m = _model()
    named_j, named_t = _named_jax(m["tree"], m["cfg"]), _named_port(m["params"])
    assert sorted(named_t) == sorted(named_j)
    for name, t in named_t.items():
        np.testing.assert_array_equal(t.numpy(), named_j[name], err_msg=name)


# --- training ---------------------------------------------------------


def test_forward_cuts_the_patch_positions():
    """The logits are the tokens' alone (``[B, S, V]``), and they move
    with the patches: each token attends to the prefix in front of it."""
    m = _model()
    batch = {k: torch.from_numpy(v) for k, v in _batch(m["cfg"]).items()}
    with torch.no_grad():
        logits, _ = tlm.forward(m["cfg"], m["params"], batch)
        other, _ = tlm.forward(m["cfg"], m["params"], dict(batch, patches=batch["patches"] + 1))
    assert logits.shape == (B, S, m["cfg"].padded_vocab)
    assert not torch.allclose(logits[:, 0], other[:, 0])


@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_every_grad_leaf_match_jax(route):
    """One step's loss and ``ce`` and every gradient leaf at relative L2
    <= 1e-4, the patches in front of the tokens (a token at index i sits
    at position ``n_patches + i``). The kept channels first: the port's
    recorded selection at every site equals the nonzero columns of the
    JAX package's dW."""
    m = _model()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jpol, tpol = _routes(jpolicy)[route], _routes(tpolicy)[route]
    batch = _batch(cfg)
    vag = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b, jpol), has_aux=True))
    (lj, mj), gj = vag(jax.tree.map(jnp.asarray, m["tree"]), jax.tree.map(jnp.asarray, batch))
    params = tlm.params_from_jax(cfg, m["tree"], device="cpu")
    site_of = {t.data_ptr(): name[:-2] for name, t in _named_port(params).items()
               if name.endswith("/w")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tbackward.record_selections() as log:
        (lt, mt), gt = tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, tb, tpol), params)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    assert abs(float(mt["ce"]) - float(mj["ce"])) <= 1e-4 * abs(float(mj["ce"]))
    named_j, named_t = _named_jax(jax.tree.map(np.asarray, gj), jcfg), _named_port(gt)
    assert sorted(named_t) == sorted(named_j)
    assert {site_of[ptr] for ptr, _ in log} == (
        set() if route == "dense" else set(tlm.site_names(cfg)[0]))
    for ptr, sel in log:
        name = site_of[ptr]
        cols = np.flatnonzero(np.abs(named_j[f"{name}/w"]).sum(0))
        np.testing.assert_array_equal(sel.idx.numpy(), cols, err_msg=name)
    for name, g in named_t.items():
        assert tuple(g.shape) == named_j[name].shape, name
        assert _rel(g.numpy(), named_j[name]) <= 1e-4, name


def test_kernel_launch_table(monkeypatch):
    """Two ``matmul`` launches a site, 7 sites a layer (the gated MLP): a
    reduced step on the ``matmul`` route calls the kernel exactly that
    often; 18 * 7 * 2 at full width."""
    m = _model()
    cfg = m["cfg"]
    pal = _routes(tpolicy)["matmul"]
    assert tlm.kernel_launches_per_step(cfg, pal)["matmul"] == 2 * 7 * cfg.n_layers
    assert tlm.kernel_launches_per_step(tget(ARCH), pal)["matmul"] == 2 * 7 * 18
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, batch, pal), m["params"])
    assert len(calls) == 2 * 7 * cfg.n_layers


# --- decode and serving ----------------------------------------------


@pytest.mark.parametrize("paged", [True, False])
def test_decode_slots_match_jax(paged):
    """Two mixed steps from empty caches over the gemma decoder (no patch
    prefix at decode, as in the JAX package): the logits at each slot's
    last token within a relative L2 of 1e-4; the JAX side's paged route
    runs its Pallas kernel (interpret mode)."""
    m = _model()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp = jax.tree.map(jnp.asarray, m["tree"])
    b, c, bs, nb = 4, 6, 4, 4
    rng = np.random.default_rng(1)
    if paged:
        jcache = jlm.init_paged_cache(jcfg, b, b * nb, bs, jnp.float32)
        cache = tlm.init_paged_cache(cfg, b * nb, bs, torch.float32, "cpu")
        tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
        tkw = dict(block_tables=torch.from_numpy(tables), paged_kernel=True)
        jkw = dict(block_tables=jnp.asarray(tables), paged_kernel=True)
    else:
        jcache = jlm.init_cache(jcfg, b, nb * bs, jnp.float32)
        cache = tlm.init_cache(cfg, b, nb * bs, torch.float32, "cpu")
        tkw, jkw = {}, {}
    pos = np.array([0, 5, 9, 3], np.int32)
    for width, count in ((c, np.array([6, 4, 1, 0], np.int32)),
                         (1, np.array([1, 1, 1, 0], np.int32))):
        toks = rng.integers(0, cfg.vocab, (b, width)).astype(np.int32)
        lj, jcache = jlm.decode_slots(jcfg, jp, jnp.asarray(toks), jcache, jnp.asarray(pos),
                                      jnp.asarray(count), **jkw)
        with torch.no_grad():
            lt, cache = tlm.decode_slots(cfg, m["params"], torch.from_numpy(toks), cache,
                                         torch.from_numpy(pos), torch.from_numpy(count), **tkw)
        live = count > 0
        assert _rel(lt.numpy()[live, : cfg.vocab], np.asarray(lj)[live, : cfg.vocab]) <= 1e-4
        pos = pos + count


def test_engine_greedy_paged_streams_match_jax():
    """Five greedy Poisson requests through three slots of the paged
    engine (kernel route; its plain version here): the JAX engine's
    streams token for token, its step count, every page back and zero."""
    m = _model()
    kw = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=6)
    skw = dict(max_slots=3, max_seq=24 + m["cfg"].n_patches, prefill_chunk=4, block_size=4,
               n_blocks=18)
    jeng = JaxEngine(m["jcfg"], m["jparams"], JaxServeConfig(**skw))
    for r in jax_poisson_workload(m["jcfg"], **kw):
        jeng.submit(r)
    ref = jeng.run()
    eng = ContinuousBatchingEngine(m["cfg"], m["params"], ServeConfig(**skw), device="cpu")
    for r in poisson_workload(m["cfg"], **kw):
        eng.submit(r)
    out = eng.run()
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=f"rid={rid}")
    assert eng.compute_steps == jeng.stats()["compute_steps"]
    assert eng.slots.allocator.n_free == eng.slots.n_blocks
    assert not any(t.any() for layer in eng.slots.cache for t in layer.values())


def test_cli_engines_agree():
    """``--arch paligemma-3b --reduced --device cpu``, sampled: the paged
    engine (kernel route; with a small pool, swap and a 1-layer drafter
    too), the contiguous one and the lock-step waves give the same
    tokens; ``max_seq`` leaves room for the patches, as the JAX CLI's."""
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--requests", "4",
            "--prompt-len", "6", "--gen", "6", "--prefill-chunk", "4", "--block-size", "4",
            "--arrival-rate", "0.5", "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
    ap = tserve.build_parser()
    outs = {
        "paged": tserve.run(ap.parse_args(base)),
        "swap-spec": tserve.run(ap.parse_args([*base, "--n-blocks", "5", "--preempt", "swap",
                                               "--spec-k", "2", "--draft-layers", "1"])),
        "continuous": tserve.run(ap.parse_args([*base, "--engine", "continuous"])),
        "lockstep": tserve.run(ap.parse_args([*base, "--engine", "lockstep"])),
    }
    ref = outs["paged"]["generated"]
    assert ref.shape == (4, 6)
    for name, out in outs.items():
        np.testing.assert_array_equal(out["generated"], ref, err_msg=name)
    assert outs["swap-spec"]["swap_preemptions"] > 0 and outs["swap-spec"]["spec_proposed"] > 0
