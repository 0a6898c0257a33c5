"""The decoder-only families against the JAX package, on the CPU: the ssm
(mamba2-1.3b), moe (llama4-maverick, kimi-k2), hybrid (jamba-1.5-large)
and non-gated dense (nemotron-4-15b) archs, and the dense deepseek-67b and
mistral-large-123b.

Per arch: the config twin field for field with ``param_count``,
``period_pattern`` and ``stack_sites``, full width and reduced; reduced
(the JAX package's own cut, fp32), the launch table and ``decode_slots``'
logits and SSM states, paged and contiguous. Params are made by the JAX
package and converted (``params_from_jax``, heterogeneous periods
included). Training on four routes is ``test_torch_families_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.models import model as jlm
from repro.models import transformer as jtransformer
from repro_torch.configs.registry import ARCH_IDS, get_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm
from repro_torch.models import transformer as ttransformer

NEW_ARCHS = ("nemotron-4-15b", "deepseek-67b", "mistral-large-123b", "llama4-maverick-400b-a17b",
             "kimi-k2-1t-a32b", "mamba2-1.3b", "jamba-1.5-large-398b")
B, S = 2, 24  # S: one and a half SSM chunks of 16


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


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, cfg = jget(arch).reduced(), tget(arch).reduced()
        tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
        _MODELS[arch] = (jcfg, cfg, tree)
    return _MODELS[arch]


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
    """name -> array; slot j's stacked leaves split into ``layer_{i*plen+j}/...``."""
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


def _batch(cfg):
    return jpipe.TokenPipeline(jpipe.TokenPipelineConfig(cfg.vocab, S, B, seed=0)).batch_at(0)


# --- configs ----------------------------------------------------------


def test_registry_ports_every_decoder_arch():
    """The port's registry holds the JAX registry's arch list, in its
    order: the decoder-only archs and the encoder-decoder and VLM ones."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert set(NEW_ARCHS + ("qwen2.5-3b", "whisper-large-v3", "paligemma-3b")) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert tget(arch).name == jget(arch).name


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_twins_jax(arch, reduce):
    jcfg, cfg = jget(arch), tget(arch)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("padded_vocab", "is_moe", "is_ssm", "d_inner", "n_ssm_heads"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert [dataclasses.astuple(s) for s in ttransformer.period_pattern(cfg)] == [
        dataclasses.astuple(s) for s in jtransformer.period_pattern(jcfg)]
    assert ttransformer.n_periods(cfg) == jtransformer.n_periods(jcfg)
    assert tlm.site_names(cfg) == jlm.site_names(jcfg)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_kernel_launch_table(arch, monkeypatch):
    """``kernel_launches_per_step`` counts a launch a product a site (an
    expert site: a launch a product an expert), and one reduced step on
    the ``matmul`` route calls the kernel exactly that often."""
    _, cfg, tree = _model(arch)
    pal = _routes(tpolicy)["matmul"]
    sites = tlm.site_names(cfg)[0]
    per = {s: cfg.n_experts if s.split("/", 1)[1] in ("moe/gate", "moe/up", "moe/down") else 1
           for s in sites}
    assert tlm.kernel_launches_per_step(cfg, pal) == {
        "matmul": 2 * sum(per.values()), "dx_gathered": 0, "dw_gathered": 0}
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, batch, pal), params)
    assert len(calls) == tlm.kernel_launches_per_step(cfg, pal)["matmul"]


def test_full_width_launch_tables():
    """The main paths' counts: mamba2-1.3b's 48 layers of 2 SSM sites, 2
    products each; kimi-k2's routed experts launch per expert."""
    pal = _routes(tpolicy)["matmul"]
    assert tlm.kernel_launches_per_step(tget("mamba2-1.3b"), pal)["matmul"] == 192
    assert tlm.kernel_launches_per_step(tget("kimi-k2-1t-a32b"), pal)["matmul"] == 61 * (
        2 * (4 + 3 * 384 + 3))


# --- decode -----------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_slots_match_jax(arch, paged):
    """Two mixed steps (a prefill chunk, a mid-cache chunk, a decode
    token, an idle slot; then a decode token each) from empty caches: the
    logits at each slot's last token at 1e-4 (1e-5 for attention-free
    mamba2), and every SSM layer's state at 1e-5."""
    jcfg, cfg, tree = _model(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    b, c, bs, nb = 4, 6, 4, 4
    rng = np.random.default_rng(1)
    if paged:
        jcache = jlm.init_paged_cache(jcfg, b, b * nb, bs, jnp.float32)
        cache = tlm.init_paged_cache(cfg, b * nb, bs, torch.float32, "cpu", batch=b)
        tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
        tkw = dict(block_tables=torch.from_numpy(tables), paged_kernel=True)
        jkw = dict(block_tables=jnp.asarray(tables))
    else:
        jcache = jlm.init_cache(jcfg, b, nb * bs, jnp.float32)
        cache = tlm.init_cache(cfg, b, nb * bs, torch.float32, "cpu")
        tkw, jkw = {}, {}
    pos = np.array([0, 5, 9, 3], np.int32)
    steps = ((c, np.array([6, 4, 1, 0], np.int32)), (1, np.array([1, 1, 1, 0], np.int32)))
    for width, count in steps:
        toks = rng.integers(0, cfg.vocab, (b, width)).astype(np.int32)
        lj, jcache = jlm.decode_slots(jcfg, jp, jnp.asarray(toks), jcache, jnp.asarray(pos),
                                      jnp.asarray(count), **jkw)
        lt, cache = tlm.decode_slots(cfg, params, torch.from_numpy(toks), cache,
                                     torch.from_numpy(pos), torch.from_numpy(count), **tkw)
        live = count > 0
        assert _rel(lt.numpy()[live, : cfg.vocab], np.asarray(lj)[live, : cfg.vocab]) <= (
            1e-5 if arch == "mamba2-1.3b" else 1e-4)
        pos = pos + count
    plen = len(jtransformer.period_pattern(jcfg))
    for li, layer in enumerate(cache):
        if "state" in layer:
            ref = np.asarray(jcache[li % plen]["state"])[li // plen]
            assert _rel(layer["state"].numpy(), ref) <= 1e-5, li
        else:
            assert "conv" not in layer
