"""Training the dense and ssm archs against the JAX package, on the CPU.

Per arch, reduced (the JAX package's own cut, fp32): the loss,
``ce``, ``aux`` and every gradient leaf of one step on the dense, gather,
``matmul`` (its plain version here; the JAX package runs its Pallas
kernel in interpret mode) and mask routes at a relative L2 of 1e-4, the
kept channels compared first (a routed expert's own). Params are made by
the JAX package and converted (``params_from_jax``, heterogeneous
periods included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import policy as jpolicy
from repro.data import pipeline as jpipe
from repro.models import model as jlm
from repro.models import transformer as jtransformer
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm

pytestmark = pytest.mark.slow

# the dense and ssm archs; the moe and hybrid ones are test_torch_families_moe_train.py's
ARCHS = ("nemotron-4-15b", "deepseek-67b", "mistral-large-123b", "mamba2-1.3b")
ROUTES = ("dense", "gather", "matmul", "mask")
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


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax(arch, route):
    """One step's loss, ``ce`` and ``aux`` and every gradient leaf at
    relative L2 <= 1e-4. The kept channels first: at every sparse site
    the port's recorded selections equal the nonzero columns of the JAX
    package's dW (an expert site: each expert's own)."""
    jcfg, cfg, tree = _model(arch)
    jpol, tpol = _routes(jpolicy)[route], _routes(tpolicy)[route]
    batch = _batch(cfg)
    vag = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b, jpol), has_aux=True))
    (lj, mj), gj = vag(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    named_p = _named_port(params)
    site_of = {}
    for name, t in named_p.items():
        if name.endswith("/w") and name.startswith("layer_"):
            site_of[t.data_ptr()] = (name[:-2], None)
        elif name.split("/")[-1] in ("gate", "up", "down") and "/moe/" in name:
            for e in range(cfg.n_experts):
                site_of[t[e].data_ptr()] = (name, e)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tbackward.record_selections() as log:
        (lt, mt), gt = tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, tb, tpol), params)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    assert abs(float(mt["ce"]) - float(mj["ce"])) <= 1e-4 * abs(float(mj["ce"]))
    assert abs(float(mt["aux"]) - float(mj["aux"])) <= 1e-5 * max(1.0, abs(float(mj["aux"])))
    assert (float(mt["aux"]) > 0) == cfg.is_moe
    named_j, named_t = _named_jax(jax.tree.map(np.asarray, gj), jcfg), _named_port(gt)
    assert sorted(named_t) == sorted(named_j)

    for ptr, sel in log:
        name, e = site_of[ptr]
        w = named_j[name if e is not None else f"{name}/w"]
        cols = np.flatnonzero(np.abs(w if e is None else w[e]).sum(0))
        if e is not None and not len(cols):
            continue  # an expert that got no token this step
        np.testing.assert_array_equal(sel.idx.numpy(), cols, err_msg=f"{name} {e}")
    if route != "dense":
        assert len(log) == sum(
            cfg.n_experts if s.split("/", 1)[1] in ("moe/gate", "moe/up", "moe/down") else 1
            for s in tlm.site_names(cfg)[0])
    for name, g in named_t.items():
        assert tuple(g.shape) == named_j[name].shape, name
        assert _rel(g.numpy(), named_j[name]) <= 1e-4, name


