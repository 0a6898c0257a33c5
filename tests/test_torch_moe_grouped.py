"""The port's DP-local MoE dispatch (``moe_dp_groups``) against the JAX
package's.

``moe_apply(dp_groups=G)`` at the reduced MoE configs, G in {2, 4}: the
output, ``aux_loss`` and ``dropped`` (capacity drops included), then
every gradient leaf on the dense, gather, mask and kernel routes with
each expert's kept channels; the fallbacks to the ungrouped dispatch
(``B*S % G != 0``, ``full_capacity``); the model's loss through
``cfg.moe_dp_groups``; and the launch table's G x experts x products on
the expert sites. Inputs and params are made from a seed and handed to
both packages; the kernel route runs ``matmul``'s plain version here.
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
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.model import _tensor


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


def _convert(tree):
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _moe_pair(arch="kimi-k2-1t-a32b", **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    pj = jmoe.moe_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    return jcfg, tcfg, pj, _convert(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch,over", [
    ("kimi-k2-1t-a32b", {}),  # top-2, a shared expert
    ("kimi-k2-1t-a32b", dict(capacity_factor=0.5)),  # heavy overflow
    ("llama4-maverick-400b-a17b", {}),  # top-1, a shared expert
    ("jamba-1.5-large-398b", {}),  # top-2, no shared expert
])
def test_grouped_moe_apply_matches_jax(arch, over, groups):
    """Outputs at 1e-5, ``aux_loss`` and ``dropped`` equal; the per-group
    capacity drops tokens where the JAX package's does."""
    jcfg, tcfg, pj, pt = _moe_pair(arch, **over)
    x = np.random.default_rng(7).standard_normal((2, 12, 128)).astype(np.float32)
    ref, rm = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, jpolicy.DENSE,
                                                  dp_groups=groups))(pj, jnp.asarray(x))
    ours, om = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg, dp_groups=groups)
    assert _rel(ours.numpy(), ref) <= 1e-5
    assert float(om["dropped"]) == pytest.approx(float(rm["dropped"]), abs=1e-7)
    assert float(om["aux_loss"]) == pytest.approx(float(rm["aux_loss"]), rel=1e-6)
    if over:
        assert float(om["dropped"]) > 0.0


@pytest.mark.parametrize("full_capacity,groups", [(False, 5), (True, 2)])
def test_ungrouped_fallbacks(full_capacity, groups):
    """``B*S % G != 0`` and ``full_capacity`` take the ungrouped dispatch,
    in both packages."""
    jcfg, tcfg, pj, pt = _moe_pair(capacity_factor=0.5)
    x = np.random.default_rng(8).standard_normal((2, 12, 128)).astype(np.float32)
    kw = dict(full_capacity=full_capacity)
    ours, om = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg, dp_groups=groups, **kw)
    plain, pm = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg, **kw)
    assert torch.equal(ours, plain) and float(om["dropped"]) == float(pm["dropped"])
    ref, _ = jmoe.moe_apply(pj, jnp.asarray(x), jcfg, jpolicy.DENSE, dp_groups=groups, **kw)
    assert _rel(ours.numpy(), ref) <= 1e-5


ROUTES = {
    "dense": dict(rate=0.0),
    "gather": dict(rate=0.5),
    "mask": dict(rate=0.5, mask_mode=True),
    "kernel": dict(rate=0.5, use_pallas=True),
}


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("route", list(ROUTES))
def test_grouped_moe_grads_and_kept_channels_match_jax(route, groups):
    """Every gradient leaf at 1e-4 on each route. On the sparse routes
    every (group, expert) pair selects on its own cotangent (G x E
    selections a product); an expert's dW is non-zero on the JAX
    package's columns exactly, all of them among its groups' kept ones."""
    jcfg, tcfg, pj, pt = _moe_pair(capacity_factor=0.75)
    kw = dict(ROUTES[route])
    rate = kw.pop("rate")
    jpol = dataclasses.replace(jpolicy.paper_default(rate), **kw)
    tpol = dataclasses.replace(tpolicy.paper_default(rate), **kw)
    x = np.random.default_rng(9).standard_normal((2, 8, 128)).astype(np.float32)

    def jloss(p, x):
        y, m = jmoe.moe_apply(p, x, jcfg, jpol, dp_groups=groups)
        return (y**2).sum() + m["aux_loss"]

    gj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj, jnp.asarray(x))
    gj = jax.tree.map(np.asarray, gj)
    for _, t in _leaves(pt):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with tbackward.record_selections() as log:
        y, m = tmoe.moe_apply(pt, xt, tcfg, tpol, dp_groups=groups)
        ((y**2).sum() + m["aux_loss"]).backward()
    assert _rel(xt.grad.numpy(), gxj) <= 1e-4
    for (path, a), (_, b) in zip(_leaves(pt), _leaves(gj), strict=True):
        g = a.grad if a.grad is not None else torch.zeros_like(a)
        assert _rel(g.numpy(), b) <= 1e-4, path
    if not rate:
        return
    for n in ("gate", "up", "down"):
        for e in range(tcfg.n_experts):
            sels = [s.idx.numpy() for ptr, s in log if ptr == pt[n][e].data_ptr()]
            assert len(sels) == groups, (n, e)
            ref = np.flatnonzero(np.abs(gj[n][e]).sum(0))
            np.testing.assert_array_equal(
                np.flatnonzero(pt[n].grad[e].abs().sum(0).numpy()), ref, err_msg=f"{n} {e}")
            # a group that routed no token to the expert selects on zeros
            # and adds nothing, so the kept union may be wider
            assert np.isin(ref, np.concatenate(sels)).all(), (n, e)


def test_model_loss_through_cfg_moe_dp_groups(monkeypatch):
    """The reduced kimi-k2 with ``moe_dp_groups=2``: the JAX package's loss
    on the kernel route, and ``matmul`` launched the launch table's
    count, G x experts x products on the expert sites."""
    jcfg = dataclasses.replace(jget("kimi-k2-1t-a32b").reduced(), moe_dp_groups=2)
    cfg = dataclasses.replace(tget("kimi-k2-1t-a32b").reduced(), moe_dp_groups=2)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(cfg.vocab, 8, 2, seed=0)).batch_at(0)
    jpol = dataclasses.replace(jpolicy.paper_default(0.8), use_pallas=True)
    tpol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    lj, _ = jlm.loss_fn(jcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()}, jpol)
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    (lt, _), _ = tsteps.value_and_grad(
        lambda p: tlm.loss_fn(cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()}, tpol),
        params)
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    ungrouped = tlm.kernel_launches_per_step(dataclasses.replace(cfg, moe_dp_groups=0),
                                             tpol)["matmul"]
    n_moe = sum(s.endswith("moe/gate") for s in tlm.site_names(cfg)[0])
    per = tlm.kernel_launches_per_step(cfg, tpol)["matmul"]
    assert per == ungrouped + n_moe * 3 * 2 * (2 - 1) * cfg.n_experts
    assert len(calls) == per
