"""The SSM (Mamba-2 SSD) and MoE layers against the JAX package, on the CPU.

Inputs come from numpy seeds; params are made by the JAX package and
converted. SSM outputs are held at a relative L2 of 1e-5 (fp32), MoE
outputs and gradients at 1e-4; ``aux_loss`` / ``dropped`` and each
expert's kept channels exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import policy as jpolicy
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
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


# ----------------------------------------------------------------------
# SSM
# ----------------------------------------------------------------------


def _ssm_pair(chunk=16):
    jcfg = dataclasses.replace(jget("mamba2-1.3b").reduced(), ssm_chunk=chunk)
    tcfg = dataclasses.replace(tget("mamba2-1.3b").reduced(), ssm_chunk=chunk)
    pj = jssm.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    # a non-trivial dt bias and conv bias, so every term of the block counts
    rng = np.random.default_rng(1)
    pj = dict(pj, dt_bias=jnp.asarray(rng.normal(0, 0.5, pj["dt_bias"].shape), jnp.float32),
              conv_b=jnp.asarray(rng.normal(0, 0.1, pj["conv_b"].shape), jnp.float32))
    return jcfg, tcfg, pj, _convert(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("slen,chunk", [(16, 16), (32, 16), (48, 16), (8, 8), (24, 8)])
def test_ssd_chunked_matches_jax(slen, chunk):
    """1-3 chunks (and 3 of 8), the inter-chunk recurrence included."""
    rng = np.random.default_rng(slen + chunk)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, slen, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, slen, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, slen, n)).astype(np.float32)
    cm = rng.standard_normal((b, slen, n)).astype(np.float32)
    ref = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), chunk)
    ours = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bm, cm)), chunk)
    assert _rel(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("slen", [16, 21, 40])
def test_ssm_apply_full_sequence_matches_jax(slen):
    """S a multiple of the chunk and not (padded inside)."""
    jcfg, tcfg, pj, pt = _ssm_pair()
    x = np.random.default_rng(slen).standard_normal((2, slen, jcfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, x: jssm.ssm_apply(p, x, jcfg, jpolicy.DENSE)[0])(pj, jnp.asarray(x))
    ours, none = tssm.ssm_apply(pt, torch.from_numpy(x), tcfg)
    assert none is None and _rel(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("spec_states", [False, True])
def test_ssm_decode_with_token_valid_matches_jax(spec_states):
    """A 5-token decode chunk from a non-zero state, rows frozen by
    ``token_valid`` (a ragged prefill, a decode token, an idle slot)."""
    jcfg, tcfg, pj, pt = _ssm_pair()
    rng = np.random.default_rng(3)
    b, s = 3, 5
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = jssm.ssm_cache_init(jcfg, b)
    cache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) for k, v in
             cache.items()}
    valid = np.arange(s)[None, :] < np.array([5, 1, 0])[:, None]
    ref, rc = jssm.ssm_apply(pj, jnp.asarray(x), jcfg, jpolicy.DENSE, cache=cache,
                             token_valid=jnp.asarray(valid), spec_states=spec_states)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    ours, oc = tssm.ssm_apply(pt, torch.from_numpy(x), tcfg, cache=tcache,
                              token_valid=torch.from_numpy(valid), spec_states=spec_states)
    assert _rel(ours.numpy(), ref) <= 1e-5
    for k in ("conv", "state"):
        assert tuple(oc[k].shape) == rc[k].shape
        assert _rel(oc[k].numpy(), rc[k]) <= 1e-5
    frozen = oc["state"][2] if not spec_states else oc["state"][2, -1]
    np.testing.assert_array_equal(frozen.numpy(), np.asarray(cache["state"][2]))


def test_ssm_chunked_equals_stepwise_decode():
    """In the port, the chunked full sequence equals the per-position
    recurrence from a zero state, and the state it ends in is the one a
    token-by-token decode reaches."""
    _, tcfg, _, pt = _ssm_pair(chunk=8)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 20, 128)).astype(np.float32))
    full, _ = tssm.ssm_apply(pt, x, tcfg)
    cache = tssm.ssm_cache_init(tcfg, 2, device="cpu")
    chunk, cache_c = tssm.ssm_apply(pt, x, tcfg, cache=cache)
    steps = []
    for t in range(20):
        y, cache = tssm.ssm_apply(pt, x[:, t : t + 1], tcfg, cache=cache)
        steps.append(y)
    assert _rel(chunk.numpy(), full.numpy()) <= 1e-5
    assert _rel(torch.cat(steps, 1).numpy(), full.numpy()) <= 1e-5
    assert _rel(cache["state"].numpy(), cache_c["state"].numpy()) <= 1e-6


def test_ssm_gradient_through_the_scan_is_finite_and_matches_jax():
    jcfg, tcfg, pj, pt = _ssm_pair()
    x = np.random.default_rng(6).standard_normal((2, 40, 128)).astype(np.float32)
    gj = jax.jit(jax.grad(
        lambda p: (jssm.ssm_apply(p, jnp.asarray(x), jcfg, jpolicy.DENSE)[0] ** 2).sum()))(pj)
    p = {k: ({kk: vv.requires_grad_(True) for kk, vv in v.items()} if isinstance(v, dict)
             else v.requires_grad_(True)) for k, v in pt.items()}
    (tssm.ssm_apply(p, torch.from_numpy(x), tcfg)[0] ** 2).sum().backward()
    for (path, a), (_, b) in zip(_leaves(p), _leaves(jax.tree.map(np.asarray, gj)), strict=True):
        assert torch.isfinite(a.grad).all(), path
        assert _rel(a.grad.numpy(), b) <= 1e-4, path


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------


def _moe_pair(arch="kimi-k2-1t-a32b", **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    pj = jmoe.moe_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    return jcfg, tcfg, pj, _convert(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("full_capacity", [False, True])
@pytest.mark.parametrize("arch,over", [
    ("kimi-k2-1t-a32b", {}),  # top-2 of 4, a shared expert
    ("kimi-k2-1t-a32b", dict(capacity_factor=0.5)),  # heavy overflow
    ("llama4-maverick-400b-a17b", {}),  # top-1, a shared expert
    ("jamba-1.5-large-398b", {}),  # top-2, no shared expert
])
def test_moe_apply_matches_jax(arch, over, full_capacity):
    """Outputs at 1e-5, ``aux_loss`` and ``dropped`` equal; tokens are
    dropped at the JAX package's capacity, none at full capacity."""
    jcfg, tcfg, pj, pt = _moe_pair(arch, **over)
    x = np.random.default_rng(7).standard_normal((2, 12, 128)).astype(np.float32)
    ref, rm = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, jpolicy.DENSE,
                                                  full_capacity=full_capacity))(pj, jnp.asarray(x))
    ours, om = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg, full_capacity=full_capacity)
    assert _rel(ours.numpy(), ref) <= 1e-5
    assert float(om["dropped"]) == pytest.approx(float(rm["dropped"]), abs=1e-7)
    assert float(om["aux_loss"]) == pytest.approx(float(rm["aux_loss"]), rel=1e-6)
    if full_capacity:
        assert float(om["dropped"]) == 0.0
    elif over:
        assert float(om["dropped"]) > 0.0


def test_moe_shared_expert_is_added():
    """Without the shared expert's params the output loses exactly the
    shared MLP's contribution, in both packages."""
    jcfg, tcfg, pj, pt = _moe_pair()
    x = np.random.default_rng(8).standard_normal((1, 6, 128)).astype(np.float32)
    full, _ = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg)
    routed, _ = tmoe.moe_apply({k: v for k, v in pt.items() if k != "shared"},
                               torch.from_numpy(x), tcfg)
    jrouted, _ = jmoe.moe_apply({k: v for k, v in pj.items() if k != "shared"},
                                jnp.asarray(x), jcfg, jpolicy.DENSE)
    assert _rel(routed.numpy(), jrouted) <= 1e-5
    assert _rel((full - routed).numpy(), np.asarray(full) - np.asarray(jrouted)) <= 1e-4
    assert (full - routed).abs().max() > 0


ROUTES = {
    "dense": dict(rate=0.0),
    "gather": dict(rate=0.5),
    "mask": dict(rate=0.5, mask_mode=True),
    "kernel": dict(rate=0.5, use_pallas=True),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_moe_grads_and_kept_channels_match_jax(route):
    """Every gradient leaf at 1e-4 on each route (the kernel route runs
    ``matmul``'s plain version here); on the sparse routes each expert
    keeps the channels JAX's keeps: the JAX package vmaps the selection
    over the experts, the port selects expert by expert, and the kept
    output channels show as the non-zero columns of each expert's dW."""
    jcfg, tcfg, pj, pt = _moe_pair()
    kw = dict(ROUTES[route])
    rate = kw.pop("rate")
    jpol = dataclasses.replace(jpolicy.paper_default(rate), **kw)
    tpol = dataclasses.replace(tpolicy.paper_default(rate), **kw)
    x = np.random.default_rng(9).standard_normal((2, 8, 128)).astype(np.float32)

    def jloss(p, x):
        y, m = jmoe.moe_apply(p, x, jcfg, jpol)
        return (y**2).sum() + m["aux_loss"]

    gj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj, jnp.asarray(x))
    gj = jax.tree.map(np.asarray, gj)
    for _, t in _leaves(pt):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with tbackward.record_selections() as log:
        y, m = tmoe.moe_apply(pt, xt, tcfg, tpol)
        ((y**2).sum() + m["aux_loss"]).backward()
    assert _rel(xt.grad.numpy(), gxj) <= 1e-4
    for (path, a), (_, b) in zip(_leaves(pt), _leaves(gj), strict=True):
        g = a.grad if a.grad is not None else torch.zeros_like(a)
        assert _rel(g.numpy(), b) <= 1e-4, path
    if not rate:
        return
    kept = {pt[n][e].data_ptr(): (n, e) for n in ("gate", "up", "down")
            for e in range(tcfg.n_experts)}
    per_expert = {kept[ptr]: sel.idx.numpy() for ptr, sel in log if ptr in kept}
    assert len(per_expert) == 3 * tcfg.n_experts
    for (n, e), idx in per_expert.items():
        ref = np.flatnonzero(np.abs(gj[n][e]).sum(0))
        assert len(ref), (n, e)  # every expert got tokens
        np.testing.assert_array_equal(idx, ref, err_msg=f"{n} expert {e}")
        np.testing.assert_array_equal(
            np.flatnonzero(pt[n].grad[e].abs().sum(0).numpy()), ref, err_msg=f"{n} expert {e}")
