"""Sharded selection through the port's backward engine, against the JAX
package's.

``sparse_dense`` with ``tp_shards`` (the TP fast path when both sides
are sparsified, before any kernel) and ``sparse_conv2d`` with
``tp_shards`` and ``groups`` on the gather route, the kernel route
(the fused kernels through the regrouped ``block_idx``, or the gathered
VJP where a shard block was shrunk) and the mask oracle: the kept
channels first, then every gradient within
``tests/test_backward_engine.py::_tols``. Then the port's twins of that
file's sharded and grouped checks and of ``tests/test_ssprop_core.py``'s,
and the contraction-FLOPs bounds integer for integer. On the CPU the
port's kernels run their plain versions and the JAX package's Pallas
kernels run in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import flops as jflops
from repro.core import policy as jpolicy
from repro.core import sparse_conv2d as jconv
from repro.core import sparse_dense as jdense
from repro.core import sparsity as jsparsity
from repro.data import pipeline as jpipe
from repro.models import model as jlm
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import conv as tconv_mod
from repro_torch.core import flops as tflops
from repro_torch.core import policy as tpolicy
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.conv import sparse_conv2d as tconv
from repro_torch.core.dense import sparse_dense as tdense
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm

CFGS = [("channel", ""), ("block", ""), ("channel", "bfloat16"), ("block", "bfloat16")]
ROUTES = {"gather": {}, "kernels": {"use_pallas": True}, "mask": {"mask_mode": True}}


def _tols(bwd_dtype):  # tests/test_backward_engine.py::_tols
    if bwd_dtype == "bfloat16":
        return dict(rtol=3e-2, atol=3e-2)
    return dict(rtol=2e-4, atol=1e-5)


def _spread(rng, n):
    """Per-channel scales spread apart (no top-k near-ties)."""
    return (1.3 ** (rng.permutation(n) * min(1.0, 24 / n))).astype(np.float32)


def _dense_inputs(d_out=64):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, d_out)) * 0.2).astype(np.float32) * _spread(rng, d_out)[None]
    b = rng.standard_normal((d_out,)).astype(np.float32) * 0.1
    return x, w, b


def _dense_both(kw, d_out=64):
    x, w, b = _dense_inputs(d_out)
    jpol, tpol = jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)
    gj = jax.jit(jax.grad(lambda x, w, b: 0.5 * (jdense(x, w, b, policy=jpol) ** 2).mean(),
                          argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = tdense(xt, wt, bt, policy=tpol)
    (0.5 * (y**2).mean()).backward()
    n = tpol.tp_shards if tpol.tp_shards > 1 else 1
    sj = jsparsity.select(jnp.asarray(y.detach().numpy()), jpol, channel_axis=1, n_shards=n)
    st = tsparsity.select(y.detach(), tpol, channel_axis=1, n_shards=n)
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    return gj, (xt.grad, wt.grad, bt.grad)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("granularity,bwd_dtype", CFGS)
@pytest.mark.parametrize("tp_shards", [0, 4])
def test_sparse_dense_tp_grads_match_jax(tp_shards, granularity, bwd_dtype, route):
    kw = dict(drop_rate=0.5, granularity=granularity, block_size=8, bwd_dtype=bwd_dtype,
              tp_shards=tp_shards, **ROUTES[route])
    gj, gt = _dense_both(kw)
    for name, a, r in zip(("dx", "dw", "db"), gt, gj, strict=True):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32), err_msg=name,
                                   **_tols(bwd_dtype))


def test_dense_tp_fast_path_takes_no_kernel(monkeypatch):
    """Both sides sparsified: the TP fast path runs before the kernel
    branch (no gathered kernel, no ``matmul``); with one side dense the
    generic kernel route runs."""
    calls = dict.fromkeys(("dx_gathered", "dw_gathered_scatter", "matmul"), 0)
    for name in calls:
        real = getattr(tops, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, spy)
    x, w, _ = _dense_inputs()
    for gran in ("block", "channel"):
        pol = tpolicy.SsPropPolicy(0.5, granularity=gran, block_size=8, tp_shards=4,
                                   use_pallas=True)
        for p in (pol, dataclasses.replace(pol, sparsify_dw=False)):
            xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
            tdense(xt, wt, policy=p).square().mean().backward()
    # the two sparsify_dw=False runs: dx_gathered (block), matmul dX (channel)
    assert calls == {"dx_gathered": 1, "dw_gathered_scatter": 0, "matmul": 1}


# --- sparse_conv2d: tp_shards and groups ------------------------------


def _conv_inputs(c_in, c_out, groups):
    rng = np.random.default_rng(c_out + groups)
    x = rng.standard_normal((2, c_in, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((c_out, c_in // groups, 3, 3)) * 0.2).astype(np.float32)
    w *= _spread(rng, c_out)[:, None, None, None]
    b = rng.standard_normal((c_out,)).astype(np.float32) * 0.1
    return x, w, b


def _conv_both(kw, groups, c_in=8, c_out=32, padding=1, stride=1):
    x, w, b = _conv_inputs(c_in, c_out, groups)
    geo = dict(stride=stride, padding=padding, groups=groups)
    jpol, tpol = jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)

    def jloss(x, w, b):
        return 0.5 * (jconv(x, w, b, policy=jpol, **geo) ** 2).mean()

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w),
                                                     jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = tconv(xt, wt, bt, policy=tpol, **geo)
    (0.5 * (y**2).mean()).backward()
    n = tsparsity.selection_shards(tpol, c_out, groups)
    sj = jsparsity.select(jnp.asarray(y.detach().numpy()), jpol, channel_axis=1, n_shards=n)
    st = tsparsity.select(y.detach(), tpol, channel_axis=1, n_shards=n)
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    assert (st.block_idx is None) == (sj.block_idx is None)
    return gj, (xt.grad, wt.grad, bt.grad), st


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("granularity,bs", [("channel", 4), ("block", 4), ("block", 16)])
@pytest.mark.parametrize("tp_shards,groups", [(4, 1), (4, 2), (4, 4), (0, 2), (0, 4)])
def test_sparse_conv2d_tp_grouped_grads_match_jax(tp_shards, groups, granularity, bs, route):
    """bs=4 keeps whole 4-blocks a shard (``block_idx`` regrouped: the
    kernel route takes the fused kernels); bs=16 shrinks the 8-channel
    shards' blocks to 8 (no ``block_idx``: the gathered VJP)."""
    kw = dict(drop_rate=0.5, granularity=granularity, block_size=bs, tp_shards=tp_shards,
              **ROUTES[route])
    gj, gt, st = _conv_both(kw, groups)
    if granularity == "block":
        shrunk = tsparsity.shard_select_width(32, tpolicy.SsPropPolicy(**kw), st.n_shards)[1] != bs
        assert (st.block_idx is None) == shrunk == (bs == 16 and st.n_shards == 4)
    for name, a, r in zip(("dx", "dw", "db"), gt, gj, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **_tols(""))


@pytest.mark.parametrize("groups", [2, 4])
def test_sparse_conv2d_grouped_bf16_matches_jax(groups):
    kw = dict(drop_rate=0.5, granularity="block", block_size=4, bwd_dtype="bfloat16",
              use_pallas=True)
    gj, gt, _ = _conv_both(kw, groups)
    for name, a, r in zip(("dx", "dw", "db"), gt, gj, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **_tols("bfloat16"))


def _spy(monkeypatch):
    calls = dict.fromkeys(
        ("conv_dx_fused", "conv_dw_fused_scatter", "dx_gathered", "dw_gathered_scatter"), 0)
    for name in calls:
        real = getattr(tops, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, spy)
    return calls


@pytest.mark.parametrize("tp_shards,groups,bs,k", [
    (0, 2, 4, 3), (0, 4, 4, 3), (4, 1, 4, 3), (4, 2, 4, 3), (0, 2, 16, 3), (0, 4, 16, 3),
    (4, 1, 16, 3), (4, 1, 4, 1), (4, 1, 16, 1),
])
def test_conv_kernel_route_follows_backward_route(monkeypatch, tp_shards, groups, bs, k):
    """The kernels each sharded conv launches are the ones its
    ``backward_route`` names: fused or canonical through the regrouped
    ``block_idx``, none where the shard block was shrunk."""
    calls = _spy(monkeypatch)
    x, w, _ = _conv_inputs(8, 32, groups)
    w = w[:, :, :k, :k].copy()
    pol = tpolicy.SsPropPolicy(0.5, granularity="block", block_size=bs, tp_shards=tp_shards,
                               use_pallas=True)
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tconv(xt, wt, padding=(k - 1) // 2, groups=groups, policy=pol).square().mean().backward()
    route = tconv_mod.backward_route(pol, batch=2, h_out=8, w_out=8, c_in=8, c_out=32, kh=k,
                                     kw=k, groups=groups)
    want = {"conv_dx_fused": int(route == "fused"),
            "conv_dw_fused_scatter": int(route == "fused"),
            "dx_gathered": int(route == "canonical"),
            "dw_gathered_scatter": int(route == "canonical")}
    assert calls == want
    shrunk = bs == 16 and tsparsity.selection_shards(pol, 32, groups) == 4  # 8-channel shards
    assert route == ("gathered" if shrunk else "fused" if k == 3 else "canonical")


# --- twins of tests/test_backward_engine.py ---------------------------


def _port_conv_grads(pol, groups=1, c_in=6, c_out=16, stride=1, padding=1):
    x, w, b = _conv_inputs(c_in, c_out, groups)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = tconv(xt, wt, bt, stride=stride, padding=padding, groups=groups, policy=pol)
    (0.5 * (y**2).mean()).backward()
    return xt.grad, wt.grad, bt.grad


def _port_dense_grads(pol):
    x, w, b = _dense_inputs(32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    (0.5 * (tdense(xt, wt, bt, policy=pol) ** 2).mean()).backward()
    return xt.grad, wt.grad, bt.grad


def _pol(granularity, bwd_dtype, *, mask=False, block_size=8, rate=0.5, **kw):
    return tpolicy.SsPropPolicy(rate, granularity=granularity, block_size=block_size,
                                mask_mode=mask, bwd_dtype=bwd_dtype, **kw)


def _assert_close(g1, g2, **tol):
    for name, a, r in zip(("dx", "dw", "db"), g1, g2, strict=True):
        np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("granularity,bwd_dtype", CFGS)
def test_conv_tp_shards_gather_equals_mask(granularity, bwd_dtype):
    _assert_close(_port_conv_grads(_pol(granularity, bwd_dtype, tp_shards=4)),
                  _port_conv_grads(_pol(granularity, bwd_dtype, mask=True, tp_shards=4)),
                  **_tols(bwd_dtype))


def test_conv_tp_shards_balanced():
    # 4 shards of 4 channels at rate 0.5 -> 2 kept a shard
    _, dw, _ = _port_conv_grads(_pol("channel", "", tp_shards=4))
    kept = (dw.abs().sum((1, 2, 3)) != 0).reshape(4, 4).sum(1)
    assert (kept == 2).all()


@pytest.mark.parametrize("granularity,bwd_dtype", CFGS)
@pytest.mark.parametrize("tp_shards", [0, 4])
def test_dense_gather_equals_mask_oracle(granularity, bwd_dtype, tp_shards):
    _assert_close(_port_dense_grads(_pol(granularity, bwd_dtype, tp_shards=tp_shards)),
                  _port_dense_grads(_pol(granularity, bwd_dtype, mask=True, tp_shards=tp_shards)),
                  **_tols(bwd_dtype))


def test_conv_grouped_routes_fused_block_diagonal(monkeypatch):
    """groups=2 at 4-channel blocks: whole blocks a group, so the fused
    kernels run (block-diagonal), equal to the mask oracle."""
    calls = _spy(monkeypatch)
    g1 = _port_conv_grads(_pol("block", "", block_size=4, use_pallas=True), groups=2)
    assert calls["conv_dx_fused"] == 1 and calls["conv_dw_fused_scatter"] == 1
    g2 = _port_conv_grads(_pol("block", "", block_size=4, mask=True), groups=2)
    _assert_close(g1, g2, rtol=1e-3, atol=1e-4)


def test_conv_grouped_indivisible_falls_back(monkeypatch):
    """c_out=16, groups=2 needs whole 8-channel blocks a group; at
    block_size=16 no kernel runs (the gathered VJP), still exact."""
    calls = _spy(monkeypatch)
    g1 = _port_conv_grads(_pol("block", "", block_size=16, use_pallas=True), groups=2)
    assert not any(calls.values())
    g2 = _port_conv_grads(_pol("block", "", block_size=16, mask=True), groups=2)
    _assert_close(g1, g2, **_tols(""))


# --- twins of tests/test_ssprop_core.py -------------------------------


def test_groups_supported():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((16, 4, 3, 3)).astype(np.float32)).requires_grad_()
    (tconv(x, w, stride=1, padding=1, groups=2, policy=tpolicy.paper_default(0.5)) ** 2
     ).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def _core_dense(w_cols, seed, pol):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 48)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((48, w_cols)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((w_cols,)).astype(np.float32)).requires_grad_()
    (tdense(x, w, b, policy=pol) ** 2).sum().backward()
    return w.grad


def test_tp_local_balanced_and_subset_of_dense():
    pol = dataclasses.replace(tpolicy.paper_default(0.5), tp_shards=4)
    dw = _core_dense(128, 9, pol)
    kept = (dw.abs().sum(0) != 0).reshape(4, 32).sum(1)
    assert (kept == kept[0]).all()
    dwd = _core_dense(128, 9, tpolicy.SsPropPolicy(0.0))
    mask = dw.abs().sum(0) != 0
    np.testing.assert_allclose(dw[:, mask].numpy(), dwd[:, mask].numpy(), rtol=1e-4, atol=1e-3)


def test_tp_local_block_granularity_per_shard():
    pol = dataclasses.replace(tpolicy.tpu_default(0.5), block_size=32, tp_shards=4)
    dw = _core_dense(256, 11, pol)
    assert (dw.abs().sum(0) != 0).reshape(8, 32).any(1).sum() == 4  # 1 of 2 a shard


# --- contraction FLOPs ------------------------------------------------

BOUND_POLICIES = [
    dict(drop_rate=0.0),
    dict(drop_rate=0.8, mask_mode=True),
    dict(drop_rate=0.8),
    dict(drop_rate=0.8, granularity="block", block_size=16),
    dict(drop_rate=0.8, granularity="block", block_size=16, use_pallas=True),
    dict(drop_rate=0.8, granularity="block", block_size=16, use_pallas=True, fuse_im2col=False),
    dict(drop_rate=0.8, use_pallas=True),
    dict(drop_rate=0.5, granularity="block", block_size=16, use_pallas=True, sparsify_dw=False),
    dict(drop_rate=0.5, use_pallas=True, sparsify_dx=False),
    dict(drop_rate=0.8, granularity="block", block_size=128, use_pallas=True, tp_shards=4),
    dict(drop_rate=0.8, granularity="block", block_size=16, tp_shards=4),
    dict(drop_rate=0.8, tp_shards=4, use_pallas=True),
    dict(drop_rate=0.8, tp_shards=16, granularity="block", block_size=128,
         bwd_dtype="bfloat16", use_pallas=True),
]


def _jax_conv_bounds(args, jp, groups=1, **kw):
    """The JAX package's contraction bounds of the route its engine runs.
    The engine takes a kernel route only with a selection's ``block_idx``
    (``repro/core/backward.py:237``), which a sharded selection whose
    shard-local block shrank does not carry, so that conv runs the
    gathered VJP; the JAX package's FLOPs model still counts the kernel
    route there (its ``_conv_fused_route`` does not look at the shard
    block). For such a conv the expectation is that model's count of the
    gather route, which the same policy without ``use_pallas`` gives."""
    c_out = args[4]
    n = jp.tp_shards if jp.tp_shards > 1 and c_out % jp.tp_shards == 0 else 1
    if groups > 1 and (n < groups or n % groups != 0):
        n = groups  # the JAX package's ``_ConvOp.selection_shards``
    if jp.use_pallas and jp.granularity == "block" and n > 1:
        dy = jnp.asarray(np.random.default_rng(0).random((2, c_out), np.float32))
        if jsparsity.select(dy, jp, channel_axis=1, n_shards=n).block_idx is None:
            jp = dataclasses.replace(jp, use_pallas=False)
    return jflops.conv_backward_contraction_bounds(*args, jp, groups=groups, **kw)


@pytest.mark.parametrize("kw", BOUND_POLICIES, ids=range(len(BOUND_POLICIES)))
def test_contraction_bounds_match_jax(kw):
    jp, tp = jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)
    for args in [(4, 8, 8, 16, 64, 3), (8, 16, 16, 64, 128, 3), (2, 4, 4, 32, 96, 1),
                 (128, 4, 4, 512, 512, 3), (4, 8, 8, 30, 130, 3)]:
        for groups in (1, 2):
            if args[3] % groups:
                continue
            assert tflops.conv_backward_contraction_bounds(*args, tp, groups=groups) == \
                _jax_conv_bounds(args, jp, groups=groups), (args, groups)
        assert tflops.conv_backward_contraction_bounds(*args, tp, h_pad=11) == \
            _jax_conv_bounds(args, jp, h_pad=11)
    for m, d_in, d_out in [(64, 48, 128), (1024, 2048, 11008), (1024, 2048, 256), (30, 7, 130)]:
        assert tflops.dense_backward_contraction_bounds(m, d_in, d_out, tp) == \
            jflops.dense_backward_contraction_bounds(m, d_in, d_out, jp), (m, d_in, d_out)
        for s in (1, 2, 4, 16):
            assert tflops.gather_width(d_out, tp, s) == jflops.gather_width(d_out, jp, s)


@pytest.mark.parametrize("sparsify_dw", [True, False])
def test_lm_launch_table_counts_the_tp_fast_path(monkeypatch, sparsify_dw):
    """The reduced qwen2.5-3b at ``tp_shards=128``: q, o, the MLP (widths
    128 and 256) take the TP fast path and launch no ``matmul``, k and v
    (width 64) take the kernel; with one side dense every site launches.
    The launch table says so, and a step launches exactly that."""
    cfg = tget("qwen2.5-3b").reduced()
    tree = jax.tree.map(np.asarray, jlm.init_params(jget("qwen2.5-3b").reduced(),
                                                    jax.random.PRNGKey(0)))
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True, tp_shards=128,
                              sparsify_dw=sparsify_dw)
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    batch = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(cfg.vocab, 8, 2, seed=0)).batch_at(0)
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    tsteps.value_and_grad(lambda p: tlm.loss_fn(
        cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()}, pol), params)
    per = tlm.kernel_launches_per_step(cfg, pol)["matmul"]
    sides = 1 + sparsify_dw
    kv_only = cfg.n_layers * 2 * sides  # k and v a layer
    assert per == (kv_only if sparsify_dw else cfg.n_layers * 7 * sides)
    assert len(calls) == per
