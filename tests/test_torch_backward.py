"""The port's channel-sparse backward against the JAX package's.

Selection, and the ``sparse_conv2d`` / ``sparse_dense`` gradients (dx,
dw, db) on the gather route, the kernel route (``use_pallas``) and the
mask oracle, over the ``groups=1`` geometry of
``tests/test_backward_engine.py`` and its granularity x ``bwd_dtype``
grid, with its tolerances. Inputs are made with numpy from a seed, with
output channels scaled apart so that no top-k choice is a near-tie, and
handed to both packages; the selection is compared before the
gradients. On the CPU the port's gathered kernels run their plain
versions and the JAX package's run their Pallas kernels in interpret
mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backward as jbackward
from repro.core import policy as jpolicy
from repro.core import sparse_conv2d as jconv
from repro.core import sparse_dense as jdense
from repro.core import sparsity as jsparsity
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.core import prng as tprng
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.conv import sparse_conv2d as tconv
from repro_torch.core.dense import sparse_dense as tdense
from repro_torch.kernels import ops as tops


# --- selection --------------------------------------------------------


def _separated_dy(rng, shape, channel_axis):
    """Random dY whose per-channel mean |dY| are well separated (scales
    spread geometrically, shuffled): no top-k near-ties."""
    c = shape[channel_axis]
    scale = 1.3 ** (rng.permutation(c) * min(1.0, 16 / c))
    sh = [1] * len(shape)
    sh[channel_axis] = c
    return (rng.standard_normal(shape) * scale.reshape(sh)).astype(np.float32)


@pytest.mark.parametrize("gran,bs,c", [("channel", 8, 16), ("block", 8, 16), ("block", 4, 10),
                                       ("block", 128, 130), ("block", 128, 64)])
def test_selection_matches_jax(gran, bs, c):
    rng = np.random.default_rng(1)
    dy = _separated_dy(rng, (2, c, 3, 3), 1)
    pol = dict(drop_rate=0.5, granularity=gran, block_size=bs)
    sj = jsparsity.select(jnp.asarray(dy), jpolicy.SsPropPolicy(**pol), channel_axis=1)
    st = tsparsity.select(torch.from_numpy(dy), tpolicy.SsPropPolicy(**pol), channel_axis=1)
    assert st.k == sj.k
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    for a, b in ((st.valid, sj.valid), (st.block_idx, sj.block_idx)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = tsparsity.keep_mask(dy.shape, st.idx, channel_axis=1, dtype=torch.float32)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jsparsity.keep_mask(dy.shape, sj.idx, channel_axis=1,
                                                     dtype=jnp.float32)))


def test_random_selection_properties():
    imp = torch.rand(40)
    a = tsparsity.select_topk_channels(imp, 7, selection="random", key=tprng.key(3))
    b = tsparsity.select_topk_channels(imp, 7, selection="random", key=tprng.key(3))
    assert torch.equal(a, b) and len(set(a.tolist())) == 7
    assert torch.equal(a, torch.sort(a).values) and 0 <= a.min() and a.max() < 40
    with pytest.raises(ValueError, match="requires"):
        tsparsity.select_topk_channels(imp, 7, selection="random")


def test_scatter_channels_ignores_phantom_duplicates():
    out = tbackward.scatter_channels(torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([1, 1, 1]),
                                     4, axis=1)
    np.testing.assert_array_equal(out.numpy(), [[0.0, 1.0, 0.0, 0.0]])
    jout = jbackward.scatter_channels(jnp.array([[1.0, 0.0, 0.0]]), jnp.array([1, 1, 1]), 4, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


# --- sparse_conv2d / sparse_dense gradients ---------------------------

GEOMS = [  # the groups=1 rows of tests/test_backward_engine.py::GEOMS
    (1, 1, 1), (2, 1, 1), (1, 0, 1), (2, 0, 1), (1, 1, 2), (2, 0, 2),
]
CFGS = [("channel", ""), ("block", ""), ("channel", "bfloat16"), ("block", "bfloat16")]
ROUTES = {"gather": {}, "kernels": {"use_pallas": True}, "mask": {"mask_mode": True}}


def _tols(bwd_dtype):  # tests/test_backward_engine.py::_tols
    if bwd_dtype == "bfloat16":
        return dict(rtol=3e-2, atol=3e-2)
    return dict(rtol=2e-4, atol=1e-5)


def _conv_inputs(c_out=16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((c_out, 6, 3, 3)) * 0.2).astype(np.float32)
    w *= (1.4 ** (rng.permutation(c_out) * min(1.0, 16 / c_out))).astype(np.float32)[
        :, None, None, None]
    b = rng.standard_normal((c_out,)).astype(np.float32) * 0.1
    return x, w, b


def _conv_grads_both(pol_kw, stride, padding, dilation, c_out=16):
    x, w, b = _conv_inputs(c_out)
    geo = dict(stride=stride, padding=padding, dilation=dilation)
    jpol, tpol = jpolicy.SsPropPolicy(**pol_kw), tpolicy.SsPropPolicy(**pol_kw)

    def jloss(x, w, b):
        return 0.5 * (jconv(x, w, b, policy=jpol, **geo) ** 2).mean()

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = tconv(xt, wt, bt, policy=tpol, **geo)
    (0.5 * (y**2).mean()).backward()
    # same selection first: dY = y / numel, so its importance orders as y's
    if tpol.active:
        sj = jsparsity.select(jnp.asarray(y.detach().numpy()), jpol, channel_axis=1)
        st = tsparsity.select(y.detach(), tpol, channel_axis=1)
        np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    return gj, (xt.grad, wt.grad, bt.grad)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("granularity,bwd_dtype", CFGS)
@pytest.mark.parametrize("stride,padding,dilation", GEOMS)
def test_sparse_conv2d_grads_match_jax(stride, padding, dilation, granularity, bwd_dtype, route):
    pol = dict(drop_rate=0.5, granularity=granularity, block_size=8, bwd_dtype=bwd_dtype,
               **ROUTES[route])
    gj, gt = _conv_grads_both(pol, stride, padding, dilation)
    for name, a, r in zip(("dx", "dw", "db"), gt, gj, strict=True):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32), err_msg=name,
                                   **_tols(bwd_dtype))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conv_ragged_tail_matches_jax(use_pallas):
    """C=130 at block size 128 (tests/test_backward_engine.py's ragged-tail
    regression): phantom slots neither double-count nor overwrite."""
    pol = dict(drop_rate=0.5, granularity="block", block_size=128, use_pallas=use_pallas)
    gj, gt = _conv_grads_both(pol, 1, 1, 1, c_out=130)
    for name, a, r in zip(("dx", "dw", "db"), gt, gj, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("granularity,bwd_dtype", CFGS)
def test_sparse_dense_grads_match_jax(granularity, bwd_dtype, route):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 32)) * 0.2).astype(np.float32)
    w *= (1.3 ** rng.permutation(32)).astype(np.float32)[None, :]
    b = rng.standard_normal((32,)).astype(np.float32) * 0.1
    kw = dict(drop_rate=0.5, granularity=granularity, block_size=8, bwd_dtype=bwd_dtype,
              **ROUTES[route])
    jpol, tpol = jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)
    gj = jax.jit(jax.grad(lambda x, w, b: 0.5 * (jdense(x, w, b, policy=jpol) ** 2).mean(),
                          argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = tdense(xt, wt, bt, policy=tpol)
    (0.5 * (y**2).mean()).backward()
    sj = jsparsity.select(jnp.asarray(y.detach().numpy()), jpol, channel_axis=1)
    np.testing.assert_array_equal(
        tsparsity.select(y.detach(), tpol, channel_axis=1).idx.numpy(), np.asarray(sj.idx))
    for name, a, r in zip(("dx", "dw", "db"), (xt.grad, wt.grad, bt.grad), gj, strict=True):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32), err_msg=name,
                                   **_tols(bwd_dtype))


def test_sparse_dense_channel_kernel_route_raises():
    """Channel granularity with ``use_pallas`` is the ``matmul`` kernel's
    route: a tensor on neither the CPU nor a card reaches the kernel's
    wrapper and raises there, never falling back to ``torch.matmul``."""
    x = torch.zeros(8, 16, device="meta", requires_grad=True)
    w = torch.zeros(16, 32, device="meta", requires_grad=True)
    pol = tpolicy.SsPropPolicy(0.5, use_pallas=True)
    with pytest.raises(ValueError, match="matmul runs on cpu or cuda"):
        (tdense(x, w, policy=pol) ** 2).sum().backward()


def test_sharded_selection_raises():
    x = torch.randn(2, 4, 6, 6, requires_grad=True)
    w = torch.randn(8, 2, 3, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconv(x, w, groups=2, padding=1, policy=tpolicy.SsPropPolicy(0.5)).sum().backward()
    w1 = torch.randn(8, 4, 3, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconv(x, w1, policy=tpolicy.SsPropPolicy(0.5, tp_shards=2)).sum().backward()


@pytest.mark.parametrize("stride,padding,dilation", GEOMS)
def test_fused_equals_canonical_equals_mask(stride, padding, dilation):
    """Within the port: the fused kernels, the materializing canonical
    kernels (``fuse_im2col=False``) and the mask oracle agree."""
    x, w, b = _conv_inputs()
    base = tpolicy.SsPropPolicy(0.5, granularity="block", block_size=4, use_pallas=True)
    grads = []
    for pol in (base, dataclasses.replace(base, fuse_im2col=False),
                dataclasses.replace(base, use_pallas=False, mask_mode=True)):
        xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
        y = tconv(xt, wt, bt, stride=stride, padding=padding, dilation=dilation, policy=pol)
        (0.5 * (y**2).mean()).backward()
        grads.append((xt.grad, wt.grad, bt.grad))
    for other in grads[1:]:
        for name, a, r in zip(("dx", "dw", "db"), grads[0], other, strict=True):
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


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


@pytest.mark.parametrize("fuse,input_grad", [(True, True), (False, True), (False, False)])
def test_conv_kernel_route_calls(monkeypatch, fuse, input_grad):
    """The kernel route takes the fused kernels (fuse_im2col) or the
    canonical ones; an input that needs no gradient gets no dX kernel."""
    calls = _spy(monkeypatch)
    x, w, b = _conv_inputs()
    pol = tpolicy.SsPropPolicy(0.5, granularity="block", block_size=8, use_pallas=True,
                               fuse_im2col=fuse)
    xt = torch.from_numpy(x).requires_grad_(input_grad)
    wt = torch.from_numpy(w).requires_grad_(True)
    tconv(xt, wt, padding=1, policy=pol).square().mean().backward()
    assert calls["conv_dx_fused"] == int(fuse and input_grad)
    assert calls["conv_dw_fused_scatter"] == int(fuse)
    assert calls["dx_gathered"] == int(not fuse and input_grad)
    assert calls["dw_gathered_scatter"] == int(not fuse)
    assert (xt.grad is not None) == input_grad


def test_same_padding_stride_2():
    """"SAME" at stride 2 pads (0, 1): forward and gradients match the
    JAX package's conv on every route."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((8, 4, 3, 3)) * 0.3).astype(np.float32)
    w *= (1.5 ** rng.permutation(8)).astype(np.float32)[:, None, None, None]
    for kw in ({}, {"use_pallas": True}, {"use_pallas": True, "fuse_im2col": False}):
        p = dict(drop_rate=0.5, granularity="block", block_size=4, **kw)
        jpol, tpol = jpolicy.SsPropPolicy(**p), tpolicy.SsPropPolicy(**p)
        yj, vjp = jax.vjp(lambda x, w: jconv(x, w, stride=2, padding="SAME", policy=jpol),
                          jnp.asarray(x), jnp.asarray(w))
        xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
        yt = tconv(xt, wt, stride=2, padding="SAME", policy=tpol)
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
        yt.backward(yt.detach())
        dxj, dwj = vjp(yj)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dwj), rtol=2e-4, atol=1e-5)
