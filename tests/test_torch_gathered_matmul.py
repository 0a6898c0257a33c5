"""The port's gathered-matmul kernels against the JAX package's.

On the CPU each of the port's wrappers takes its kernel's plain version;
the JAX side runs its Pallas kernel in interpret mode
(``repro.kernels.ops`` picks that off the TPU), on the shapes of
``tests/test_kernels.py``. Inputs are made with numpy from a seed and
handed to both packages. Tolerances as there: fp32 1e-4, bf16 2e-2
(one bf16 rounding of each operand, fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import im2col as jim2col
from repro.kernels import ops as jops
from repro_torch.kernels import build, im2col
from repro_torch.kernels import gathered_matmul as tgm
from repro_torch.kernels import ops as tops

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

SHAPES_DX = [
    # (M, N, D_in, kept_blocks), as tests/test_kernels.py
    (128, 256, 128, [0]),
    (256, 512, 384, [0, 2, 3]),
    (200, 512, 130, [1, 3]),  # non-multiples exercise the ragged edges
    (64, 128, 64, [0]),
]


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = _DT[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("m,n,d,blocks", SHAPES_DX)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_gathered_matches_jax(m, n, d, blocks, dtype):
    rng = np.random.default_rng(0)
    dy_j, dy_t = _both(rng.standard_normal((m, n)).astype(np.float32), dtype)
    w_j, w_t = _both(rng.standard_normal((d, n)).astype(np.float32), dtype)
    bidx = np.asarray(blocks, np.int32)
    out_j = np.asarray(jops.dx_gathered(dy_j, w_j, jnp.asarray(bidx)))
    out_t = tops.dx_gathered(dy_t, w_t, torch.from_numpy(bidx))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == (m, d)
    tol = _TOL[dtype]
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("m,n,d,blocks", SHAPES_DX)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_gathered_scatter_matches_jax(m, n, d, blocks, dtype):
    rng = np.random.default_rng(2)
    x_j, x_t = _both(rng.standard_normal((m, d)).astype(np.float32), dtype)
    dy_j, dy_t = _both(rng.standard_normal((m, n)).astype(np.float32), dtype)
    bidx = np.asarray(blocks, np.int32)
    out_j = np.asarray(jops.dw_gathered_scatter(x_j, dy_j, jnp.asarray(bidx), n))
    out_t = tops.dw_gathered_scatter(x_t, dy_t, torch.from_numpy(bidx), n).numpy()
    tol = _TOL[dtype]
    np.testing.assert_allclose(out_t, out_j, rtol=tol, atol=tol * 10)
    # dropped blocks are exactly zero
    for b in sorted(set(range(n // 128)) - set(blocks)):
        assert not out_t[:, b * 128 : (b + 1) * 128].any()


def test_ragged_channel_tail_block():
    """A kept tail block past C (C=64 at block size 128, the stem's
    shape): the phantom channels count as zeros, as the JAX package's
    zero padding makes them."""
    rng = np.random.default_rng(3)
    m, n, d = 96, 64, 27
    x = rng.standard_normal((m, d)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.standard_normal((d, n)).astype(np.float32)
    bidx = np.asarray([0], np.int32)
    dw_j = np.asarray(jops.dw_gathered_scatter(jnp.asarray(x), jnp.asarray(dy), bidx, n))
    dw_t = tops.dw_gathered_scatter(torch.from_numpy(x), torch.from_numpy(dy),
                                    torch.from_numpy(bidx), n).numpy()
    np.testing.assert_allclose(dw_t, dw_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw_t, x.T @ dy, rtol=1e-4, atol=1e-4)
    dx_j = np.asarray(jops.dx_gathered(jnp.asarray(dy), jnp.asarray(w), bidx))
    dx_t = tops.dx_gathered(torch.from_numpy(dy), torch.from_numpy(w), torch.from_numpy(bidx))
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-4, atol=1e-4)


# --- fused-im2col conv kernels, the geometry of tests/test_kernels.py ---

_FUSED_GEOMS = [
    # (stride, padding, dilation, groups)
    (1, 1, 1, 1),
    (2, 1, 1, 1),
    (1, 0, 2, 1),
    (1, 1, 1, 2),
    (2, 1, 2, 2),
]


def _conv_case(stride, padding, dilation, groups, c_out=16, bs=4, seed=10):
    rng = np.random.default_rng(seed)
    c_in, k, h = 6, 3, 8
    x = rng.standard_normal((2, c_in, h, h)).astype(np.float32)
    w = (rng.standard_normal((c_out, c_in // groups, k, k)) * 0.2).astype(np.float32)
    h_out = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    dy = rng.standard_normal((2, c_out, h_out, h_out)).astype(np.float32)
    nb = -(-c_out // bs)
    # one kept block per group where grouped; a ragged pair otherwise
    blocks = (
        [g * (nb // groups) for g in range(groups)] if groups > 1 else [0, 2]
    )
    common = dict(
        stride=(stride, stride), padding=((padding, padding), (padding, padding)),
        dilation=(dilation, dilation), groups=groups, block_size=bs,
    )
    return x, w, dy, np.asarray(blocks, np.int32), common


@pytest.mark.parametrize("stride,padding,dilation,groups", _FUSED_GEOMS)
def test_conv_dx_fused_matches_jax(stride, padding, dilation, groups):
    x, w, dy, bidx, common = _conv_case(stride, padding, dilation, groups)
    out_j = np.asarray(jops.conv_dx_fused(
        jnp.asarray(dy), jnp.asarray(w), jnp.asarray(bidx), hw=x.shape[2:], **common))
    out_t = tops.conv_dx_fused(
        torch.from_numpy(dy), torch.from_numpy(w), torch.from_numpy(bidx),
        hw=x.shape[2:], **common)
    assert out_t.dtype == torch.float32 and out_t.shape == x.shape
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4, atol=1e-4)


# c_out=10: a ragged tail block at block size 4 (ungrouped: grouped
# routing needs whole blocks per group)
@pytest.mark.parametrize(
    "stride,padding,dilation,groups,c_out",
    [(*g, 16) for g in _FUSED_GEOMS] + [(1, 1, 1, 1, 10), (2, 1, 1, 1, 10)],
)
def test_conv_dw_fused_matches_jax(stride, padding, dilation, groups, c_out):
    x, w, dy, bidx, common = _conv_case(stride, padding, dilation, groups, c_out=c_out)
    args = (jnp.asarray(x), jnp.asarray(dy), jnp.asarray(bidx))
    out_j = np.asarray(jops.conv_dw_fused_scatter(*args, kh=3, kw=3, **common))
    out_t = tops.conv_dw_fused_scatter(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(bidx), kh=3, kw=3,
        **common).numpy()
    assert out_t.shape == out_j.shape == (w.shape[1] * 9, c_out)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    # dropped blocks are exactly zero
    kept = {c for b in bidx for c in range(4 * b, min(4 * b + 4, c_out))}
    assert not out_t[:, sorted(set(range(c_out)) - kept)].any()


def test_conv_dx_fused_ragged_c_out():
    x, w, dy, bidx, common = _conv_case(1, 1, 1, 1, c_out=10)
    out_j = np.asarray(jops.conv_dx_fused(
        jnp.asarray(dy), jnp.asarray(w), jnp.asarray(bidx), hw=x.shape[2:], **common))
    out_t = tops.conv_dx_fused(
        torch.from_numpy(dy), torch.from_numpy(w), torch.from_numpy(bidx),
        hw=x.shape[2:], **common).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)


# --- im2col ----------------------------------------------------------


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 0, 1), (1, 1, 2), (2, 1, 1)])
def test_conv_patches_order_is_oihw_and_col2im_matches_jax(stride, padding, dilation):
    """``x2 @ flatten_filters(w)`` is the conv (columns in (c, kh, kw)
    order, as a flattened OIHW filter), and col2im is the JAX package's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 7)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    st, dl = (stride, stride), (dilation, dilation)
    pads = ((padding, padding), (padding, padding))
    x2, col2im, (h_out, w_out) = im2col.conv_patches(torch.from_numpy(x), 3, 3, st, pads, dl)
    y = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), None, st, padding, dl)
    y2 = (x2 @ im2col.flatten_filters(torch.from_numpy(w))).reshape(2, h_out, w_out, 5)
    np.testing.assert_allclose(y2.permute(0, 3, 1, 2).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    x2_j, col2im_j, _ = jim2col.conv_patches(jnp.asarray(x), 3, 3, st, pads, dl)
    np.testing.assert_allclose(x2.numpy(), np.asarray(x2_j), rtol=1e-6, atol=1e-6)
    d = rng.standard_normal(x2.shape).astype(np.float32)
    np.testing.assert_allclose(col2im(torch.from_numpy(d)).numpy(),
                               np.asarray(col2im_j(jnp.asarray(d))), rtol=1e-5, atol=1e-5)


def test_asymmetric_padding_patches():
    """An asymmetric (lo, hi) padding ("SAME" at stride 2) pads the image
    first; x2 and col2im match the JAX package's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 2, 6, 6)).astype(np.float32)
    pads = ((0, 1), (0, 1))
    x2, col2im, _ = im2col.conv_patches(torch.from_numpy(x), 3, 3, (2, 2), pads, (1, 1))
    x2_j, col2im_j, _ = jim2col.conv_patches(jnp.asarray(x), 3, 3, (2, 2), pads, (1, 1))
    np.testing.assert_allclose(x2.numpy(), np.asarray(x2_j), rtol=1e-6, atol=1e-6)
    d = rng.standard_normal(x2.shape).astype(np.float32)
    np.testing.assert_allclose(col2im(torch.from_numpy(d)).numpy(),
                               np.asarray(col2im_j(jnp.asarray(d))), rtol=1e-5, atol=1e-5)


# --- dispatch ---------------------------------------------------------


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; a tensor elsewhere is
    the kernel's or an error, never a silent fall-back."""
    z = torch.zeros((4, 8), device="meta")
    i = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.dx_gathered(z, z, i, block_size=8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.dw_gathered(z, z, i, block_size=8)
    xg = torch.zeros((8, 1, 6, 2), device="meta")
    dy2r = torch.zeros((4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.conv_dw_fused(xg, dy2r, i, kh_dim=3, kw_dim=3, stride=(1, 1), dilation=(1, 1),
                          h_out=4, block_size=8)
    w2k = torch.zeros((3, 3, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.conv_dx_fused(dy2r, w2k, i, b=1, h_pad=6, w_pad=6, groups=1, stride=(1, 1),
                          dilation=(1, 1), block_size=8)


def test_plain_versions_count_no_launch():
    before = dict(tgm.launches)
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    tops.dx_gathered(dy, dy[:4].clone(), torch.tensor([0]), block_size=8)
    tops.dw_gathered_scatter(dy, dy, torch.tensor([0]), 8, block_size=8)
    assert tgm.launches == before


def test_every_kernel_has_a_source():
    names = {"dx_gathered", "dw_gathered", "conv_dw_fused", "conv_dx_fused", "matmul",
             "importance"}
    assert names <= set(build.sources())
    assert set(tgm.launches) == names
