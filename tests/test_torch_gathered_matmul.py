"""The port's gathered-matmul kernels against the JAX package's.

On the CPU each of the port's wrappers takes its kernel's plain version;
the JAX side runs its Pallas kernel in interpret mode
(``repro.kernels.ops`` picks that off the TPU), on the shapes of
``tests/test_kernels.py``. Inputs are made with numpy from a seed and
handed to both packages. Tolerances as there: fp32 1e-4, bf16 2e-2
(one bf16 rounding of each operand, fp32 sums in another order).
"""
import ctypes

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


class _Elsewhere(torch.Tensor):
    """A tensor that says it lies on a device the wrappers do not take."""

    @property
    def device(self):
        return torch.device("xpu", 0)


def _elsewhere(*shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(_Elsewhere, torch.zeros(shape, dtype=dtype))


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; a CUDA tensor is the
    kernel's and a meta tensor the meta route's (counted, not run); a
    tensor elsewhere is an error, never a silent fall-back."""
    z = _elsewhere(4, 8)
    i = _elsewhere(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.dx_gathered(z, z, i, block_size=8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.dw_gathered(z, z, i, block_size=8)
    xg = _elsewhere(8, 1, 6, 2)
    dy2r = _elsewhere(4, 4, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.conv_dw_fused(xg, dy2r, i, kh_dim=3, kw_dim=3, stride=(1, 1), dilation=(1, 1),
                          h_out=4, block_size=8)
    w2k = _elsewhere(3, 3, 2, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.conv_dx_fused(dy2r, w2k, i, b=1, hw=(4, 4), padding=((1, 1), (1, 1)), groups=1,
                          stride=(1, 1), dilation=(1, 1), block_size=8)


def test_meta_route_counts_the_launch_and_reports_its_spec():
    """A meta tensor takes the meta route: an empty output of the kernel's
    shape and dtype, one launch counted as the kernel's, and the launch's
    spec handed to the observer; the plain version does not run."""
    z = torch.zeros((4, 8), device="meta")
    i = torch.zeros((1,), dtype=torch.int32, device="meta")
    before = dict(tgm.launches)
    seen = []
    with tgm.observe_launches(launch=lambda n, a: seen.append((n, tuple(a))),
                              meta=lambda n, sp: seen.append((n, sp.name))):
        out = tgm.dx_gathered(z, z, i, block_size=8)
        dw = tgm.dw_gathered(z, z, i, block_size=8)
    assert out.device.type == "meta" and out.shape == (4, 4) and out.dtype == torch.float32
    assert dw.device.type == "meta" and dw.shape == (8, 8)
    assert tgm.launches["dx_gathered"] == before["dx_gathered"] + 1
    assert tgm.launches["dw_gathered"] == before["dw_gathered"] + 1
    assert seen[:2] == [("dx_gathered", (4, 8, 4, 1, 8, 0)), ("dx_gathered", "dx_gathered")]
    assert [n for n, _ in seen[2:]] == ["dw_gathered", "dw_gathered"]


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


@pytest.mark.parametrize("name", sorted(tgm._ARGTYPES))
def test_argtypes_match_the_c_entry_point(name):
    """The ctypes signature each wrapper declares is the one its
    ``extern "C" <name>_launch`` takes: pointers, ints, long longs in
    order (a mismatch shows only as a TypeError on the card)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    head = src[src.index(f'extern "C" int {name}_launch('):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = [kinds[" ".join(p.replace("const ", "").split()[:-1])] for p in params]
    assert tgm._ARGTYPES[name] == want


# --- conv_dw_fused's tensor-core arithmetic and split plan -------------


def test_tf32_rna_rounds_half_away_from_zero():
    """``cvt.rna.tf32``: 10 mantissa bits kept, the nearest value, ties away
    from zero (where round-to-even would go down), exact values unchanged."""
    e = 2.0**-10  # one TF32 unit in the last place at 1.0
    x = torch.tensor([1.0, 1 + e / 2, 1 + e / 2 - 2**-23, -(1 + e / 2), 1 + e + e / 2, 3.5, -0.0])
    want = [1.0, 1 + e, 1.0, -(1 + e), 1 + 2 * e, 3.5, -0.0]
    assert tgm.tf32_rna(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(7).standard_normal(1000).astype(np.float32))
    r = tgm.tf32_rna(y)
    assert not (r.view(torch.int32) & 0x1FFF).any()  # the low 13 bits cleared
    assert ((r - y).abs() <= y.abs() * 2.0**-11).all()  # within half a TF32 unit


def test_3xtf32_holds_the_kernel_gate_where_1xtf32_misses_it():
    """A block_0-like reduction (576 x 32768 @ 32768 x 64, seeded): the
    3-term split stays within 1e-4 * max(1, max|plain|) of the fp32
    product; plain TF32 (one term) does not, which is why the kernel
    pays for three."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((576, 32768)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32768, 64)).astype(np.float32))
    plain = a @ b
    limit = 1e-4 * max(1.0, plain.abs().max().item())
    assert (tgm.matmul_tf32_terms(a, b, terms=3) - plain).abs().max().item() <= limit
    assert (tgm.matmul_tf32_terms(a, b, terms=1) - plain).abs().max().item() > limit


# ResNet-18's fused 3x3 convs at B=128, 32x32: (positions R, rows P =
# 9*C_in, kept blocks, C_out)
DW_SITES = [
    (131072, 576, 1, 64), (32768, 576, 1, 128), (32768, 1152, 1, 128),
    (8192, 1152, 1, 256), (8192, 2304, 2, 256), (2048, 2304, 1, 512), (2048, 4608, 4, 512),
]


def _check_split_plan(plan, rows, work, min_rows):
    """A dW kernel's split-K plan: chunks of whole 32-row stages that cover
    every row once, none shorter than ``min_rows`` unless unsplit; the
    working tiles times S fit one wave of 4 x 132 slots, and S = 1 only
    where two splits would not fit or the rows are too few."""
    s, chunk = plan
    assert chunk % 32 == 0 and (s - 1) * chunk < rows <= s * chunk
    assert s == 1 or s * work <= 4 * 132
    assert s > 1 or work * 2 > 4 * 132 or rows <= min_rows
    assert chunk >= min_rows or s == 1
    return s, chunk


@pytest.mark.parametrize("rows,p,kb,c_out", DW_SITES)
def test_conv_dw_plan_covers_the_positions_in_one_wave(rows, p, kb, c_out):
    """conv_dw_fused: 64x64 tiles over P = 9*C_in rows, the ragged tail's
    phantom column tile doing no work; chunks of at least 256 positions."""
    work = -(-p // 64) * (kb * 2 - (1 if c_out % 128 else 0))
    _check_split_plan(tgm.conv_dw_plan(rows, p, kb, 128, c_out), rows, work, 256)


# the DDPM UNet's dW sites at B=128, 3x64x64, block 32 (rows, P or D_in,
# kept blocks, C_out): 524288-row reductions, where one wave's chunks
# would pass the cap
DDPM_DW_SITES = [(524288, 1152, 1, 64), (524288, 576, 1, 64), (524288, 576, 1, 3),
                 (131072, 1152, 1, 128), (131072, 2304, 1, 64)]


@pytest.mark.parametrize("rows,p,kb,c_out", DDPM_DW_SITES)
def test_dw_plans_cap_the_rows_one_accumulator_sums(rows, p, kb, c_out):
    """Where one wave's chunks would pass 4096 rows, both dW plans split
    further: chunks of whole 32-row stages, at most 4096 rows, covering
    every row once, and no more splits than the cap needs."""
    for plan, d in ((tgm.conv_dw_plan, p), (tgm.dw_plan, p // 9)):
        s, chunk = plan(rows, d, kb, 32, c_out)
        assert chunk % 32 == 0 and chunk <= 4096 and (s - 1) * chunk < rows <= s * chunk
        assert chunk < 4096 or s == -(-rows // 4096)  # capped: just enough splits
    assert tgm.conv_dw_plan(524288, 1152, 1, 32, 64) == (128, 4096)  # was (29, 18080)


def test_3xtf32_holds_the_gate_over_conv_dx_fuseds_reduction():
    """conv_dx_fused's reduction is taps x kept channels, 1152 long at a
    3x3 conv with 128 kept channels (seeded): 3xTF32 stays within 1e-4 *
    max(1, max|plain|) of the fp32 product, plain TF32 does not."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((1024, 1152)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1152, 64)).astype(np.float32))
    plain = a.double() @ b.double()
    limit = 1e-4 * max(1.0, plain.abs().max().item())
    assert (tgm.matmul_tf32_terms(a, b, terms=3).double() - plain).abs().max().item() <= limit
    assert (tgm.matmul_tf32_terms(a, b, terms=1).double() - plain).abs().max().item() > limit


def test_3xtf32_holds_the_gate_over_dx_gathereds_reduction():
    """dx_gathered at block_2/down (dY [32768, 128 kept] @ W [64, 128]^T,
    seeded normals as the smoke test draws them): over its K = 128
    reduction 3xTF32 stays within 1e-4 * max(1, max|plain|) of the fp64
    product, plain TF32 does not."""
    rng = np.random.default_rng(10)
    dy = torch.from_numpy(rng.standard_normal((32768, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    plain = dy.double() @ w.double().T
    limit = 1e-4 * max(1.0, plain.abs().max().item())
    assert (tgm.matmul_tf32_terms(dy, w.T, terms=3).double() - plain).abs().max().item() <= limit
    assert (tgm.matmul_tf32_terms(dy, w.T, terms=1).double() - plain).abs().max().item() > limit


# ResNet-18's 1x1 down convs and stem at B=128, 32x32 (rows M, D_in,
# kept blocks, C_out): dw_gathered's main-path shapes
DWG_SITES = [(131072, 27, 1, 64), (32768, 64, 1, 128), (8192, 128, 1, 256), (2048, 256, 1, 512)]


@pytest.mark.parametrize("m,d,kb,n", DWG_SITES + [(200, 130, 2, 512), (96, 27, 1, 64),
                                                  (4099, 27, 1, 64), (1000, 33, 2, 44)])
def test_dw_plan_fills_one_wave_with_aligned_chunks(m, d, kb, n):
    """Chunks of whole 32-row stages that cover every row once, each
    starting on 16 bytes of X at any row length (a multiple of 8 rows);
    only the working tiles get split blocks (the stem: one of its two
    column tiles, and half its rows), and those times S fit two blocks
    an SM (4 x 132 halves of tiles)."""
    bs = 128 if n >= 64 else 8
    col_tiles = kb * -(-bs // 64)
    tail = n % bs
    work = -(-d // 32) * (col_tiles - ((-(-bs // 64) - -(-tail // 64)) if tail else 0))
    _, chunk = _check_split_plan(tgm.dw_plan(m, d, kb, bs, n), m, work, 128)
    assert (chunk * d * 4) % 16 == 0 and (chunk * d * 2) % 16 == 0


def test_dw_plan_gives_the_stems_phantom_tile_no_splits():
    """The stem (C=64 in one 128-channel block): one working 64x64 tile,
    so it takes twice the splits of a full block's two."""
    s_stem, _ = tgm.dw_plan(131072, 27, 1, 128, 64)
    s_full, _ = tgm.dw_plan(131072, 27, 1, 128, 128)
    assert s_stem == 2 * s_full


_ORDER_GEOMS = [
    # (B, H, W, padding, stride, dilation)
    (2, 9, 9, ((1, 1), (1, 1)), (1, 1), (1, 1)),
    (2, 9, 7, ((1, 1), (1, 1)), (2, 2), (1, 1)),
    (3, 8, 8, ((1, 1), (1, 1)), (2, 2), (1, 1)),
    (2, 9, 9, ((0, 0), (0, 0)), (1, 1), (2, 2)),
    (2, 9, 9, ((2, 2), (2, 2)), (2, 2), (2, 2)),
    (1, 6, 6, ((0, 1), (0, 1)), (2, 2), (1, 1)),
    (2, 5, 6, ((2, 0), (1, 1)), (2, 1), (1, 2)),
]


def conv_dx_phases(h, w, padding, stride):
    """``(ih0, nh, iw0, nw)`` of each stride phase of the interior image, in
    conv_dx_fused.cu's order (row residue outer; its ``phase_axis``): the
    interior rows ``ih0 + i*sh`` (``i < nh``) are those with ``(ih + ph0)
    % sh == ph``, and the same for the columns."""
    (ph0, _), (pw0, _) = padding
    sh, sw = stride

    def axis(r, lo, s, n):
        i0 = (r - lo) % s
        return i0, (-(-(n - i0) // s) if i0 < n else 0)

    return [(*axis(ph, ph0, sh, h), *axis(pw, pw0, sw, w))
            for ph in range(sh) for pw in range(sw)]


def conv_dx_taps(phase, kernel, dilation, stride):
    """Taps ``(kh, kw)`` a pixel of residue ``phase = ((ih + ph0) % sh,
    (iw + pw0) % sw)`` can receive, as conv_dx_fused.cu's ``nth_tap``
    enumerates them: ``kh*dh`` congruent to the row residue modulo
    ``sh``, and the same for the columns."""
    (kh_dim, kw_dim), (dh, dw), (sh, sw) = kernel, dilation, stride
    return [(kh, kw) for kh in range(kh_dim) for kw in range(kw_dim)
            if (kh * dh) % sh == phase[0] and (kw * dw) % sw == phase[1]]


def conv_dx_pixel_order(b, h, w, padding, stride):
    """The output rows of conv_dx_fused's implicit GEMM, tile by tile, as
    the kernel decodes them from the phases: each 64-row tile is a list
    of interior pixels ``(b, ih, iw)`` (None for the padding rows that
    end a phase), one phase's pixels in ``(b, ih, iw)`` order."""
    sh, sw = stride
    tiles = []
    for ih0, nh, iw0, nw in conv_dx_phases(h, w, padding, stride):
        pix = [(bb, ih0 + i * sh, iw0 + jw * sw)
               for bb in range(b) for i in range(nh) for jw in range(nw)]
        pix += [None] * ((-len(pix)) % 64)
        tiles += [pix[t:t + 64] for t in range(0, len(pix), 64)]
    return tiles


@pytest.mark.parametrize("b,h,w,padding,stride,dilation", _ORDER_GEOMS)
def test_conv_dx_pixel_order_matches_brute_force(b, h, w, padding, stride, dilation):
    """The kernel's interior phase-major order, mirrored in Python: every
    interior pixel exactly once, none of the padding ring; each 64-row
    tile inside one phase, whose pixels all can receive the same taps
    (brute force over every tap), and the phase's tap list is that set."""
    (ph0, _), (pw0, _) = padding
    tiles = conv_dx_pixel_order(b, h, w, padding, stride)
    assert all(len(t) == 64 for t in tiles)
    pix = [p for t in tiles for p in t if p is not None]
    assert sorted(pix) == [(bb, i, j) for bb in range(b) for i in range(h) for j in range(w)]
    sh, sw = stride

    def taps(ih, iw):  # brute force: the taps whose output position is whole
        return {(kh, kw) for kh in range(3) for kw in range(3)
                if (ih + ph0 - kh * dilation[0]) % sh == 0
                and (iw + pw0 - kw * dilation[1]) % sw == 0}

    for t in tiles:
        real = [p for p in t if p is not None]
        assert real and t[:len(real)] == real  # padding rows only end a phase
        phases = {((ih + ph0) % sh, (iw + pw0) % sw) for _, ih, iw in real}
        assert len(phases) == 1
        want = taps(*real[0][1:])
        assert all(taps(ih, iw) == want for _, ih, iw in real)
        assert set(conv_dx_taps(phases.pop(), (3, 3), dilation, stride)) == want
    if stride == (2, 2) and dilation == (1, 1):  # a quarter of the taps on average
        n = sum(len(conv_dx_taps((a, c), (3, 3), dilation, stride))
                for a in range(2) for c in range(2))
        assert n == 9


# ResNet-18's 3x3 dX sites at B=128 (C_in, C_out, H, stride, KB)
DX_SITES = [(64, 64, 32, 1, 1), (64, 128, 32, 2, 1), (128, 128, 16, 1, 1), (128, 256, 16, 2, 1),
            (256, 256, 8, 1, 1), (256, 512, 8, 2, 1), (512, 512, 4, 1, 1)]


@pytest.mark.parametrize("site", DX_SITES)
def test_conv_dx_phases_pad_only_their_last_tile(site):
    """At each main-path site the kernel's grid (row tiles of every phase)
    covers the B*H*W interior pixels with less than one padded tile a
    phase, and no tile of the padding ring: at stride 2 four phases of
    H/2 x H/2 pixels each."""
    c_in, c_out, h, stride, kb = site
    phases = conv_dx_phases(h, h, ((1, 1), (1, 1)), (stride, stride))
    assert len(phases) == stride * stride
    assert sum(nh * nw for _, nh, _, nw in phases) == h * h
    assert all(nh == nw == h // stride for _, nh, _, nw in phases)
    rows = sum(-(-128 * nh * nw // 64) for _, nh, _, nw in phases)
    assert 128 * h * h <= rows * 64 < 128 * h * h + 64 * stride * stride


def _conv_dx_brute(dy2r, w2k, bidx, *, b, hw, padding, groups, stride, dilation, bs):
    """The interior dX from its definition, one pixel and tap at a time."""
    h, w = hw
    (ph0, _), (pw0, _) = padding
    (sh, sw), (dh, dw) = stride, dilation
    kh_dim, kw_dim, cg, _ = w2k.shape
    m2, w_out, c_pad = dy2r.shape
    h_out = m2 // b
    bpg = c_pad // bs // groups
    out = np.zeros((b, h, groups, w, cg), np.float64)
    for bb in range(b):
        for ih in range(h):
            for iw in range(w):
                for kh in range(kh_dim):
                    for kw in range(kw_dim):
                        oh, rh = divmod(ih + ph0 - kh * dh, sh)
                        ow, rw = divmod(iw + pw0 - kw * dw, sw)
                        if rh or rw or not (0 <= oh < h_out and 0 <= ow < w_out):
                            continue
                        for j, blk in enumerate(bidx):
                            dyv = dy2r[bb * h_out + oh, ow, blk * bs:(blk + 1) * bs]
                            out[bb, ih, blk // bpg, iw] += w2k[kh, kw, :, j * bs:(j + 1) * bs] @ dyv
    return out.reshape(b * h, groups, w, cg)


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, ((1, 1), (1, 1)), 1, 1), (2, ((1, 1), (1, 1)), 1, 1), (1, ((0, 0), (0, 0)), 2, 1),
    (2, ((1, 1), (1, 1)), 2, 2), (2, ((0, 1), (0, 1)), 1, 1), (1, ((2, 0), (1, 1)), 1, 2),
])
def test_conv_dx_fused_returns_the_interior_image(stride, padding, dilation, groups):
    """``gm.conv_dx_fused``'s contract: ``[B*H, G, W, Cg]``, the interior
    image only, equal to the definition summed pixel by pixel."""
    rng = np.random.default_rng(11)
    b, h, w, cg, bs, k = 2, 7, 6, 3, 4, 3
    (ph0, ph1), (pw0, pw1) = padding
    h_out = (h + ph0 + ph1 - dilation * (k - 1) - 1) // stride + 1
    w_out = (w + pw0 + pw1 - dilation * (k - 1) - 1) // stride + 1
    c_pad = 16
    bidx = np.asarray([0, 2] if groups == 1 else [1, 2], np.int32)
    dy2r = rng.standard_normal((b * h_out, w_out, c_pad)).astype(np.float32)
    w2k = rng.standard_normal((k, k, cg, len(bidx) * bs)).astype(np.float32)
    kw = dict(b=b, hw=(h, w), padding=padding, groups=groups, stride=(stride, stride),
              dilation=(dilation, dilation))
    out = tgm.conv_dx_fused(torch.from_numpy(dy2r), torch.from_numpy(w2k),
                            torch.from_numpy(bidx), block_size=bs, **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b * h, groups, w, cg)
    want = _conv_dx_brute(dy2r, w2k, bidx, bs=bs, **kw)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
