"""The port's CUDA kernels against their plain versions, on the card.

``paged_attention``, the four gathered-matmul kernels of the ssProp
backward (``dx_gathered``, ``dw_gathered``, ``conv_dw_fused``,
``conv_dx_fused``), and ``matmul`` and ``importance`` of the
channel-granularity dense backward.

Every test here is marked ``cuda``: it needs a CUDA card and skips
without one (a CUDA kernel has no CPU mode). The file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is
installed (``--noconftest`` skips the JAX-importing ``conftest.py``):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gathered_matmul as tgm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

pytestmark = pytest.mark.cuda

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, *, b=4, s=3, h=16, kv=2, d=128, n_pages=24, bs=16, nb=6,
            q_dtype="bfloat16", pool_dtype="float32", seed=22):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    tables = rng.integers(0, n_pages, (b, nb)).astype(np.int32)
    t = nb * bs
    # mid-page, page boundary, deep, middle; no row before position 0
    offs = [max(0, o) for o in (7, 2 * bs, t - s, t // 2 + 3)][:b]
    qpos = (np.asarray(offs)[:, None] + np.arange(s)).astype(np.int32)
    return (
        torch.from_numpy(q).to(dev, _DT[q_dtype]),
        torch.from_numpy(k).to(dev, _DT[pool_dtype]),
        torch.from_numpy(v).to(dev, _DT[pool_dtype]),
        torch.from_numpy(tables).to(dev),
        torch.from_numpy(qpos).to(dev),
    )


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    ("bfloat16", "float32"), ("float32", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
])
@pytest.mark.parametrize("d,bs,s", [(128, 16, 1), (128, 16, 32), (32, 4, 5), (32, 8, 2), (128, 8, 3)])
def test_kernel_matches_plain(cuda, q_dtype, pool_dtype, d, bs, s):
    """Raw fp32 outputs at rtol=atol=1e-4 (summation order), and one
    launch counted per call."""
    args = _inputs(cuda, d=d, bs=bs, s=s, q_dtype=q_dtype, pool_dtype=pool_dtype)
    before = tpa.launches
    out = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)


_PAIRS = [("bfloat16", "float32"), ("float32", "float32"), ("bfloat16", "bfloat16"),
          ("float32", "bfloat16")]


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("q_dtype,pool_dtype", _PAIRS)
@pytest.mark.parametrize("nb", [1, 10, 128])
@pytest.mark.parametrize("s", [1, 32])
def test_split_kv_matches_plain_and_repeats(cuda, s, nb, q_dtype, pool_dtype, forced):
    """qwen2.5-3b's heads (H=16, KV=2, D=128, 16-token pages) at decode
    and at a 32-row prefill chunk, over 1, 10 and 128 pages a slot, with
    the plan's splits or one forced: within rtol=atol=1e-4 of the plain
    version, one launch counted, and the same bits on a second call."""
    args = _inputs(cuda, s=s, nb=nb, n_pages=4 * nb, q_dtype=q_dtype, pool_dtype=pool_dtype,
                   seed=23)
    splits = 1 if forced else None
    if not forced and nb > 1:
        assert tpa.paged_split_plan(4, s, 16, 2, 128, nb, 16).splits > 1
    before = tpa.launches
    out = tpa.paged_attention(*args, splits=splits)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(out, tpa.paged_attention(*args, splits=splits))


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("row_tile", [8, 16, 64])
@pytest.mark.parametrize("s", [1, 7, 32])
def test_every_row_tile_matches_plain_and_repeats(cuda, s, row_tile, d):
    """Each variant at any row count and every power-of-two head dim: the
    SIMT 8- and 16-row tiles and the 64-row tensor-core tiles, at their
    own plans, over 10 pages."""
    args = _inputs(cuda, s=s, d=d, nb=10, n_pages=40, seed=25)
    out = tpa.paged_attention(*args, row_tile=row_tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(out, tpa.paged_attention(*args, row_tile=row_tile))


@pytest.mark.parametrize("s", [1, 32])
def test_more_splits_than_chunks_leave_empty_splits_out(cuda, s):
    """Splits past a slot's last chunk see no key and contribute nothing:
    40 splits over 10-page slots whose horizons hold 1 to 5 32-key chunks
    give the plain version's output; more splits than the combine pass
    stages are refused."""
    args = _inputs(cuda, s=s, nb=10, n_pages=40, seed=24)
    out = tpa.paged_attention(*args, splits=40)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="splits"):
        tpa.paged_attention(*args, splits=tpa.MAX_SPLITS + 1)


def test_kernel_ignores_garbage_table_entries(cuda):
    q, k, v, tables, _ = _inputs(cuda, s=1)
    qpos = torch.tensor([[2], [5], [17], [30]], dtype=torch.int32, device=cuda)
    bad = tables.clone()
    bad[:, 2:] = torch.tensor([999, -7, 999, -7], dtype=torch.int32, device=cuda)[:, None]
    assert torch.equal(tpa.paged_attention(q, k, v, tables, qpos),
                       tpa.paged_attention(q, k, v, bad, qpos))


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, tables, qpos = _inputs(cuda)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), k, v, tables, qpos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q, k, v, tables.long(), qpos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k, v, tables.t().contiguous().t(), qpos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k.cpu(), v.cpu(), tables, qpos)
    q96, k96, v96, _, _ = _inputs(cuda, d=96)  # no ported config has head_dim 96
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(q96, k96, v96, tables, qpos)


# whisper's heads (H = KV = 20, D = 64: one query row a KV head at decode)
# and paligemma's (H = 8 over one KV head, D = 256: chunks of 16 keys)
_NEW_HEADS = {"whisper": (20, 20, 64), "paligemma": (8, 1, 256)}


@pytest.mark.parametrize("q_dtype,pool_dtype", _PAIRS)
@pytest.mark.parametrize("nb", [10, 128])
@pytest.mark.parametrize("s", [1, 5, 32])
@pytest.mark.parametrize("heads", sorted(_NEW_HEADS))
def test_new_head_dims_match_plain_and_repeat(cuda, heads, s, nb, q_dtype, pool_dtype):
    """D=64 and D=256 at the two archs' head shapes, at decode, a
    spec_k=4 verify chunk and a 32-token prefill chunk, over 10 and 128
    pages a slot, every q/pool dtype pair, at the plan's tile and splits:
    within rtol=atol=1e-4 of the plain version and 1e-4 * max(1,
    max|plain|), one launch counted, the same bits on a second call, and
    no more splits than the combine pass stages."""
    h, kv, d = _NEW_HEADS[heads]
    args = _inputs(cuda, s=s, h=h, kv=kv, d=d, nb=nb, n_pages=4 * nb, q_dtype=q_dtype,
                   pool_dtype=pool_dtype, seed=26)
    plan = tpa.paged_split_plan(4, s, h, kv, d, nb, 16)
    assert plan.chunk == 4096 // d and 1 <= plan.splits <= tpa.MAX_SPLITS
    before = tpa.launches
    out = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    ref = tpa.paged_attention_ref(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert torch.equal(out, tpa.paged_attention(*args))


# --- the gathered-matmul kernels of the ssProp backward ---------------


def _close(out, ref):
    """Raw fp32 outputs within 1e-4 * max(1, max|plain|): summation
    order only (split-K, panel order)."""
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


def _randn(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(_DT[dtype])


# (M, N, D_in, kept blocks, block size): ragged M and D_in, a ragged
# channel tail (the stem's C=64 in one 128-block), KB > 1 non-contiguous
GATHERED = [
    (200, 512, 130, [1, 3], 128),
    (96, 64, 27, [0], 128),
    (1000, 44, 33, [1, 5], 8),
    (4099, 256, 64, [0], 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,blocks,bs", GATHERED)
def test_dx_gathered_kernel_matches_plain(cuda, m, n, d, blocks, bs, dtype):
    dy, w = _randn(cuda, (m, n), dtype, 1), _randn(cuda, (d, n), dtype, 2)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    before = tgm.launches["dx_gathered"]
    out = tgm.dx_gathered(dy, w, bidx, block_size=bs)
    torch.cuda.synchronize()
    assert tgm.launches["dx_gathered"] == before + 1
    _close(out, tgm.dx_gathered_ref(dy, w, bidx, block_size=bs))


# (M, N, D_in, kept blocks): dx_gathered at a sparse ResNet-18 step, B=128:
# the three 1x1 stride-2 down convs
DX_DOWN = [(32768, 128, 64, [0]), (8192, 256, 128, [1]), (2048, 512, 256, [3])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,blocks", DX_DOWN)
def test_dx_gathered_down_convs_match_plain_and_repeat(cuda, m, n, d, blocks, dtype):
    """The tensor-core kernel at the main path's shapes: within 1e-4 *
    max(1, max|plain|), one launch counted, the same bits on a second
    call (each output written once, in a fixed order)."""
    dy, w = _randn(cuda, (m, n), dtype, 48), _randn(cuda, (d, n), dtype, 49)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    before = tgm.launches["dx_gathered"]
    out = tgm.dx_gathered(dy, w, bidx)
    torch.cuda.synchronize()
    assert tgm.launches["dx_gathered"] == before + 1
    _close(out, tgm.dx_gathered_ref(dy, w, bidx))
    assert torch.equal(out, tgm.dx_gathered(dy, w, bidx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_dx_gathered_operands_aligned_or_not(cuda, offset, dtype):
    """dY and W at a 16-byte start (16-byte copies) or one element past
    it (element loads), KB = 2 of 4 with the tail block ragged."""
    m, n, d = 300, 500, 70
    dy = _randn(cuda, (m * n + offset,), dtype, 50)[offset:].view(m, n)
    w = _randn(cuda, (d * n + offset,), dtype, 51)[offset:].view(d, n)
    assert (dy.data_ptr() % 16 == 0) == (offset == 0)
    bidx = torch.tensor([1, 3], dtype=torch.int32, device=cuda)
    out = tgm.dx_gathered(dy, w, bidx)
    torch.cuda.synchronize()
    _close(out, tgm.dx_gathered_ref(dy, w, bidx))
    assert torch.equal(out, tgm.dx_gathered(dy, w, bidx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,blocks,bs", GATHERED)
def test_dw_gathered_kernel_matches_plain(cuda, m, n, d, blocks, bs, dtype):
    x, dy = _randn(cuda, (m, d), dtype, 3), _randn(cuda, (m, n), dtype, 4)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    before = tgm.launches["dw_gathered"]
    out = tgm.dw_gathered(x, dy, bidx, block_size=bs)
    torch.cuda.synchronize()
    assert tgm.launches["dw_gathered"] == before + 1
    _close(out, tgm.dw_gathered_ref(x, dy, bidx, block_size=bs))
    full = tops.dw_gathered_scatter(x, dy, bidx, n, block_size=bs)
    kept = {c for b in blocks for c in range(b * bs, min((b + 1) * bs, n))}
    assert not full[:, sorted(set(range(n)) - kept)].any()  # dropped blocks exactly 0


# (stride, padding, dilation, groups, C_in, C_out, block size, kept blocks)
CONV = [
    (1, 1, 1, 1, 6, 16, 4, [0, 2]),
    (2, 1, 1, 1, 6, 10, 4, [0, 2]),  # stride 2, ragged channel tail
    (1, 0, 2, 1, 6, 16, 4, [1, 3]),
    (1, 1, 1, 2, 6, 16, 4, [0, 2]),  # groups 2, one block each
    (2, 1, 2, 2, 6, 16, 4, [1, 2]),
    (1, 1, 1, 1, 64, 64, 128, [0]),  # the main path's ragged C=64 block
    (2, 1, 1, 1, 64, 256, 128, [1]),
    (1, 1, 1, 1, 128, 512, 128, [0, 3]),  # KB=2 of 4, non-contiguous
]


def _conv_geometry(stride, padding, dilation, c_in, groups, b=2, h=9, k=3):
    h_pad = h + 2 * padding
    h_out = (h_pad - dilation * (k - 1) - 1) // stride + 1
    return dict(b=b, h_pad=h_pad, h_out=h_out, cg=c_in // groups)


def _dy2r(dev, b, h_out, c_out, bs, dtype, seed):
    c_pad = c_out + (-c_out) % bs
    dy = torch.zeros((b * h_out, h_out, c_pad), device=dev, dtype=_DT[dtype])
    dy[..., :c_out] = _randn(dev, (b * h_out, h_out, c_out), dtype, seed)
    return dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,padding,dilation,groups,c_in,c_out,bs,blocks", CONV)
def test_conv_dw_fused_kernel_matches_plain(cuda, stride, padding, dilation, groups, c_in,
                                            c_out, bs, blocks, dtype):
    g = _conv_geometry(stride, padding, dilation, c_in, groups)
    xg = _randn(cuda, (g["b"] * g["h_pad"], groups, g["h_pad"], g["cg"]), dtype, 5)
    dy2r = _dy2r(cuda, g["b"], g["h_out"], c_out, bs, dtype, 6)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    kw = dict(kh_dim=3, kw_dim=3, stride=(stride, stride), dilation=(dilation, dilation),
              h_out=g["h_out"], block_size=bs)
    before = tgm.launches["conv_dw_fused"]
    out = tgm.conv_dw_fused(xg, dy2r, bidx, c_out=c_out, **kw)
    torch.cuda.synchronize()
    assert tgm.launches["conv_dw_fused"] == before + 1
    _close(out, tgm.conv_dw_fused_ref(xg, dy2r, bidx, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,padding,dilation,groups,c_in,c_out,bs,blocks", CONV)
def test_conv_dx_fused_kernel_matches_plain(cuda, stride, padding, dilation, groups, c_in,
                                            c_out, bs, blocks, dtype):
    g = _conv_geometry(stride, padding, dilation, c_in, groups)
    dy2r = _dy2r(cuda, g["b"], g["h_out"], c_out, bs, dtype, 7)
    w2k = _randn(cuda, (3, 3, g["cg"], len(blocks) * bs), dtype, 8)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    h = g["h_pad"] - 2 * padding
    kw = dict(b=g["b"], hw=(h, h), padding=((padding, padding), (padding, padding)),
              groups=groups, stride=(stride, stride), dilation=(dilation, dilation),
              block_size=bs)
    before = tgm.launches["conv_dx_fused"]
    out = tgm.conv_dx_fused(dy2r, w2k, bidx, c_out=c_out, **kw)
    torch.cuda.synchronize()
    assert tgm.launches["conv_dx_fused"] == before + 1
    _close(out, tgm.conv_dx_fused_ref(dy2r, w2k, bidx, **kw))


# (stride, C_in, C_out, H, kept blocks): ResNet-18's 3x3 convs at B=4, one
# per stage geometry (the stride-2 first conv of stages 2-4 too), on the
# fast loads (64-row tiles inside one tap); C_out=64 is the ragged tail
STAGES = [
    (1, 64, 64, 32, [0]),
    (2, 64, 128, 32, [0]),
    (1, 128, 128, 16, [0]),
    (2, 128, 256, 16, [1]),
    (1, 256, 256, 8, [0, 1]),
    (2, 256, 512, 8, [2]),
    (1, 512, 512, 4, [0, 3]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,c_in,c_out,h,blocks", STAGES)
def test_conv_dw_fused_resnet_stages_match_plain_and_repeat(cuda, stride, c_in, c_out, h,
                                                             blocks, dtype):
    """The tensor-core kernel (3xTF32 for fp32) at each stage's geometry:
    within 1e-4 * max(1, max|plain|) of the fp32 plain version, and the
    same bits on a second call (fixed split-K order)."""
    g = _conv_geometry(stride, 1, 1, c_in, 1, b=4, h=h)
    xg = _randn(cuda, (g["b"] * g["h_pad"], 1, g["h_pad"], c_in), dtype, 20)
    dy2r = _dy2r(cuda, g["b"], g["h_out"], c_out, 128, dtype, 21)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    kw = dict(kh_dim=3, kw_dim=3, stride=(stride, stride), dilation=(1, 1), h_out=g["h_out"],
              block_size=128)
    out = tgm.conv_dw_fused(xg, dy2r, bidx, c_out=c_out, **kw)
    torch.cuda.synchronize()
    _close(out, tgm.conv_dw_fused_ref(xg, dy2r, bidx, **kw))
    assert torch.equal(out, tgm.conv_dw_fused(xg, dy2r, bidx, c_out=c_out, **kw))


# ResNet-18's 3x3 dX sites of a sparse step at B=128 (stride, C_in, C_out,
# H, kept blocks) and three at B=4 (few row tiles)
DX_MAIN = [(s, ci, co, h, bl, 128) for s, ci, co, h, bl in STAGES] + [
    (1, 512, 512, 4, [1], 4), (2, 256, 512, 8, [3], 4), (1, 64, 64, 32, [0], 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,c_in,c_out,h,blocks,b", DX_MAIN)
def test_conv_dx_fused_resnet_shapes_match_plain_and_repeat(cuda, stride, c_in, c_out, h,
                                                            blocks, b, dtype):
    """The implicit GEMM on the tensor cores (3xTF32 for fp32) at each
    stage's geometry: within 1e-4 * max(1, max|plain|) of the fp32 plain
    version, one launch counted, the same bits on a second call."""
    pads = ((1, 1), (1, 1))
    h_out = (h + 2 - 3) // stride + 1
    dy2r = _dy2r(cuda, b, h_out, c_out, 128, dtype, 40)
    w2k = _randn(cuda, (3, 3, c_in, len(blocks) * 128), dtype, 41)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    kw = dict(b=b, hw=(h, h), padding=pads, groups=1, stride=(stride, stride), dilation=(1, 1),
              block_size=128)
    before = tgm.launches["conv_dx_fused"]
    out = tgm.conv_dx_fused(dy2r, w2k, bidx, c_out=c_out, **kw)
    torch.cuda.synchronize()
    assert tgm.launches["conv_dx_fused"] == before + 1
    assert out.shape == (b * h, 1, h, c_in)
    _close(out, tgm.conv_dx_fused_ref(dy2r, w2k, bidx, **kw))
    assert torch.equal(out, tgm.conv_dx_fused(dy2r, w2k, bidx, c_out=c_out, **kw))


def test_conv_dx_fused_odd_channels_and_unequal_phases(cuda):
    """Cg = 67 (odd: no paired stores, a ragged column tile), H = 9, W = 7
    at stride 2 with an asymmetric padding (phases of four sizes), bs = 32
    (16-byte copies, a 32-channel stage a block) and a ragged tail."""
    pads = ((0, 1), (1, 0))
    b, h, w, cg, c_out, bs = 3, 9, 7, 67, 80, 32
    h_out = (h + 1 - 3) // 2 + 1
    w_out = (w + 1 - 3) // 2 + 1
    dy = torch.zeros((b * h_out, w_out, 96), device=cuda)
    dy[..., :c_out] = _randn(cuda, (b * h_out, w_out, c_out), "float32", 42)
    w2k = _randn(cuda, (3, 3, cg, 2 * bs), "float32", 43)
    bidx = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    kw = dict(b=b, hw=(h, w), padding=pads, groups=1, stride=(2, 2), dilation=(1, 1),
              block_size=bs)
    out = tgm.conv_dx_fused(dy, w2k, bidx, c_out=c_out, **kw)
    torch.cuda.synchronize()
    _close(out, tgm.conv_dx_fused_ref(dy, w2k, bidx, **kw))


# (M, D_in, N, kept blocks): dw_gathered at a sparse ResNet-18 step, B=128:
# the stem (27 columns of X, 108-byte rows: slab copies; C=64 in one
# 128-channel block) and the three 1x1 down convs
DW_MAIN = [(131072, 27, 64, [0]), (32768, 64, 128, [0]), (8192, 128, 256, [1]),
           (2048, 256, 512, [3])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,n,blocks", DW_MAIN)
def test_dw_gathered_resnet_shapes_match_plain_and_repeat(cuda, m, d, n, blocks, dtype):
    """The tensor-core split-K at the main path's shapes (every one splits:
    S > 1): within 1e-4 * max(1, max|plain|), one launch counted, the
    same bits on a second call (fixed two-level sum of the partials)."""
    x, dy = _randn(cuda, (m, d), dtype, 44), _randn(cuda, (m, n), dtype, 45)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    assert tgm.dw_plan(m, d, len(blocks), 128, n)[0] > 1
    before = tgm.launches["dw_gathered"]
    out = tgm.dw_gathered(x, dy, bidx)
    torch.cuda.synchronize()
    assert tgm.launches["dw_gathered"] == before + 1
    _close(out, tgm.dw_gathered_ref(x, dy, bidx))
    assert torch.equal(out, tgm.dw_gathered(x, dy, bidx))
    if n < 128:  # the phantom columns of the ragged block: exactly 0
        assert not out[:, n:].any() and out[:, :n].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,offset", [(4099, 0), (4099, 1), (96, 0), (96, 1)])
def test_dw_gathered_stem_rows_aligned_or_not(cuda, m, offset, dtype):
    """D = 27: X at a 16-byte start (slab copies; M = 4099 ends mid-slab)
    or one element past it (a chunk start that is not 16-byte aligned:
    the element-wise loads); S > 1 and S = 1."""
    buf = _randn(cuda, (m * 27 + offset,), dtype, 46)
    x = buf[offset:].view(m, 27)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    dy = _randn(cuda, (m, 64), dtype, 47)
    bidx = torch.tensor([0], dtype=torch.int32, device=cuda)
    assert (tgm.dw_plan(m, 27, 1, 128, 64)[0] > 1) == (m > 128)
    out = tgm.dw_gathered(x, dy, bidx)
    torch.cuda.synchronize()
    _close(out, tgm.dw_gathered_ref(x, dy, bidx))
    assert torch.equal(out, tgm.dw_gathered(x, dy, bidx))


def test_conv_dw_fused_scatter_keeps_dropped_blocks_zero(cuda):
    """The ragged C=64 block and KB=2 of 4: after the scatter the dropped
    blocks are exactly 0 and the kept ones are not."""
    x = _randn(cuda, (4, 128, 8, 8), "float32", 22)
    dy = _randn(cuda, (4, 512, 8, 8), "float32", 23)
    bidx = torch.tensor([1, 3], dtype=torch.int32, device=cuda)
    dw = tops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1),
                                    padding=((1, 1), (1, 1)), dilation=(1, 1), groups=1)
    torch.cuda.synchronize()
    dropped = torch.cat([torch.arange(0, 128), torch.arange(256, 384)]).to(cuda)
    kept = torch.cat([torch.arange(128, 256), torch.arange(384, 512)]).to(cuda)
    assert not dw[:, dropped].any() and dw[:, kept].all()


def test_gathered_wrappers_raise_never_fall_back(cuda):
    dy, w = _randn(cuda, (64, 128), "float32", 9), _randn(cuda, (32, 128), "float32", 10)
    bidx = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # fp16 is not a kernel operand type
        tgm.dx_gathered(dy.half(), w.half(), bidx)
    with pytest.raises(TypeError):  # operands of two types
        tgm.dx_gathered(dy, w.bfloat16(), bidx)
    with pytest.raises(TypeError):
        tgm.dw_gathered(dy, dy, bidx.long())
    with pytest.raises(ValueError, match="contiguous"):
        tgm.dx_gathered(dy.t().contiguous().t(), w, bidx)
    with pytest.raises(ValueError):
        tgm.dw_gathered(dy, dy.cpu(), bidx)
    xg = _randn(cuda, (2 * 10, 1, 10, 6), "float32", 11)
    dy2r = _randn(cuda, (2 * 8, 8, 8), "float32", 12)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.conv_dw_fused(xg[:, :, :, :3], dy2r, bidx, kh_dim=3, kw_dim=3, stride=(1, 1),
                          dilation=(1, 1), h_out=8, block_size=8)
    with pytest.raises(TypeError):
        tgm.conv_dx_fused(dy2r, _randn(cuda, (3, 3, 6, 8), "bfloat16", 13), bidx, b=2,
                          hw=(8, 8), padding=((1, 1), (1, 1)), groups=1, stride=(1, 1),
                          dilation=(1, 1), block_size=8)


# --- matmul and importance ----------------------------------------------

# (M, K, N): ragged every way, K not a multiple of 16, and the main path's
# qwen2.5-3b products (M = 1024 tokens; K = 410, 51, 2202 kept channels)
MATMUL = [
    (1, 1, 1), (200, 384, 130), (64, 51, 2048), (333, 17, 65),
    (1024, 410, 2048), (1024, 2202, 2048), (2048, 1024, 51), (11008, 1024, 410),
]


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", MATMUL)
def test_matmul_kernel_matches_plain(cuda, m, k, n, dtype, layout):
    """Operands as the backward hands them over: contiguous (``nn``), B a
    transposed view (``nt``: ``w_k.T``), A a transposed view (``tn``:
    ``x2.T``); raw fp32 outputs within 1e-4 * max(1, max|plain|)."""
    a = _randn(cuda, (k, m) if layout == "tn" else (m, k), dtype, 14)
    b = _randn(cuda, (n, k) if layout == "nt" else (k, n), dtype, 15)
    a = a.T if layout == "tn" else a
    b = b.T if layout == "nt" else b
    before = tgm.launches["matmul"]
    out = tops.matmul(a, b)
    torch.cuda.synchronize()
    assert tgm.launches["matmul"] == before + 1
    _close(out, tgm.matmul_ref(a, b))


def _aligned(dev, shape, dtype, seed):
    """A row-major [R, C] view whose pitch is C rounded up to 8, as
    ``gather_columns`` hands the backward's operands over."""
    r, c = shape
    buf = _randn(dev, (r, c + (-c) % 8), dtype, seed)
    return buf[:, :c]


# the eight products of a sparse qwen2.5-3b step (K kept = 410, 51, 2202 of
# d_out; d_in = 2048 or 11008), at M = B*S = 256 tokens: (name, M, K, N)
LM_PRODUCTS = [
    ("dX q,o", 256, 410, 2048), ("dX k,v", 256, 51, 2048),
    ("dX gate,up", 256, 2202, 2048), ("dX down", 256, 410, 11008),
    ("dW q,o", 2048, 256, 410), ("dW k,v", 2048, 256, 51),
    ("dW gate,up", 2048, 256, 2202), ("dW down", 11008, 256, 410),
]


def _lm_operands(dev, name, m, k, n, seed):
    """The operands as the backward hands them over: dX = dy_k @ w_k.T,
    dW = x2.T @ dy_k, with dy_k and w_k gathered at an aligned pitch."""
    if name.startswith("dX"):
        return _aligned(dev, (m, k), "bfloat16", seed), _aligned(dev, (n, k), "bfloat16",
                                                                 seed + 1).T
    return _randn(dev, (k, m), "bfloat16", seed).T, _aligned(dev, (k, n), "bfloat16", seed + 1)


@pytest.mark.parametrize("name,m,k,n", LM_PRODUCTS)
def test_matmul_lm_products_on_tensor_cores(cuda, name, m, k, n):
    """bf16 through TMA + wgmma at the main path's products: no repack,
    within 1e-4 * max(1, max|plain|), the same bits on a second call."""
    a, b = _lm_operands(cuda, name, m, k, n, 24)
    before, repacks = tgm.launches["matmul"], tgm.repacks["matmul"]
    out = tgm.matmul(a, b)
    torch.cuda.synchronize()
    assert tgm.launches["matmul"] == before + 1 and tgm.repacks["matmul"] == repacks
    _close(out, tgm.matmul_ref(a, b))
    assert torch.equal(out, tgm.matmul(a, b))


@pytest.mark.parametrize("name,m,k,n", [p for p in LM_PRODUCTS if p[0].startswith("dW")])
def test_matmul_split_k_at_full_m(cuda, name, m, k, n):
    """dW at M = 1024 tokens: the planned split-K (S > 1 for k,v and q,o)
    sums its partials in a fixed order, so the result repeats bit for bit."""
    k = 1024
    a, b = _lm_operands(cuda, name, m, k, n, 25)
    s, chunk = tgm.matmul_plan(m, n, k)
    assert (s > 1) == (name in ("dW q,o", "dW k,v"))
    out = tgm.matmul(a, b)
    torch.cuda.synchronize()
    _close(out, tgm.matmul_ref(a, b))
    assert torch.equal(out, tgm.matmul(a, b))


@pytest.mark.parametrize("b_major", ["k", "n"])
@pytest.mark.parametrize("a_major", ["k", "m"])
@pytest.mark.parametrize("m,k,n", [(200, 136, 130), (64, 64, 64), (333, 72, 520)])
def test_matmul_every_operand_major(cuda, m, k, n, a_major, b_major):
    """A K-major ([M, K] rows) or M-major (a transposed view), B K-major
    (a transposed view) or N-major ([K, N] rows), all aligned: the
    descriptors of all four reach the right values, with no repack."""
    a = _aligned(cuda, (m, k), "bfloat16", 26) if a_major == "k" else \
        _aligned(cuda, (k, m), "bfloat16", 26).T
    b = _aligned(cuda, (n, k), "bfloat16", 27).T if b_major == "k" else \
        _aligned(cuda, (k, n), "bfloat16", 27)
    repacks = tgm.repacks["matmul"]
    out = tgm.matmul(a, b)
    torch.cuda.synchronize()
    assert tgm.repacks["matmul"] == repacks
    _close(out, tgm.matmul_ref(a, b))


def test_observe_matmul_sees_each_launch(cuda):
    """Within ``observe_matmul`` each launch of the kernel hands the
    observer the operands the wrapper was given and the output it
    returns; outside the block nothing is handed over."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(64, 96, generator=gen, device=cuda)
    b = torch.randn(48, 96, generator=gen, device=cuda).T  # a transposed view
    seen = []
    with tgm.observe_matmul(lambda x, y, out: seen.append((x, y, out))):
        out = tgm.matmul(a, b)
    tgm.matmul(a, b)
    assert len(seen) == 1
    x, y, got = seen[0]
    assert x is a and y is b and got is out
    torch.testing.assert_close(out, tgm.matmul_ref(a, b), rtol=0, atol=1e-4 * max(
        1.0, float(tgm.matmul_ref(a, b).abs().max())))


def test_matmul_repacks_unaligned_pitches(cuda):
    """A pitch that is not a multiple of 8 (a plain ``index_select``), an
    operand with no unit stride, or an unaligned start: copied once each,
    counted, and the product still right."""
    a = _randn(cuda, (300, 410), "bfloat16", 28)  # pitch 410
    b = _randn(cuda, (410, 400), "bfloat16", 29)[:, ::2]  # no unit stride
    c = _randn(cuda, (1, 300 * 136 + 1), "bfloat16", 30)[0, 1:].view(300, 136)  # offset 2 bytes
    for x, y, copies in ((a, _aligned(cuda, (410, 64), "bfloat16", 31), 1),
                         (_aligned(cuda, (300, 410), "bfloat16", 32), b, 1),
                         (a, b, 2), (c.T, _aligned(cuda, (300, 72), "bfloat16", 33), 1)):
        repacks = tgm.repacks["matmul"]
        out = tgm.matmul(x, y)
        torch.cuda.synchronize()
        assert tgm.repacks["matmul"] == repacks + copies
        _close(out, tgm.matmul_ref(x, y))


def test_matmul_fp32_takes_the_simt_kernel_and_repacks_nothing(cuda):
    """fp32 operands, transposed and unaligned views included, go to the
    SIMT kernel as they are."""
    a = _randn(cuda, (410, 300), "float32", 34).T
    b = _randn(cuda, (410, 51), "float32", 35)
    repacks = tgm.repacks["matmul"]
    out = tgm.matmul(a, b)
    torch.cuda.synchronize()
    assert tgm.repacks["matmul"] == repacks
    _close(out, tgm.matmul_ref(a, b))
    assert torch.equal(out, tgm.matmul(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(1, 1), (300, 130), (7, 5000), (1024, 256), (1024, 2048),
                                 (1024, 11008), (4099, 33)])
def test_importance_kernel_matches_plain_and_repeats(cuda, m, n, dtype):
    dy = _randn(cuda, (m, n), dtype, 16)
    before = tgm.launches["importance"]
    out = tgm.importance(dy)
    torch.cuda.synchronize()
    assert tgm.launches["importance"] == before + 1
    _close(out, tgm.importance_ref(dy))
    assert torch.equal(out, tgm.importance(dy))  # fixed summation order


def test_matmul_and_importance_raise_never_fall_back(cuda):
    a = _randn(cuda, (64, 32), "float32", 17)
    with pytest.raises(TypeError):  # fp16 is not a kernel operand type
        tgm.matmul(a.half(), a.T.half())
    with pytest.raises(TypeError):  # operands of two types
        tgm.matmul(a, a.T.bfloat16())
    with pytest.raises(ValueError):  # one operand on the card, one on the CPU
        tgm.matmul(a, a.T.cpu())
    with pytest.raises(ValueError):
        tgm.matmul(a, a)
    with pytest.raises(TypeError):
        tgm.importance(a.half())
    with pytest.raises(ValueError, match="contiguous"):
        tgm.importance(a.T)


def test_sparse_dense_channel_route_launches_matmul(cuda):
    """Channel granularity with ``use_pallas`` on the card: one ``matmul``
    launch a sparsified side, the gradients those of the gather route."""
    from repro_torch.core import policy as tpolicy
    from repro_torch.core.dense import sparse_dense

    x = _randn(cuda, (4, 32, 96), "float32", 18).requires_grad_(True)
    w = _randn(cuda, (96, 200), "float32", 19).requires_grad_(True)
    grads = {}
    for use_pallas in (True, False):
        pol = tpolicy.SsPropPolicy(0.8, use_pallas=use_pallas)
        before = tgm.launches["matmul"]
        gx, gw = torch.autograd.grad(sparse_dense(x, w, policy=pol).square().sum(), (x, w))
        torch.cuda.synchronize()
        assert tgm.launches["matmul"] == before + (2 if use_pallas else 0)
        grads[use_pallas] = (gx, gw)
    for a, b in zip(grads[True], grads[False], strict=True):
        _close(a.float(), b.float())


def test_sparse_dense_bf16_channel_route_reads_gathered_operands_in_place(cuda):
    """bf16 at channel granularity with ``use_pallas``: the backward's
    gathered operands reach the tensor-core kernel with aligned pitches
    (no repack), at K = 410 of 512 kept channels (not a multiple of 8)."""
    from repro_torch.core import policy as tpolicy
    from repro_torch.core.dense import sparse_dense

    x = _randn(cuda, (4, 64, 256), "bfloat16", 36).requires_grad_(True)
    w = _randn(cuda, (256, 512), "bfloat16", 37).requires_grad_(True)
    pol = tpolicy.SsPropPolicy(0.2, use_pallas=True)
    assert pol.keep_count(512) % 8 != 0
    before, repacks = tgm.launches["matmul"], tgm.repacks["matmul"]
    torch.autograd.grad(sparse_dense(x, w, policy=pol).float().square().sum(), (x, w))
    torch.cuda.synchronize()
    assert tgm.launches["matmul"] == before + 2 and tgm.repacks["matmul"] == repacks


def test_train_classifier_cli_runs_without_tf32_on_the_card(cuda):
    """A CLI run on the card: TF32 off for matmuls and convolutions during
    the run, as reported, and the caller's flags restored after it."""
    from repro_torch.launch import train_classifier as tc

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        args = tc.build_parser().parse_args(
            ["--batch", "4", "--image-size", "8", "--steps", "2", "--steps-per-epoch", "1",
             "--granularity", "block", "--block-size", "32", "--use-pallas", "--mode",
             "ssprop", "--device", "cuda"])
        out = tc.run(args)
        assert out["tf32"] == {"matmul": False, "cudnn": False}
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


# --- the DDPM UNet's shapes: block 32 and the 3-channel head -------------

# (C_in, C_out, H, kept blocks) of 3x3 sites of a sparse DDPM step (base 64,
# 3x64x64, block 32), at B=8: the 3-channel head (a ragged block of 3 of 32),
# up1/conv1 (1 of 2 kept), up3/conv1 (C_in 256, 1 of 4), down2/conv1
DDPM_CONV = [(64, 3, 64, [0]), (128, 64, 64, [1]), (256, 128, 16, [3]), (64, 128, 32, [2])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out,h,blocks", DDPM_CONV)
def test_conv_kernels_at_ddpm_shapes_block_32(cuda, c_in, c_out, h, blocks, dtype):
    """conv_dw_fused and conv_dx_fused at block 32: within 1e-4 * max(1,
    max|plain|), the same bits on a second call, one launch each; after
    the scatter the dropped blocks of dW are exactly 0."""
    b, bs = 8, 32
    g = _conv_geometry(1, 1, 1, c_in, 1, b=b, h=h)
    xg = _randn(cuda, (b * g["h_pad"], 1, g["h_pad"], c_in), dtype, 60)
    dy2r = _dy2r(cuda, b, h, c_out, bs, dtype, 61)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    kw = dict(kh_dim=3, kw_dim=3, stride=(1, 1), dilation=(1, 1), h_out=h, block_size=bs)
    before = dict(tgm.launches)
    dw = tgm.conv_dw_fused(xg, dy2r, bidx, c_out=c_out, **kw)
    w2k = _randn(cuda, (3, 3, c_in, len(blocks) * bs), dtype, 62)
    w2k[..., c_out:] = 0  # the ragged head's phantom filters, as _compact_filters pads them
    dkw = dict(b=b, hw=(h, h), padding=((1, 1), (1, 1)), groups=1, stride=(1, 1),
               dilation=(1, 1), block_size=bs)
    dx = tgm.conv_dx_fused(dy2r, w2k, bidx, c_out=c_out, **dkw)
    torch.cuda.synchronize()
    assert tgm.launches["conv_dw_fused"] == before["conv_dw_fused"] + 1
    assert tgm.launches["conv_dx_fused"] == before["conv_dx_fused"] + 1
    _close(dw, tgm.conv_dw_fused_ref(xg, dy2r, bidx, **kw))
    _close(dx, tgm.conv_dx_fused_ref(dy2r, w2k, bidx, **dkw))
    assert torch.equal(dw, tgm.conv_dw_fused(xg, dy2r, bidx, c_out=c_out, **kw))
    assert torch.equal(dx, tgm.conv_dx_fused(dy2r, w2k, bidx, c_out=c_out, **dkw))
    x = _randn(cuda, (b, c_in, h, h), dtype, 63)
    dy = _randn(cuda, (b, c_out, h, h), dtype, 64)
    full = tops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1),
                                      padding=((1, 1), (1, 1)), dilation=(1, 1), groups=1,
                                      block_size=bs)
    torch.cuda.synchronize()
    kept = [c for blk in blocks for c in range(blk * bs, min((blk + 1) * bs, c_out))]
    dropped = sorted(set(range(c_out)) - set(kept))
    assert full.shape == (c_in * 9, c_out)
    assert not full[:, dropped].any() and full[:, kept].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_dx_fused_reads_no_channel_past_the_ragged_head(cuda, dtype):
    """The 3-channel head at block 32: NaN in dY's and the filters'
    phantom channels 3..31 leave dX bit for bit as with zeros there (the
    16-byte copy that straddles channel 3 reads the real channels only)."""
    b, h, c_in, c_out, bs = 4, 64, 64, 3, 32
    dy2r = _dy2r(cuda, b, h, c_out, bs, dtype, 65)
    w2k = _randn(cuda, (3, 3, c_in, bs), dtype, 66)
    w2k[..., c_out:] = 0
    bidx = torch.tensor([0], dtype=torch.int32, device=cuda)
    kw = dict(b=b, hw=(h, h), padding=((1, 1), (1, 1)), groups=1, stride=(1, 1),
              dilation=(1, 1), block_size=bs, c_out=c_out)
    clean = tgm.conv_dx_fused(dy2r, w2k, bidx, **kw)
    dy2r[..., c_out:] = float("nan")
    w2k[..., c_out:] = float("nan")
    poisoned = tgm.conv_dx_fused(dy2r, w2k, bidx, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all() and torch.equal(clean, poisoned)


# (M, C_out, D_in, kept blocks) of the 1x1 skips of a sparse DDPM step at
# B=128 and block 32 (down2, up3, up2, up1: M up to 524288 rows), and the
# stem's dW (27 columns of X, C=64)
DDPM_GATHERED = [(131072, 128, 64, [2]), (32768, 128, 256, [0]), (131072, 64, 256, [1]),
                 (524288, 64, 128, [0]), (524288, 64, 27, [1])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,blocks", DDPM_GATHERED)
def test_gathered_kernels_at_ddpm_skips_block_32(cuda, m, n, d, blocks, dtype):
    """dx_gathered (not at the stem: its input needs no gradient) and
    dw_gathered at the DDPM's canonical sites, block 32: within 1e-4 *
    max(1, max|plain|), the same bits on a second call, dropped blocks of
    the scattered dW exactly 0."""
    bs = 32
    dy, x = _randn(cuda, (m, n), dtype, 67), _randn(cuda, (m, d), dtype, 68)
    bidx = torch.tensor(blocks, dtype=torch.int32, device=cuda)
    if d != 27:
        w = _randn(cuda, (d, n), dtype, 69)
        out = tgm.dx_gathered(dy, w, bidx, block_size=bs)
        torch.cuda.synchronize()
        _close(out, tgm.dx_gathered_ref(dy, w, bidx, block_size=bs))
        assert torch.equal(out, tgm.dx_gathered(dy, w, bidx, block_size=bs))
    out = tgm.dw_gathered(x, dy, bidx, block_size=bs)
    torch.cuda.synchronize()
    _close(out, tgm.dw_gathered_ref(x, dy, bidx, block_size=bs))
    assert torch.equal(out, tgm.dw_gathered(x, dy, bidx, block_size=bs))
    full = tops.dw_gathered_scatter(x, dy, bidx, n, block_size=bs)
    kept = [c for blk in blocks for c in range(blk * bs, (blk + 1) * bs)]
    assert not full[:, sorted(set(range(n)) - set(kept))].any() and full[:, kept].all()


def test_ddpm_sparse_step_routes_agree_on_the_card(cuda):
    """One sparse DDPM step at full width (base 64, t_dim 256, 3x64x64),
    B=8, block 32, fp32 with TF32 off: the kernel route launches each
    gathered kernel as the route table says; it keeps the same blocks as
    the gather and mask routes at every site, and every gradient leaf,
    biases included, is within a relative L2 of 1e-4 of theirs."""
    import dataclasses

    from repro_torch.core import backward as tbackward
    from repro_torch.core import policy as tpolicy
    from repro_torch.launch import train_ddpm as td
    from repro_torch.launch.precision import fp32_precision
    from repro_torch.models import ddpm
    from repro_torch.optim import adam as tadam

    image, b = (3, 64, 64), 8
    params = ddpm.init_params(0, channels=3, base=64, t_dim=256, device=cuda)
    sched = ddpm.make_schedule(1000, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x0 = torch.randn((b, *image), generator=gen, device=cuda)
    t, noise = ddpm.draw_t_noise(gen, x0, 1000)
    kern = dataclasses.replace(tpolicy.tpu_default(0.8), block_size=32, use_pallas=True)
    routes = {"kernel": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    res = {}
    with fp32_precision():
        for name, pol in routes.items():
            before = dict(tgm.launches)
            with tbackward.record_selections() as log:
                loss, grads = td.value_and_grad(params, sched, x0, t, noise, pol)
            torch.cuda.synchronize()
            launched = {k: tgm.launches[k] - before[k] for k in ddpm.kernel_launches_per_step(
                b, image, kern)}
            res[name] = (loss.item(), tadam.tree_leaves(grads), [s.block_idx for _, s in log],
                         launched)
    assert res["kernel"][3] == ddpm.kernel_launches_per_step(b, image, kern)
    assert sum(res["gather"][3].values()) == sum(res["mask"][3].values()) == 0
    for other in ("gather", "mask"):
        assert res["kernel"][0] == res[other][0]
        assert len(res["kernel"][2]) == len(ddpm.site_names(64)[0])
        for a, c in zip(res["kernel"][2], res[other][2], strict=True):
            assert torch.equal(a, c)
        for a, c in zip(res["kernel"][1], res[other][1], strict=True):
            assert ((a - c).norm() / c.norm()).item() <= 1e-4


def test_train_ddpm_cli_runs_without_tf32_on_the_card(cuda):
    """A DDPM CLI run on the card through the kernels: TF32 off during
    the run, as reported, the caller's flags restored; finite losses and
    samples; the gathered kernels launched the route table's count at
    each sparse step."""
    from repro_torch.core import policy as tpolicy
    from repro_torch.launch import train_ddpm as td
    from repro_torch.models import ddpm

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        args = td.build_parser().parse_args(
            ["--batch", "4", "--size", "16", "--channels", "3", "--timesteps", "20",
             "--steps", "4", "--steps-per-epoch", "1", "--granularity", "block",
             "--block-size", "32", "--use-pallas", "--mode", "ssprop", "--out", "",
             "--device", "cuda"])
        out = td.run(args)
        assert out["tf32"] == {"matmul": False, "cudnn": False}
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    rec = out["modes"]["ssprop"]
    assert np.isfinite(rec["losses"]).all() and np.isfinite(out["samples"]).all()
    per_step = ddpm.kernel_launches_per_step(
        4, (3, 16, 16), td.step_policy(args, 0.8), base=16)
    assert td.step_policy(args, 0.8) == tpolicy.SsPropPolicy(
        0.8, granularity="block", block_size=32, use_pallas=True, target_rate=0.8)
    assert {k: out["launches"][k] for k in per_step} == {k: 2 * v for k, v in per_step.items()}


# ----------------------------------------------------------------------
# serving: speculative verify chunks through paged_attention, sampling
# ----------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype,pool_dtype", _PAIRS)
@pytest.mark.parametrize("s,kv,d,tile", [(5, 2, 128, 16), (8, 2, 128, 64), (5, 2, 32, 16)])
def test_paged_attention_at_verify_shapes(cuda, s, kv, d, tile, q_dtype, pool_dtype):
    """A verify chunk of ``spec_k + 1`` rows a slot: qwen2.5-3b (G = 8) at
    k = 4 puts 40 rows a KV head on the 16-row SIMT tile, at k = 7 64 rows
    on the TF32 tile; the reduced config (G = 2, D = 32) at k = 4 10 rows
    on the 16-row tile. Within rtol=atol=1e-4 of the plain version and
    the same bits on a second call."""
    h = 16 if d == 128 else 4
    args = _inputs(cuda, s=s, h=h, kv=kv, d=d, nb=10, n_pages=40, q_dtype=q_dtype,
                   pool_dtype=pool_dtype, seed=26)
    assert tpa.paged_split_plan(4, s, h, kv, d, 10, 16).row_tile == tile
    before = tpa.launches
    out = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(out, tpa.paged_attention(*args))


@pytest.mark.parametrize("s", [5, 8])
def test_paged_attention_mixes_verify_decode_and_prefill_rows(cuda, s):
    """One engine step's call: a prefill chunk from 0, a verify chunk deep
    in the cache, a decode token and an idle slot, each row at its own
    position (the rows past a slot's count are the padding the engine
    ignores, computed all the same)."""
    q, k, v, tables, _ = _inputs(cuda, s=s, nb=10, n_pages=40, seed=27)
    starts = torch.tensor([0, 37, 100, 0], dtype=torch.int32, device=cuda)
    qpos = (starts[:, None] + torch.arange(s, device=cuda)).to(torch.int32)
    out = tpa.paged_attention(q, k, v, tables, qpos)
    torch.cuda.synchronize()
    ref = tpa.paged_attention_ref(q, k, v, tables, qpos)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, tpa.paged_attention(q, k, v, tables, qpos))


def test_prng_on_the_card_gives_the_cpu_bits(cuda):
    """Threefry in int64 words gives the same bits on the card as on the
    CPU (the CPU ones are jax.random's, tests/test_torch_sampling.py)."""
    from repro_torch.core import prng

    rng = np.random.default_rng(8)
    keys = torch.from_numpy(rng.integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.int64))
    data = torch.from_numpy(rng.integers(0, 2**31, 64))
    assert torch.equal(prng.fold_in(keys.to(cuda), data.to(cuda)).cpu(), prng.fold_in(keys, data))
    assert torch.equal(prng.random_bits(keys.to(cuda), 1000).cpu(), prng.random_bits(keys, 1000))
    u = prng.uniform(keys.to(cuda), 1000, float(np.finfo(np.float32).tiny), 1.0).cpu()
    assert torch.equal(u, prng.uniform(keys, 1000, float(np.finfo(np.float32).tiny), 1.0))


def test_sampled_swapping_speculative_engine_on_the_card(cuda):
    """Reduced qwen2.5-3b, fp32, on the card: sampled requests through a
    pool that forces swap preemption, speculating 4 tokens with a 1-layer
    drafter (10 verify rows a KV head: the 16-row tile). The kernel route,
    the gather route and the lock-step oracle give identical streams; the
    kernel launches once a layer a target step; every page is freed and
    zero."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as tlm
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        generate_reference,
        poisson_workload,
    )

    cfg = get_config("qwen2.5-3b").reduced()
    dcfg = cfg.reduced(n_layers=1)
    params = tlm.init_params(cfg, 0, cuda)
    dparams = tlm.init_params(dcfg, 1, cuda)

    def wl():
        return poisson_workload(cfg, n_requests=6, arrival_rate=2.0, prompt_len=(3, 7),
                                gen_len=(8, 12), seed=5, temperature=0.8, top_k=50, top_p=0.95)

    outs = {}
    for kernel in (True, False):
        eng = ContinuousBatchingEngine(
            cfg, params,
            ServeConfig(max_slots=3, max_seq=24, prefill_chunk=8, decode_widths=(1, 5),
                        block_size=4, n_blocks=9, spec_k=4, attn_kernel=kernel),
            device=cuda, draft_cfg=dcfg, draft_params=dparams,
        )
        for r in wl():
            eng.submit(r)
        before = tpa.launches
        outs[kernel] = eng.run()
        st = eng.stats()
        assert st["swap_preemptions"] > 0 and st["spec_proposed"] > 0
        assert tpa.launches - before == (cfg.n_layers * st["compute_steps"] if kernel else 0)
        assert eng.slots.allocator.n_free == eng.slots.n_blocks
        assert not any(layer["k"].any() or layer["v"].any() for layer in eng.slots.cache)
    assert tpa.paged_split_plan(3, 5, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 6, 4).row_tile == 16
    for r in wl():
        ref = generate_reference(cfg, params, r.prompt, r.max_new_tokens, max_seq=24,
                                 sampling=r.sampling, device=cuda)
        np.testing.assert_array_equal(outs[True][r.rid], ref)
        np.testing.assert_array_equal(outs[False][r.rid], ref)


# ----------------------------------------------------------------------
# the decoder-only families: paged_attention at kimi-k2's head dim 112,
# the reduced configs' training routes, random draws on the card
# ----------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype,pool_dtype", _PAIRS)
@pytest.mark.parametrize("s,nb,splits", [(1, 10, None), (1, 128, None), (32, 10, None),
                                         (5, 10, None), (8, 10, 1), (3, 6, 3)])
def test_paged_attention_at_head_dim_112(cuda, s, nb, splits, q_dtype, pool_dtype):
    """kimi-k2's heads (64 query heads over 8 KV heads of 112, tiled at
    128): decode, a deep decode, a prefill chunk on the TF32 tile, a
    spec_k=4 verify chunk, forced splits. Within rtol=atol=1e-4 of the
    plain version, the same bits on a second call, one launch counted."""
    args = _inputs(cuda, s=s, h=64, kv=8, d=112, nb=nb, n_pages=4 * nb, q_dtype=q_dtype,
                   pool_dtype=pool_dtype, seed=31)
    assert tpa.chunk_keys(112) == 32 and tpa.padded_dim(112) == 128
    before = tpa.launches
    out = tpa.paged_attention(*args, splits=splits)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(out, tpa.paged_attention(*args, splits=splits))


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b", "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_reduced_family_routes_agree_on_the_card(cuda, arch):
    """One sparse step of the reduced fp32 config through ``matmul``, the
    gather route and the mask oracle: the same kept channels (each
    routed expert its own), every gradient leaf within 1e-4, ``matmul``
    launched the launch table's count."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core import backward, policy
    from repro_torch.launch import steps
    from repro_torch.models import model as lm

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).reduced()
        params = lm.init_params(cfg, 0, cuda)
        rng = np.random.default_rng(3)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)).to(cuda)
                 for k in ("tokens", "targets")}
        kern = dataclasses.replace(policy.paper_default(0.8), use_pallas=True)
        res = {}
        for name, pol in (("matmul", kern), ("gather", dataclasses.replace(kern, use_pallas=False)),
                          ("mask", dataclasses.replace(kern, mask_mode=True))):
            before = tgm.launches["matmul"]
            with backward.record_selections() as log:
                (loss, _), grads = steps.value_and_grad(
                    lambda p, pol=pol: lm.loss_fn(cfg, p, batch, pol), params)
            torch.cuda.synchronize()
            res[name] = (float(loss), grads, [s.idx.cpu() for _, s in log],
                         tgm.launches["matmul"] - before)
        assert res["matmul"][3] == lm.kernel_launches_per_step(cfg, kern)["matmul"]
        for other in ("gather", "mask"):
            assert abs(res["matmul"][0] - res[other][0]) <= 1e-4 * abs(res[other][0])
            assert sorted(map(tuple, map(torch.Tensor.tolist, res["matmul"][2]))) == sorted(
                map(tuple, map(torch.Tensor.tolist, res[other][2])))
            from repro_torch.optim import adam

            for a, b in zip(adam.tree_leaves(res["matmul"][1]), adam.tree_leaves(res[other][1]),
                            strict=True):
                n = b.float().norm()
                rel = float((a.float() - b.float()).norm() / n) if n > 0 else float(a.norm())
                assert rel <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_random_draws_on_the_card_give_the_cpu_bits(cuda):
    """``split``, ``bernoulli`` and ``permutation`` (two sort rounds at
    2000) give the same values on the card as on the CPU, where they are
    ``jax.random``'s (tests/test_torch_random_draws.py)."""
    from repro_torch.core import prng

    for seed in (0, 7, 123456789):
        k = prng.key(seed)
        assert torch.equal(prng.split(k.to(cuda), 3).cpu(), prng.split(k, 3))
        assert torch.equal(prng.permutation(k.to(cuda), 2000).cpu(), prng.permutation(k, 2000))
        assert torch.equal(prng.bernoulli(k.to(cuda), 0.7, (4, 64, 8, 8)).cpu(),
                           prng.bernoulli(k, 0.7, (4, 64, 8, 8)))


# ----------------------------------------------------------------------
# sharded selection: grouped convs and TP-balanced blocks on the kernels
# ----------------------------------------------------------------------


def _conv_routes_on_the_card(cuda, x_shape, w_shape, groups, pol, padding):
    """One ``sparse_conv2d`` backward on the kernel, gather and mask
    routes, fp32 with TF32 off: ``(kept channels, grads, kernel launches)``
    a route."""
    import dataclasses

    from repro_torch.core import backward as tbackward
    from repro_torch.core.conv import sparse_conv2d
    from repro_torch.launch.precision import fp32_precision

    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(x_shape, generator=gen, device=cuda)
    w = torch.randn(w_shape, generator=gen, device=cuda) * 0.05
    w *= (1.02 ** torch.randperm(w_shape[0], generator=gen, device=cuda))[:, None, None, None]
    res = {}
    with fp32_precision():
        for name, p in (("kernel", pol), ("gather", dataclasses.replace(pol, use_pallas=False)),
                        ("mask", dataclasses.replace(pol, use_pallas=False, mask_mode=True))):
            xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            before = dict(tgm.launches)
            with tbackward.record_selections() as log:
                y = sparse_conv2d(xt, wt, padding=padding, groups=groups, policy=p)
                (0.5 * (y**2).mean()).backward()
            torch.cuda.synchronize()
            res[name] = (log[0][1].idx.cpu(), (xt.grad, wt.grad),
                         {k: tgm.launches[k] - before[k] for k in before})
    return res


def _assert_routes_agree(res):
    for other in ("gather", "mask"):
        assert torch.equal(res["kernel"][0], res[other][0])
        for a, c in zip(res["kernel"][1], res[other][1], strict=True):
            assert ((a - c).norm() / c.norm()).item() <= 1e-4
        assert not any(res[other][2].values())


@pytest.mark.parametrize("x_shape,w_shape,groups", [
    ((16, 256, 8, 8), (256, 128, 3, 3), 2), ((16, 512, 4, 4), (512, 128, 3, 3), 4)])
def test_grouped_conv_takes_the_fused_kernels_on_the_card(cuda, x_shape, w_shape, groups):
    """A grouped conv at 64-channel blocks: each group keeps 1 of its 2
    blocks, the fused kernels run once each, block-diagonally, and agree
    with the gather route and the mask oracle."""
    import dataclasses

    from repro_torch.core import policy as tpolicy

    pol = dataclasses.replace(tpolicy.tpu_default(0.8), block_size=64, use_pallas=True)
    res = _conv_routes_on_the_card(cuda, x_shape, w_shape, groups, pol, 1)
    kept = res["kernel"][0]
    assert len(kept) == groups * 64
    assert (torch.bincount(kept // (w_shape[0] // groups), minlength=groups) == 64).all()
    assert res["kernel"][2]["conv_dx_fused"] == 1 and res["kernel"][2]["conv_dw_fused"] == 1
    _assert_routes_agree(res)


@pytest.mark.parametrize("k", [3, 1])
def test_tp_balanced_block_idx_on_the_card(cuda, k):
    """``tp_shards=2`` at 512 channels and 128-channel blocks: one block a
    shard (2 of 4, against 1 of 4 unsharded), regrouped into ``block_idx``;
    the 3x3 conv takes the fused kernels, the 1x1 one the canonical
    ``dx_gathered`` / ``dw_gathered``, and both agree with the other
    routes."""
    import dataclasses

    from repro_torch.core import policy as tpolicy

    pol = dataclasses.replace(tpolicy.tpu_default(0.8), tp_shards=2, use_pallas=True)
    res = _conv_routes_on_the_card(cuda, (32, 256, 4, 4), (512, 256, k, k), 1, pol, k // 2)
    kept = res["kernel"][0]
    assert len(kept) == 256 and (torch.bincount(kept // 256, minlength=2) == 128).all()
    names = ("conv_dx_fused", "conv_dw_fused") if k == 3 else ("dx_gathered", "dw_gathered")
    assert {n: c for n, c in res["kernel"][2].items() if c} == dict.fromkeys(names, 1)
    _assert_routes_agree(res)


def test_tp_fast_path_runs_bf16_products_with_fp32_results_on_the_card(cuda):
    """The TP fast path's products keep bf16 operands and return fp32
    (``torch.mm`` with ``out_dtype``), within fp32 rounding of the
    widened operands' product; a bf16 ``sparse_dense`` under
    ``tp_shards=4`` at 1024 channels keeps the same channels as on the CPU (operands
    widened there) and its gradients agree to bf16 rounding."""
    import dataclasses

    from repro_torch.core import dense as tdense_mod
    from repro_torch.core import policy as tpolicy

    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((256, 384), np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((384, 160), np.float32)).to(cuda, torch.bfloat16)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = tdense_mod._mm_acc(a, b.T.contiguous().T, torch.float32)
        ref = a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert out.dtype == torch.float32
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-6

    pol = dataclasses.replace(tpolicy.tpu_default(0.8), tp_shards=4)
    x = rng.standard_normal((64, 96), np.float32)
    w = rng.standard_normal((96, 1024), np.float32) / 10
    dy = rng.standard_normal((64, 1024), np.float32) * rng.random(1024, np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev, torch.bfloat16).requires_grad_()
        wt = torch.from_numpy(w).to(dev, torch.bfloat16).requires_grad_()
        tdense_mod.sparse_dense(xt, wt, policy=pol).backward(
            torch.from_numpy(dy).to(dev, torch.bfloat16))
        grads[str(dev)] = (xt.grad.float().cpu(), wt.grad.float().cpu())
    (dxc, dwc), (dxg, dwg) = grads["cpu"], grads["cuda"]
    assert torch.equal(dwc.abs().sum(0) != 0, dwg.abs().sum(0) != 0)
    assert int((dwg.abs().sum(0) != 0).sum()) == 4 * 128  # 1 of 2 blocks a shard
    for g, c in ((dxg, dxc), (dwg, dwc)):
        assert ((g - c).norm() / c.norm()).item() <= 4e-3


# ----------------------------------------------------------------------
# compiled steps: the multi-tensor Adam, 1x1 patches, captured graphs
# ----------------------------------------------------------------------


def _adam_tree(rng, dtype, dev):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    return {"w": t(300, 257), "blocks": [{"k": t(64, 3, 3, 3), "b": t(7)}, {"k": t(1000, 33)}],
            "norm": t(257).float()}


@pytest.mark.parametrize("alone", [1 << 22, 30000])  # the two largest leaves alone
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-2, 0.5)])
def test_multi_tensor_adam_equals_per_leaf_on_the_card(cuda, dtype, inplace, wd, clip, alone,
                                                       monkeypatch):
    """The ``torch._foreach_*`` update against the leaf-by-leaf one on the
    card (whose multi-tensor kernels are not the CPU's per-tensor loop):
    params, moments and clipped grads bit for bit over three steps."""
    from repro_torch.optim import adam
    from torch_adam_ref import per_leaf_updates

    monkeypatch.setattr(adam, "ALONE_ELEMS", alone)

    cfg = adam.AdamConfig(lr=3e-3, weight_decay=wd, clip_norm=clip, schedule="cosine",
                          total_steps=5)
    rng = np.random.default_rng(9)
    params = _adam_tree(rng, _DT[dtype], cuda)
    ref = adam.tree_map(torch.clone, params)
    state, ref_state = adam.init(params), adam.init(ref)
    for step in range(3):
        grads = adam.tree_map(lambda t: t * (step + 1), _adam_tree(rng, _DT[dtype], cuda))
        ref_grads = adam.tree_map(torch.clone, grads)
        params, state, _ = adam.apply_updates(cfg, params, grads, state, inplace=inplace)
        ref, ref_state = per_leaf_updates(cfg, ref, ref_grads, ref_state, inplace=inplace)
        for a, b in zip(adam.tree_leaves(grads), adam.tree_leaves(ref_grads), strict=True):
            assert torch.equal(a, b)
    for a, b in zip(adam.tree_leaves((params, state.m, state.v)),
                    adam.tree_leaves((ref, ref_state.m, ref_state.v)), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pointwise_patches_equal_unfold_on_the_card(cuda, dtype):
    """ResNet-18's 1x1 stride-2 down conv shape: the strided patches and
    col2im against ``F.unfold`` / ``F.fold`` bit for bit on the card."""
    import torch.nn.functional as F

    from repro_torch.kernels import im2col

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 64, 32, 32)).astype(np.float32)).to(
        cuda, _DT[dtype])
    x2, col2im, (ho, wo) = im2col.conv_patches(x, 1, 1, (2, 2), ((0, 0), (0, 0)), (1, 1))
    p = F.unfold(x, (1, 1), stride=(2, 2))
    assert torch.equal(x2, p.transpose(1, 2).reshape(-1, 64))
    d2 = torch.randn(x2.shape, device=cuda)
    dcol = d2.reshape(16, ho * wo, 64).transpose(1, 2).to(x.dtype)
    ref = F.fold(dcol.float(), (32, 32), (1, 1), stride=(2, 2)).to(x.dtype)
    assert torch.equal(col2im(d2), ref)


def test_step_graphs_replay_a_kernel_and_count_it(cuda):
    """A step that launches ``paged_attention`` captured: the first call
    runs it (one launch counted), the capture counts none, each replay
    one; replays read new inputs and equal eager calls bit for bit."""
    from repro_torch.launch.graphs import StepGraphs

    q, k, v, tables, qpos = _inputs(cuda, s=1)
    sg = StepGraphs(lambda _, q_, t_: tpa.paged_attention(q_, k, v, t_, qpos) * 2, cuda)
    before = tpa.launches
    first = sg("decode", q, tables).clone()
    torch.cuda.synchronize()
    assert tpa.launches == before + 1 and sg.captured
    for seed in range(3):
        q2 = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(seed),
                         device=cuda).to(q.dtype)
        got = sg("decode", q2, tables.cpu())  # a host input goes through pinned staging
        assert torch.equal(got, tpa.paged_attention(q2, k, v, tables, qpos) * 2)
    assert torch.equal(first, tpa.paged_attention(q, k, v, tables, qpos) * 2)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1 + 3 + 3 + 1
    assert sg.stats()["replays"] == 3 and sg.stats()["capture_s"] > 0


def _leaves_equal(a, b):
    from repro_torch.optim import adam

    la = adam.tree_leaves((a[0], a[1].m, a[1].v))
    lb = adam.tree_leaves((b[0], b[1].m, b[1].v))
    return all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))


def test_captured_classifier_steps_equal_eager_on_the_card(cuda):
    """The ResNet-18 CLI at a small size through the kernels, captured (a
    graph a drop rate) and eagerly from the same init, under
    ``cudnn.deterministic`` (cuDNN's default dense algorithms are not):
    losses, every step's kept channels, params and Adam state bit for
    bit; the launches equal."""
    from repro_torch.launch import train_classifier as tc

    argv = ["--batch", "8", "--image-size", "16", "--steps", "4", "--steps-per-epoch", "1",
            "--granularity", "block", "--block-size", "32", "--use-pallas", "--mode", "ssprop",
            "--device", "cuda"]
    torch.backends.cudnn.deterministic = True
    try:
        runs = {g: tc.run(tc.build_parser().parse_args(argv + [g]))
                for g in ("--graphs", "--no-graphs")}
    finally:
        torch.backends.cudnn.deterministic = False
    cap, eager = runs["--graphs"], runs["--no-graphs"]
    assert cap["captured"] and not eager["captured"]
    assert cap["launches"] == eager["launches"]
    rc, re_ = cap["modes"]["ssprop"], eager["modes"]["ssprop"]
    for a, b in zip(rc["kept"], re_["kept"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert rc["losses"] == re_["losses"] and _leaves_equal(rc["state"], re_["state"])
    assert rc["graphs"]["keys"] == ["0.0", "0.8"] and rc["graphs"]["replays"] == 2


def test_captured_ddpm_sampler_equals_eager_on_the_card(cuda):
    """A small UNet's 20-step sampler, one captured denoising step
    replayed, against the eager loop from the same noise: bit for bit."""
    from repro_torch.launch.graphs import StepGraphs
    from repro_torch.models import ddpm

    params = ddpm.init_params(0, channels=3, base=16, t_dim=64, device=cuda)
    sched = ddpm.make_schedule(20, device=cuda)
    gen = torch.Generator(cuda).manual_seed(5)
    x_t = torch.randn((4, 3, 16, 16), generator=gen, device=cuda)
    zs = [torch.randn((4, 3, 16, 16), generator=gen, device=cuda) for _ in range(20)]
    graphs = StepGraphs(lambda _, x, t, z: ddpm.denoise_step(params, sched, x, t, z), cuda)
    cap = ddpm.sample(params, sched, x_t, lambda i: zs[i],
                      step=lambda x, t, z: graphs(None, x, t, z)).clone()
    assert graphs.captured and graphs.replays == 19
    eager = ddpm.sample(params, sched, x_t, lambda i: zs[i])
    assert torch.equal(cap, eager) and torch.isfinite(cap).all()


def test_captured_engine_streams_equal_eager_on_the_card(cuda):
    """Reduced qwen2.5-3b, fp32: greedy and sampled requests, with swaps,
    through the paged engine captured (a graph a width and mode) and
    eagerly: identical streams, the kernel's launches a layer a step
    either way, the pools never moved, every real page back and zero."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as tlm
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, poisson_workload

    cfg = get_config("qwen2.5-3b").reduced()
    params = tlm.init_params(cfg, 0, cuda)
    outs = {}
    for graphs in (True, False):
        eng = ContinuousBatchingEngine(
            cfg, params, ServeConfig(max_slots=3, max_seq=24, prefill_chunk=8, block_size=4,
                                     n_blocks=9, preempt="swap"),
            device=cuda, graphs=graphs)
        for i, r in enumerate(poisson_workload(cfg, n_requests=6, arrival_rate=2.0,
                                               prompt_len=(3, 7), gen_len=(8, 12), seed=5,
                                               temperature=0.8, top_k=50, top_p=0.95)):
            if i % 3 == 0:  # some greedy requests beside the sampled ones
                r.sampling = type(r.sampling)()
            eng.submit(r)
        before = tpa.launches
        outs[graphs] = eng.run()
        st = eng.stats()
        assert eng.captured == graphs and st["swap_preemptions"] > 0
        assert tpa.launches - before == cfg.n_layers * st["compute_steps"]
        assert eng.slots.allocator.n_free == eng.slots.n_blocks
        assert not any(layer["k"].any() or layer["v"].any() for layer in eng.slots.cache)
        if graphs:
            keys = eng.graph_stats()["keys"]
            assert any("True" in k for k in keys) and any("False" in k for k in keys)
    assert sorted(outs[True]) == sorted(outs[False])
    for rid in outs[True]:
        np.testing.assert_array_equal(outs[True][rid], outs[False][rid])
