"""``kernels/specs.py``: the launch geometry, work and traffic of every
hand-written kernel, held to the sources and to the wrappers.

On the CPU: the specs' constants against the constants of each
``csrc/*.cu``; each ``<name>_geometry`` C entry point against its
``<name>_launch``'s integer arguments; the split plans a wrapper hands
its launch (seen on the meta route) against the spec's and the plan
functions'; the tiles' FLOPs and bytes summed over the grid against the
spec's totals and least bytes; the meta route's outputs against the
plain versions' shapes. On the card (marked ``cuda``): every
``<name>_geometry`` report against the spec's geometry.

The file imports neither JAX nor the JAX package, so it runs on the
card's machine too (``--noconftest``).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, specs
from repro_torch.kernels import gathered_matmul as tgm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

NAMES = sorted(specs.LAUNCH_ARGS)

# small launches of every kernel, the wrappers' integer arguments
CASES = {
    "dx_gathered": [(300, 200, 96, 1, 128, 1), (128, 256, 64, 2, 128, 0), (8192, 256, 576, 2, 128, 0),
                    (0, 8, 8, 1, 8, 0)],
    "dw_gathered": [(300, 96, 200, 2, 128, 3, 128, 0), (8192, 576, 256, 2, 128, 3, 2752, 1),
                    (200, 27, 64, 1, 128, 1, 224, 0)],
    "conv_dw_fused": [(2, 10, 1, 10, 16, 8, 8, 128, 32, 3, 3, 1, 1, 1, 1, 1, 128, 2, 64, 0),
                      (8, 18, 2, 18, 32, 8, 8, 256, 256, 3, 3, 2, 2, 1, 1, 2, 128, 1, 512, 1)],
    "conv_dx_fused": [(2, 8, 8, 1, 1, 2, 8, 4, 4, 256, 256, 3, 3, 2, 2, 1, 1, 2, 128, 0),
                      (8, 32, 32, 1, 1, 1, 64, 32, 32, 128, 64, 3, 3, 1, 1, 1, 1, 1, 128, 0),
                      (2, 7, 7, 1, 1, 1, 24, 4, 4, 128, 100, 3, 3, 2, 2, 1, 1, 1, 128, 1)],
    "matmul": [(300, 200, 100, 100, 1, 200, 1, 2, 64, 1), (300, 200, 100, 100, 1, 200, 1, 1, 0, 0),
               (1024, 2048, 410, 416, 1, 2048, 1, 3, 192, 1)],
    "importance": [(300, 70, 3, 100, 0), (1024, 2048, 1, 1024, 1)],
    "paged_attention": [(2, 3, 8, 2, 64, 8, 4, 4, 16, 64, 2, 0, 0),
                        (8, 1, 16, 2, 128, 128, 16, 16, 8, 32, 16, 1, 1),
                        (2, 32, 16, 2, 128, 64, 16, 32, 64, 32, 1, 0, 0)],
}


def _consts(name: str) -> dict[str, int]:
    src = (build.CSRC / f"{name}.cu").read_text()
    out = {}
    for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", src):
        expr = m.group(2)
        for k, v in out.items():
            expr = re.sub(rf"\b{k}\b", str(v), expr)
        try:
            out[m.group(1)] = int(eval(expr, {}))  # noqa: S307 - arithmetic of literals
        except Exception:
            pass
    return out


def test_spec_constants_are_the_sources():
    for name in ("dx_gathered", "dw_gathered", "conv_dw_fused", "conv_dx_fused"):
        c = _consts(name)
        assert (c["BM"], c["BN"], c["BK"], c["THREADS"]) == (specs._TILE, specs._TILE, specs._BK,
                                                              specs._THREADS), name
        if "STAGES" in c:
            assert c["STAGES"] == specs._TC_STAGES, name
        if "LDS" in c:
            assert c["LDS"] == specs._LDS, name
    mm = _consts("matmul")
    assert (mm["TC_BM"], mm["TC_BK"], mm["TC_STAGES"], mm["TC_THREADS"], mm["TC_SMEM"]) == (
        specs._MM_TILE, specs._MM_BK, specs._MM_STAGES, specs._MM_THREADS, specs._MM_SMEM)
    imp = _consts("importance")
    assert (imp["COLS"], imp["WARPS"]) == (specs._IMP_COLS, specs._IMP_WARPS)
    pa = _consts("paged_attention")
    assert (pa["STAGES"], pa["TPR"], pa["MMA_ROWS"], pa["CHUNK_VALUES"], pa["COMBINE_MAX_P"]) == (
        specs._PA_STAGES, specs._PA_TPR, specs._PA_MMA_ROWS, specs._PA_CHUNK_VALUES,
        specs._PA_COMBINE_MAX_P)
    tile = (build.CSRC / "tile.cuh").read_text()
    assert "b < 4096 ? b : 4096" in tile and specs._REDUCE_MAX_BLOCKS == 4096


@pytest.mark.parametrize("name", NAMES)
def test_geometry_entry_point_takes_the_launch_ints(name):
    """``<name>_geometry`` takes its launch's integer arguments, in order,
    then ``int* out``; the wrappers' ctypes signatures say the same."""
    src = (build.CSRC / f"{name}.cu").read_text()

    def params(entry):
        head = src[src.index(f'extern "C" int {name}_{entry}('):]
        return [" ".join(p.replace("const ", "").split()[:-1])
                for p in head[head.index("(") + 1:head.index(")")].split(",")]

    launch, geo = params("launch"), params("geometry")
    n_ptr = sum(p == "void*" for p in launch) - 1  # less the stream
    ints = [p for p in launch[n_ptr:-1] if p != "float"]
    assert geo[:-1] == ints and geo[-1] == "int*"
    assert len(ints) == len(specs.LAUNCH_ARGS[name])
    if name != "paged_attention":
        kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
        assert tgm._ARGTYPES[name][tgm._N_PTRS[name]:-1] == [kinds[p] for p in ints]


@pytest.mark.parametrize("name", NAMES)
def test_tiles_sum_to_the_spec(name):
    """Summed over the swept grid, the tiles' FLOPs are the spec's tile
    FLOPs; the schedule's bytes are at least the least bytes; every tile
    lies in the output; the work the spec counts is at least the useful
    work."""
    for args in CASES[name]:
        sp = specs.spec_for_launch(name, args)
        tiles = list(sp.tiles())
        assert sum(t.flops for t in tiles) == sp.tile_flops, args
        if not sp.launches:
            assert not tiles and sp.tile_flops == 0
            continue
        assert len(tiles) == sp.launches[0].blocks
        assert specs.emulate_bytes(sp) >= sp.least_bytes, args
        assert sp.tile_flops >= sp.useful_flops and sp.product_flops >= sp.useful_flops, args
        for t in tiles:
            assert all(0 <= o < e for o, e in zip(t.origin, sp.output, strict=True)), (args, t)
        assert sp.geometry()[:3] == sp.launches[0].grid


def test_geometry_layout():
    """The ``geometry()`` tuple is ``csrc/geometry.cuh``'s out[16]: a call
    that launches nothing reports a zero grid and split 1."""
    sp = specs.spec_for_launch("dx_gathered", (0, 8, 8, 1, 8, 0))
    assert sp.geometry() == (0,) * 7 + (1,) + (0,) * 8
    sp = specs.spec_for_launch("dw_gathered", (8192, 576, 256, 2, 128, 3, 2752, 0))
    assert sp.geometry() == (4, 9, 3, 128, 1, 1, 55296, 3, 3, 4608, 1, 1, 32, 8, 1, 0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _seen(fn):
    """The (name, int args, spec) of every launch ``fn`` makes on meta."""
    ints, spcs = [], []
    with tgm.observe_launches(launch=lambda n, a: ints.append((n, tuple(a))),
                              meta=lambda n, s: spcs.append(s)):
        fn()
    return [(n, a, s) for (n, a), s in zip(ints, spcs, strict=True)]


@pytest.mark.parametrize("m,d,n,kb", [(300, 96, 200, 2), (8192, 576, 256, 1), (128, 27, 64, 1)])
def test_dw_split_is_the_wrappers_plan(m, d, n, kb):
    (name, args, sp), = _seen(lambda: tgm.dw_gathered(
        _meta(m, d), _meta(m, n), torch.zeros(kb, dtype=torch.int32, device="meta")))
    assert (sp.split, sp.chunk) == tgm.dw_plan(m, d, kb, 128, n)
    assert args == (m, d, n, kb, 128, sp.split, sp.chunk, 0)


@pytest.mark.parametrize("b,h,cin,cout,k,stride", [(2, 8, 16, 128, 3, 1), (4, 16, 32, 256, 3, 2),
                                                   (2, 8, 3, 64, 3, 1)])
def test_conv_dw_split_is_the_wrappers_plan(b, h, cin, cout, k, stride):
    pad = (k - 1) // 2
    x, w = _meta(b, cin, h, h), _meta(cout, cin, k, k)
    h_out = (h + 2 * pad - k) // stride + 1
    dy = _meta(b, cout, h_out, h_out)
    kb = max(1, -(-cout // 128) // 2)
    bidx = torch.zeros(kb, dtype=torch.int32, device="meta")
    launches = _seen(lambda: tops.conv_dw_fused_scatter(
        x, dy, bidx, kh=k, kw=k, stride=(stride, stride), padding=((pad, pad), (pad, pad)),
        dilation=(1, 1), groups=1))
    (name, args, sp), = launches
    assert (sp.split, sp.chunk) == tgm.conv_dw_plan(b * h_out * h_out, k * k * cin, kb, 128, cout)
    launches = _seen(lambda: tops.conv_dx_fused(
        dy, w, bidx, hw=(h, h), stride=(stride, stride), padding=((pad, pad), (pad, pad)),
        dilation=(1, 1), groups=1))
    (name, args, sp), = launches
    assert name == "conv_dx_fused" and sp.output[1:] == (1, cin)


@pytest.mark.parametrize("m,n,k", [(1024, 2048, 410), (64, 64, 64), (300, 17, 1000)])
def test_matmul_split_is_the_wrappers_plan(m, n, k):
    a = _meta(m, k, dtype=torch.bfloat16)
    b = _meta(k, n + (-n) % 8, dtype=torch.bfloat16)[:, :n]
    (name, args, sp), = _seen(lambda: tgm.matmul(a, b))
    assert (sp.split, sp.chunk) == tgm.matmul_plan(m, n, k)
    (_, _, sp32), = _seen(lambda: tgm.matmul(a.float(), b.float()))
    assert sp32.split == 1 and sp32.launches[0].kernel == "matmul_simt_kernel"


@pytest.mark.parametrize("b,s,h,kv,d,nb", [(8, 1, 16, 2, 128, 16), (2, 32, 16, 2, 128, 32),
                                           (1, 5, 8, 1, 256, 10), (4, 1, 8, 8, 64, 3)])
def test_paged_split_is_the_wrappers_plan(b, s, h, kv, d, nb):
    q = _meta(b, s, h, d, dtype=torch.bfloat16)
    pool = _meta(b * nb, 16, kv, d)
    tables = torch.zeros((b, nb), dtype=torch.int32, device="meta")
    qpos = torch.zeros((b, s), dtype=torch.int32, device="meta")
    (name, args, sp), = _seen(lambda: tpa.paged_attention(q, pool, pool, tables, qpos))
    plan = tpa.paged_split_plan(b, s, h, kv, d, nb, 16)
    assert (sp.split, sp.chunk, sp.tile[0]) == (plan.splits, plan.chunk, plan.row_tile)
    assert args[8:11] == (plan.row_tile, plan.chunk, plan.splits)


def test_meta_route_outputs_are_the_plain_versions_shapes():
    """The meta route's outputs have the shape and dtype of the plain
    version's on the CPU, for every kernel."""
    rng = np.random.default_rng(0)

    def both(fn, *shapes, ints=None):
        cpu = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for sh in shapes]
        if ints is not None:
            cpu.append(torch.tensor(ints, dtype=torch.int32))
        meta = [t.to("meta") for t in cpu]
        out_c, out_m = fn(*cpu), fn(*meta)
        assert out_m.device.type == "meta"
        assert (out_m.shape, out_m.dtype) == (out_c.shape, out_c.dtype)

    both(lambda dy, w, i: tgm.dx_gathered(dy, w, i, block_size=8), (12, 20), (6, 20), ints=[0, 2])
    both(lambda x, dy, i: tgm.dw_gathered(x, dy, i, block_size=8), (12, 6), (12, 20), ints=[1])
    both(lambda a, b: tgm.matmul(a, b), (5, 7), (7, 3))
    both(lambda dy: tgm.importance(dy), (9, 11))
    x, dy = (2, 4, 6, 6), (2, 16, 6, 6)
    both(lambda x_, dy_, i: tops.conv_dw_fused_scatter(
        x_, dy_, i, kh=3, kw=3, stride=(1, 1), padding=((1, 1), (1, 1)), dilation=(1, 1),
        groups=1, block_size=8), x, dy, ints=[1])
    both(lambda dy_, w_, i: tops.conv_dx_fused(
        dy_, w_, i, hw=(6, 6), stride=(1, 1), padding=((1, 1), (1, 1)), dilation=(1, 1),
        groups=1, block_size=8), dy, (16, 4, 3, 3), ints=[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' geometry entry points are built with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_geometry_reports_equal_the_specs(cuda, name):
    """On the card: ``<name>_geometry`` (the launch's own grid, block,
    shared memory, split and stages) equals ``specs.py``'s at every case."""
    for args in CASES[name]:
        assert tgm.geometry(name, args) == specs.spec_for_launch(name, args).geometry(), args
