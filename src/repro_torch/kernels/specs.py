"""Launch geometry, work and traffic of every hand-written kernel.

The twin of ``repro.kernels.specs``, written for the CUDA kernels of
``csrc/`` rather than the TPU's BlockSpecs. For one call of a wrapper,
at the operand shapes it passes, a :class:`KernelSpec` gives:

  * the launches: each grid, block and shared memory (dynamic, and the
    kernel's static ``__shared__`` arrays), the main kernel first, then a
    split's reduce or combine pass;
  * the tile (output rows, output columns, depth of a pipeline stage),
    the stages of the shared-memory ring and the split (split-K partials,
    or split-KV blocks) with its chunk;
  * ``tile_flops``: what the launched tiles compute, each at its whole
    tile edge and stage depth; ``product_flops``: the product the wrapper
    asks for (its plain version's, the compact width ``KB*bs`` with a
    ragged tail's phantom channels); ``useful_flops``: what the function
    needs (2 a multiply-add over the real kept channels; ``chip_smoke.py``'s
    bounds read it);
  * :func:`emulate_bytes`: what the tile schedule moves, the grid swept
    and every tile's panels loaded from memory, plus a split's reduce or
    combine; ``least_bytes``: each input read once, each output written
    once (the bounds' bytes).

The grid, block, dynamic shared memory, split and stages are the ones
each kernel's ``<name>_launch`` uses: each source's ``<name>_geometry``
C entry point reports them from the same function (``csrc/geometry.cuh``),
and ``chip_smoke.py``'s ``[audit]`` holds every launch's report to this
module's. The plans are the wrappers' own (``gathered_matmul.dw_plan``,
``conv_dw_plan``, ``matmul_plan``, ``paged_attention.paged_split_plan``).

Where the work depends on data (the kept blocks, the query positions),
a spec takes them when they are known (``block_idx``, ``qpos``); without
them it assumes every kept block whole and not the ragged tail unless
every block is kept, and every query row seeing the whole table.
:func:`spec_for_launch` builds the spec of one launch from the integer
arguments a wrapper hands its C entry point.
"""
from __future__ import annotations

from collections.abc import Iterator, Sequence
import dataclasses
import math

# the H100's streaming multiprocessors (dx_gathered's stage count reads the card's)
SMS = 132
# tile.cuh::reduce_blocks' cap on the split reduce's grid
_REDUCE_MAX_BLOCKS = 4096


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One CUDA launch: grid and block (x, y, z), dynamic shared memory and
    the kernel's static ``__shared__`` bytes."""

    kernel: str
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    smem: int = 0
    static_smem: int = 0

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def shared_bytes(self) -> int:
        return self.smem + self.static_smem


@dataclasses.dataclass(frozen=True)
class Tile:
    """One block of the main launch: the output element block it writes
    (``origin`` and ``extent`` per output dim, before the kernel's
    masking), the ``block_idx`` entries it loads, its FLOPs at whole tile
    edges and the bytes it reads and writes."""

    point: tuple[int, int, int]
    origin: tuple[int, ...]
    extent: tuple[int, ...]
    loads: tuple[int, ...] = ()
    flops: int = 0
    reads: int = 0
    writes: int = 0


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One wrapper call's launches, tiling, work and traffic (module
    docstring). ``operands`` are the shapes the kernel assumes, ``output``
    its output's shape, ``n_blocks`` the number of channel blocks its
    ``block_idx`` may address (0: no ``block_idx``), ``contract`` the
    wrapper-side conditions the kernel relies on (name -> holds)."""

    name: str
    launches: tuple[Launch, ...]
    tile: tuple[int, int, int]
    stages: int
    split: int
    chunk: int
    tile_flops: int
    product_flops: int
    useful_flops: int
    least_bytes: int
    extra_bytes: int  # the second launch's (a split's reduce or combine)
    operands: dict
    output: tuple[int, ...]
    block_idx: tuple[int, ...] | None = None
    n_blocks: int = 0
    groups: int = 1
    contract: dict = dataclasses.field(default_factory=dict)
    tiles_fn: object = None  # grid point -> Tile (the main launch)

    @property
    def shared_bytes(self) -> int:
        """The most shared memory one block of any launch takes."""
        return max((ln.shared_bytes for ln in self.launches), default=0)

    def geometry(self) -> tuple[int, ...]:
        """The ``<name>_geometry`` layout (``csrc/geometry.cuh``): grid,
        block, dynamic shared memory, split and stages of the first
        launch, grid and block of the second; zeros where there is none."""
        out = [0] * 16
        for i, ln in enumerate(self.launches[:2]):
            o = 0 if i == 0 else 9
            out[o:o + 3] = ln.grid
            out[o + 3:o + 6] = ln.block
        if self.launches:
            out[6] = self.launches[0].smem
            out[8] = self.stages
        out[7] = self.split
        return tuple(out)

    def tiles(self) -> Iterator[Tile]:
        """Every block of the main launch, x fastest."""
        if not self.launches or self.tiles_fn is None:
            return
        gx, gy, gz = self.launches[0].grid
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    yield self.tiles_fn((x, y, z))


def emulate_bytes(spec: KernelSpec) -> int:
    """What the tile schedule moves: every block of the main launch
    loading its panels (and its ``block_idx`` entries) from memory and
    writing its outputs, plus the second launch's traffic."""
    return sum(t.reads + t.writes for t in spec.tiles()) + spec.extra_bytes


def _kept(block_idx, kb: int, bs: int, n: int) -> tuple[int, int]:
    """(real kept channels, the compact reduction's end) of ``kb`` kept
    blocks of ``bs`` over ``n`` channels: exact given ``block_idx``,
    else the ragged tail taken as kept only when every block is."""
    nb = _cdiv(n, bs)
    if block_idx is not None:
        real = sum(max(0, min(bs, n - b * bs)) for b in block_idx)
        last = block_idx[-1] if len(block_idx) else 0
        end = kb * bs - bs + max(0, min(bs, n - last * bs)) if kb else 0
        return real, end
    tail = nb * bs - n if kb >= nb else 0
    return min(kb * bs, n) if kb >= nb else kb * bs, kb * bs - tail


def _itemsize(bf16: int) -> int:
    return 2 if bf16 else 4


# ----------------------------------------------------------------------
# the 64x64 tensor-core kernels (csrc/mma.cuh)
# ----------------------------------------------------------------------

_TILE, _BK, _THREADS = 64, 32, 128
_TC_STAGES = 3
_LDS = _TILE + 8  # the dW kernels' stage row


def _ldk(it: int) -> int:
    return _BK + 16 // it


def dx_gathered_spec(m: int, n: int, d: int, kb: int, bs: int, bf16: int, *,
                     block_idx: Sequence[int] | None = None, sms: int = SMS) -> KernelSpec:
    """``dx_gathered`` at ``dy [m, n]``, ``w [d, n]``, ``kb`` kept blocks of
    ``bs``: one block a 64x64 output tile, the reduction over the compact
    channels to the last real one, in 32-deep stages of a 4-deep ring
    where the grid fills at most three blocks an SM, else 3 deep."""
    it = _itemsize(bf16)
    real, k_end = _kept(block_idx, kb, bs, n)
    col_tiles, row_tiles = _cdiv(d, _TILE), _cdiv(m, _TILE)
    tiles = col_tiles * row_tiles
    launches, stages = (), 0
    if m and d:
        stages = 4 if tiles <= 3 * sms else 3
        launches = (Launch("dx_gathered_kernel", (tiles, 1, 1), (_THREADS, 1, 1),
                           stages * 2 * _TILE * _ldk(it) * it),)
    depth = _cdiv(k_end, _BK) * _BK
    flops = 2 * _TILE * _TILE * depth

    def tile(p):
        rt, ct = divmod(p[0], col_tiles)
        rows, cols = min(_TILE, m - rt * _TILE), min(_TILE, d - ct * _TILE)
        return Tile(p, (rt * _TILE, ct * _TILE), (_TILE, _TILE), tuple(range(kb)), flops,
                    (rows + cols) * k_end * it + 4 * kb, rows * cols * 4)

    return KernelSpec(
        "dx_gathered", launches, (_TILE, _TILE, _BK), stages, 1, 0,
        tile_flops=(tiles if launches else 0) * flops, product_flops=2 * m * d * kb * bs,
        useful_flops=2 * m * d * real,
        least_bytes=(m * real + d * real) * it + m * d * 4 + 4 * kb, extra_bytes=0,
        operands={"dy": ((m, n), it), "w": ((d, n), it), "block_idx": ((kb,), 4)},
        output=(m, d), block_idx=None if block_idx is None else tuple(block_idx),
        n_blocks=_cdiv(n, bs), tiles_fn=tile)


def _split_rows(rows: int, s: int, chunk: int) -> list[int]:
    """Rows of each of ``s`` splits of ``chunk`` over ``rows``."""
    if s <= 1:
        return [rows]
    return [max(0, min(rows, (i + 1) * chunk) - i * chunk) for i in range(s)]


def _working(j: int, o0: int, bs: int, n: int, block_idx) -> bool:
    """Does compact column tile ``o0`` of kept block ``j`` hold a real
    channel (the dW kernels skip the others)? Without ``block_idx`` block
    ``j`` is taken as the tail only when every block is kept."""
    b = block_idx[j] if block_idx is not None else j
    if block_idx is None and b < _cdiv(n, bs) - 1:
        return True
    return b * bs + o0 < n


def _reduce_launch(kernel: str, n: int) -> Launch:
    return Launch(kernel, (min(_cdiv(n, 256), _REDUCE_MAX_BLOCKS), 1, 1), (256, 1, 1))


def _dw_tiles(kb, bs, n, rows_total, s, chunk, p_rows, it, block_idx, ctpb, phantom_split):
    """Tile function and FLOPs of the dW kernels' grid (kept blocks x
    column tiles, row tiles of ``p_rows``, splits): a working tile sums
    its split's rows in 32-deep stages; a phantom one (no real channel)
    writes its zeros, or with ``s > 1`` nothing where ``phantom_split`` is
    False (``dw_gathered``'s reduce writes them)."""
    rows = _split_rows(rows_total, s, chunk)

    def tile(p):
        j, c = divmod(p[0], ctpb)
        o0 = c * _TILE
        pr, oc = min(_TILE, p_rows - p[1] * _TILE), min(_TILE, bs - o0)
        if not _working(j, o0, bs, n, block_idx):
            writes = pr * oc * 4 if s == 1 or phantom_split else 0
            return Tile(p, (p[1] * _TILE, j * bs + o0), (_TILE, _TILE), (j,), 0, 4, writes)
        r = rows[p[2]]
        return Tile(p, (p[1] * _TILE, j * bs + o0), (_TILE, _TILE), (j,),
                    2 * _TILE * _TILE * _cdiv(r, _BK) * _BK, r * (pr + oc) * it + 4,
                    pr * oc * 4)

    work = sum(_working(j, c * _TILE, bs, n, block_idx) for j in range(kb) for c in range(ctpb))
    flops = work * _cdiv(p_rows, _TILE) * sum(2 * _TILE * _TILE * _cdiv(r, _BK) * _BK
                                              for r in rows)
    return tile, flops


def dw_gathered_spec(m: int, d: int, n: int, kb: int, bs: int, s: int, chunk: int, bf16: int,
                     *, block_idx: Sequence[int] | None = None) -> KernelSpec:
    """``dw_gathered`` at ``x [m, d]``, ``dy [m, n]``: grid (kept blocks x
    64-wide column tiles of a block, row tiles of ``d``, splits), each
    split summing its chunk of the ``m`` rows in 32-row stages, the
    phantom column tiles of a ragged tail idle; ``s > 1`` adds the reduce
    of the ``[s, d, kb*bs]`` partials."""
    it = _itemsize(bf16)
    nc = kb * bs
    real, _ = _kept(block_idx, kb, bs, n)
    ctpb = _cdiv(bs, _TILE)
    launches = ()
    if d and nc:
        launches = (Launch("dw_gathered_kernel", (kb * ctpb, _cdiv(d, _TILE), s),
                           (_THREADS, 1, 1), _TC_STAGES * 2 * _BK * _LDS * it),)
        if s > 1:
            launches += (Launch("dw_reduce", (_cdiv(d * nc, 32), 1, 1), (32, 8, 1), 0,
                                8 * 32 * 4),)
    tile, flops = _dw_tiles(kb, bs, n, m, s, chunk, d, it, block_idx, ctpb, False)
    return KernelSpec(
        "dw_gathered", launches, (_TILE, _TILE, _BK), _TC_STAGES if launches else 0, s, chunk,
        tile_flops=flops if launches else 0, product_flops=2 * m * d * nc,
        useful_flops=2 * m * d * real,
        least_bytes=(m * d + m * real) * it + d * nc * 4 + 4 * kb,
        extra_bytes=d * nc * 4 * (s + 1) + 4 * kb if s > 1 else 0,
        operands={"x": ((m, d), it), "dy": ((m, n), it), "block_idx": ((kb,), 4)},
        output=(d, nc), block_idx=None if block_idx is None else tuple(block_idx),
        n_blocks=_cdiv(n, bs), tiles_fn=tile)


def conv_dw_fused_spec(b: int, h_pad: int, g: int, w_pad: int, cg: int, h_out: int, w_out: int,
                       c_pad: int, c_valid: int, kh: int, kw: int, sh: int, sw: int, dh: int,
                       dw: int, kb: int, bs: int, s: int, chunk: int, bf16: int, *,
                       block_idx: Sequence[int] | None = None) -> KernelSpec:
    """``conv_dw_fused`` on ``xg [b*h_pad, g, w_pad, cg]``, ``dy2r [b*h_out,
    w_out, c_pad]``: grid (kept blocks x column tiles, row tiles of P =
    kh*kw*cg, splits), each split summing its chunk of the b*h_out*w_out
    output positions in 32-deep stages; ``s > 1`` adds tile.cuh's reduce."""
    del sh, sw, dh, dw
    it = _itemsize(bf16)
    p_rows = kh * kw * cg
    nc = kb * bs
    r_all = b * h_out * w_out
    real, _ = _kept(block_idx, kb, bs, c_valid)
    ctpb = _cdiv(bs, _TILE)
    main = Launch("conv_dw_fused_kernel", (kb * ctpb, _cdiv(p_rows, _TILE), s), (_THREADS, 1, 1),
                  _TC_STAGES * 2 * _BK * _LDS * it)
    launches = (main,) + ((_reduce_launch("reduce_splits", p_rows * nc),) if s > 1 else ())
    tile, flops = _dw_tiles(kb, bs, c_valid, r_all, s, chunk, p_rows, it, block_idx, ctpb,
                           True)
    image = b * h_pad * g * w_pad * cg
    bpg = (c_pad // bs) // g if g and bs else 0
    return KernelSpec(
        "conv_dw_fused", launches, (_TILE, _TILE, _BK), _TC_STAGES, s, chunk,
        tile_flops=flops, product_flops=2 * r_all * p_rows * nc,
        useful_flops=2 * r_all * p_rows * real,
        least_bytes=(image + r_all * real) * it + p_rows * nc * 4 + 4 * kb,
        extra_bytes=p_rows * nc * 4 * (s + 1) if s > 1 else 0,
        operands={"xg": ((b * h_pad, g, w_pad, cg), it), "dy2r": ((b * h_out, w_out, c_pad), it),
                  "block_idx": ((kb,), 4)},
        output=(kh * kw * cg, nc), block_idx=None if block_idx is None else tuple(block_idx),
        n_blocks=c_pad // bs if bs else 0, groups=g,
        contract={"C_pad is whole blocks": bs > 0 and c_pad % bs == 0,
                  "every group has whole blocks": bpg > 0 and (c_pad // bs) % g == 0,
                  "c_valid <= C_pad": c_valid <= c_pad},
        tiles_fn=tile)


def _phase_axis(r: int, lo: int, s: int, length: int) -> tuple[int, int]:
    """conv_dx_fused.cu's ``phase_axis``: the first interior index of
    residue ``r`` and their count."""
    i0 = ((r - lo) % s + s) % s
    return i0, ((length - i0 + s - 1) // s if i0 < length else 0)


def _count_taps(k: int, d: int, s: int, r: int) -> int:
    return sum(1 for t in range(k) if (t * d) % s == r)


def conv_dx_fused_spec(b: int, h: int, w: int, ph0: int, pw0: int, g: int, cg: int, h_out: int,
                       w_out: int, c_pad: int, c_valid: int, kh: int, kw: int, sh: int, sw: int,
                       dh: int, dw: int, kb: int, bs: int, bf16: int, *,
                       block_idx: Sequence[int] | None = None) -> KernelSpec:
    """``conv_dx_fused`` from ``dy2r [b*h_out, w_out, c_pad]`` and ``w2k
    [kh, kw, cg, kb*bs]`` to the interior ``[b*h, g, w, cg]``: grid (64-pixel
    row tiles of every stride phase, column tiles of cg, groups), each
    tile reducing over its phase's taps times its group's kept channels
    in 32-deep stages. Without ``block_idx`` the kept blocks are spread
    over the groups evenly."""
    it = _itemsize(bf16)
    bpg = (c_pad // bs) // g if g and bs else 0
    phases = []  # (row tiles, pixels, taps) of each phase, in grid order
    for ph in range(sh):
        for pw in range(sw):
            _, nh = _phase_axis(ph, ph0, sh, h)
            _, nw = _phase_axis(pw, pw0, sw, w)
            phases.append((_cdiv(b * nh * nw, _TILE), b * nh * nw,
                           _count_taps(kh, dh, sh, ph) * _count_taps(kw, dw, sw, pw)))
    tiles = sum(t for t, _, _ in phases)
    blocks = list(block_idx) if block_idx is not None else [
        gi * bpg + i for gi in range(g) for i in range(kb // g + (gi < kb % g))][:kb]

    def chunks_of(grp):
        n = 0
        for blk in blocks:
            kv = min(bs, c_valid - blk * bs)
            if bpg and blk // bpg == grp and kv > 0:
                n += _cdiv(kv, _BK)
        return n

    cpt = [chunks_of(gi) for gi in range(g)]
    col_tiles = _cdiv(cg, _TILE)
    launches = ()
    if tiles and cg and g:
        launches = (Launch("conv_dx_fused_kernel", (tiles, col_tiles, g), (_THREADS, 1, 1),
                           _TC_STAGES * 2 * _TILE * _ldk(it) * it),)
    steps = sum(t * taps for t, _, taps in phases) * col_tiles * sum(cpt)
    real, _ = _kept(block_idx, kb, bs, c_valid)
    r_all, p_rows = b * h_out * w_out, kh * kw * cg
    interior = b * h * g * w * cg
    starts = []  # (first tile, tiles, pixels, taps) of each phase
    t0 = 0
    for t, npix, taps in phases:
        starts.append((t0, t, npix, taps))
        t0 += t

    def tile(p):
        x = p[0]
        for first, t, npix, taps in starts:
            if x < first + t:
                break
        u = x - first
        pix = min(_TILE, npix - u * _TILE)
        cols = min(_TILE, cg - p[1] * _TILE)
        nk = taps * cpt[p[2]]
        return Tile(p, (x * _TILE, p[2], p[1] * _TILE), (_TILE, 1, _TILE), tuple(range(kb)),
                    2 * _TILE * _TILE * _BK * nk, nk * _BK * (pix + cols) * it + 4 * kb,
                    pix * cols * 4)

    return KernelSpec(
        "conv_dx_fused", launches, (_TILE, _TILE, _BK), _TC_STAGES if launches else 0, 1, 0,
        tile_flops=steps * 2 * _TILE * _TILE * _BK if launches else 0,
        product_flops=2 * r_all * p_rows * kb * bs, useful_flops=2 * r_all * p_rows * real,
        least_bytes=r_all * real * it + p_rows * kb * bs * it + interior * 4 + 4 * kb,
        extra_bytes=0,
        operands={"dy2r": ((b * h_out, w_out, c_pad), it), "w2k": ((kh, kw, cg, kb * bs), it),
                  "block_idx": ((kb,), 4)},
        output=(tiles * _TILE, g, cg),
        block_idx=None if block_idx is None else tuple(block_idx),
        n_blocks=c_pad // bs if bs else 0, groups=g,
        contract={"C_pad is whole blocks": bs > 0 and c_pad % bs == 0,
                  "every group has whole blocks": bpg > 0 and (c_pad // bs) % g == 0,
                  "c_valid <= C_pad": c_valid <= c_pad},
        tiles_fn=tile)


# ----------------------------------------------------------------------
# importance, matmul
# ----------------------------------------------------------------------

_IMP_COLS, _IMP_WARPS = 32, 8


def importance_spec(m: int, n: int, s: int, chunk: int, bf16: int) -> KernelSpec:
    """``importance`` over ``dy [m, n]``: grid (32-channel blocks, row
    splits of ``chunk``) of eight warps; ``s > 1`` adds the in-order finish
    pass over the ``[s, n]`` partials."""
    it = _itemsize(bf16)
    launches = (Launch("importance_kernel", (_cdiv(n, _IMP_COLS), s, 1),
                       (_IMP_COLS * _IMP_WARPS, 1, 1), 0, _IMP_WARPS * _IMP_COLS * 4),)
    if s > 1:
        launches += (Launch("finish_kernel", (_cdiv(n, 256), 1, 1), (256, 1, 1)),)
    rows = _split_rows(m, s, chunk)

    def tile(p):
        r, cols = rows[p[1]], min(_IMP_COLS, n - p[0] * _IMP_COLS)
        return Tile(p, (p[1] * chunk, p[0] * _IMP_COLS), (chunk, _IMP_COLS), (),
                    2 * r * _IMP_COLS, r * cols * it, cols * 4)

    return KernelSpec(
        "importance", launches, (chunk, _IMP_COLS, 1), 0, s, chunk,
        tile_flops=2 * m * _cdiv(n, _IMP_COLS) * _IMP_COLS, product_flops=2 * m * n,
        useful_flops=2 * m * n, least_bytes=m * n * it + n * 4,
        extra_bytes=n * 4 * (s + 1) if s > 1 else 0,
        operands={"dy": ((m, n), it)}, output=(m if s == 1 else s * chunk, n), tiles_fn=tile)


_MM_TILE, _MM_BK, _MM_STAGES, _MM_THREADS = 128, 64, 4, 8 * 32 + 32
_MM_SMEM = 2 * _MM_STAGES * _MM_TILE * _MM_BK * 2 + 2 * _MM_STAGES * 8 + 1024
_SIMT_TILE, _SIMT_BK, _SIMT_THREADS = 64, 16, 256


def matmul_spec(m: int, n: int, k: int, sa_m: int, sa_k: int, sb_k: int, sb_n: int, s: int,
                chunk: int, bf16: int) -> KernelSpec:
    """``matmul`` of ``A [m, k] @ B [k, n]``: bf16 on ``wgmma`` in 128x128
    tiles 64 deep, a 4-deep TMA ring, split-K by ``matmul_plan`` with
    tile.cuh's reduce; fp32 on the SIMT 64x64 tile, 16-deep panels."""
    del sa_m, sa_k, sb_k, sb_n
    it = _itemsize(bf16)
    if bf16:
        edge, depth, stages = _MM_TILE, _MM_BK, _MM_STAGES
        launches = (Launch("matmul_wgmma_kernel", (_cdiv(n, edge), _cdiv(m, edge), s),
                           (_MM_THREADS, 1, 1), _MM_SMEM),)
        if s > 1:
            launches += (_reduce_launch("reduce_splits", m * n),)
        ks = _split_rows(k, s, chunk)
    else:
        edge, depth, stages, s, chunk = _SIMT_TILE, _SIMT_BK, 0, 1, 0
        launches = (Launch("matmul_simt_kernel", (_cdiv(n, edge), _cdiv(m, edge), 1),
                           (_SIMT_THREADS, 1, 1), 0, 2 * _SIMT_BK * (_SIMT_TILE + 4) * 4),)
        ks = [k]
    rt, ct = _cdiv(m, edge), _cdiv(n, edge)

    def tile(p):
        rows, cols, kk = min(edge, m - p[1] * edge), min(edge, n - p[0] * edge), ks[p[2]]
        return Tile(p, (p[1] * edge, p[0] * edge), (edge, edge), (),
                    2 * edge * edge * _cdiv(kk, depth) * depth, kk * (rows + cols) * it,
                    rows * cols * 4)

    return KernelSpec(
        "matmul", launches, (edge, edge, depth), stages, s, chunk,
        tile_flops=rt * ct * sum(2 * edge * edge * _cdiv(r, depth) * depth for r in ks),
        product_flops=2 * m * n * k, useful_flops=2 * m * n * k,
        least_bytes=(m * k + k * n) * it + m * n * 4,
        extra_bytes=m * n * 4 * (s + 1) if s > 1 else 0,
        operands={"a": ((m, k), it), "b": ((k, n), it)}, output=(m, n), tiles_fn=tile)


# ----------------------------------------------------------------------
# paged attention
# ----------------------------------------------------------------------

_PA_STAGES, _PA_TPR, _PA_MMA_ROWS, _PA_CHUNK_VALUES = 2, 16, 64, 4096
_PA_COMBINE_MAX_P = 1024


def _pad_dim(d: int) -> int:
    return 1 << (d - 1).bit_length()


def paged_attention_spec(b: int, s: int, h: int, kv: int, d: int, n_pages: int, bs: int,
                         nb: int, rows: int, chunk: int, p: int, q_bf16: int, kv_bf16: int, *,
                         qpos: Sequence[Sequence[int]] | None = None,
                         tables: Sequence[Sequence[int]] | None = None) -> KernelSpec:
    """``paged_attention`` of ``q [b, s, h, d]`` over ``[n_pages, bs, kv, d]``
    pools through a ``[b, nb]`` table: grid (splits, row tiles of ``rows``
    query rows of a KV head, slots x KV heads); a block scores its split's
    chunks of ``chunk`` keys at the tiled head width (QK and PV, 2 FLOPs
    a multiply-add each); ``p > 1`` adds the combine pass. ``qpos`` (each
    slot's positions) fixes the keys each slot sees; without it every row
    sees the whole table. ``tables`` (each slot's pages) are the block
    indices the in-bounds check reads."""
    itq, itk = _itemsize(q_bf16), _itemsize(kv_bf16)
    mma = rows == _PA_MMA_ROWS
    dp = _pad_dim(d)
    ck = _PA_CHUNK_VALUES // dp
    dk, dq, sp = dp + 16 // itk, dp + 4, ck + 1
    smem = itk * _PA_STAGES * 2 * ck * dk + 4 * (rows * dq + (0 if mma else rows * sp))
    g = h // kv if kv else 0
    row_tiles = _cdiv(s * g, rows)
    threads = 128 if mma else rows * _PA_TPR
    launches = (Launch("paged_attn_mma" if mma else "paged_attn_simt", (p, row_tiles, b * kv),
                       (threads, 1, 1), smem, (threads // 32) * 4),)
    if p > 1:
        launches += (Launch("paged_combine", (b * s * h, 1, 1), (d, 1, 1), 0,
                            2 * _PA_COMBINE_MAX_P * 4 + 4),)
    if qpos is None:
        keys = [nb * bs] * b
        visible = b * s * nb * bs
    else:
        keys = [min(max(row) + 1, nb * bs) for row in qpos]
        visible = sum(min(x, nb * bs - 1) + 1 for row in qpos for x in row)
    pages = sum(_cdiv(kk, bs) for kk in keys)

    def split_keys(slot, sp_i):
        n_chunks = _cdiv(keys[slot], ck)
        lo, hi = sp_i * n_chunks // p * ck, (sp_i + 1) * n_chunks // p * ck
        return max(0, min(hi, keys[slot]) - lo), (sp_i + 1) * n_chunks // p - sp_i * n_chunks // p

    def tile(pt):
        slot, head = divmod(pt[2], kv)
        n_keys, n_chunks = split_keys(slot, pt[0])
        r = min(rows, s * g - pt[1] * rows)
        out = r * d * 4 if p == 1 else r * (d + 4) * 4
        return Tile(pt, (slot, pt[1] * rows, head), (1, rows, 1), tuple(range(nb)),
                    4 * rows * dp * n_chunks * ck,
                    r * d * itq + 2 * n_keys * d * itk + nb * 4 + s * 4, out)

    tile_flops = sum(4 * rows * dp * split_keys(slot, sp_i)[1] * ck
                     for slot in range(b) for sp_i in range(p)) * kv * row_tiles
    least = (b * s * h * d * itq + 2 * pages * bs * kv * d * itk + b * nb * 4 + b * s * 4
             + b * s * h * d * 4)
    return KernelSpec(
        "paged_attention", launches, (rows, ck, dp), _PA_STAGES, p, ck,
        tile_flops=tile_flops, product_flops=4 * h * d * visible,
        useful_flops=4 * h * d * visible, least_bytes=least,
        extra_bytes=b * s * h * ((d + 4) * 4 * p + d * 4) if p > 1 else 0,
        operands={"q": ((b, s, h, d), itq), "k_pool": ((n_pages, bs, kv, d), itk),
                  "v_pool": ((n_pages, bs, kv, d), itk), "block_tables": ((b, nb), 4),
                  "qpos": ((b, s), 4)},
        output=(b, s * g, kv), block_idx=None if tables is None else tuple(
            x for row in tables for x in row),
        n_blocks=n_pages,
        contract={"chunk is the kernel's": chunk == ck, "splits in [1, 1024]":
                  1 <= p <= _PA_COMBINE_MAX_P, "KV heads divide H": kv > 0 and h % kv == 0},
        tiles_fn=tile)


# ----------------------------------------------------------------------
# a launch's spec from its C arguments
# ----------------------------------------------------------------------

# the integer arguments of each ``<name>_launch`` (after its pointers), in order
LAUNCH_ARGS = {
    "dx_gathered": ("m", "n", "d", "kb", "bs", "bf16"),
    "dw_gathered": ("m", "d", "n", "kb", "bs", "s", "chunk", "bf16"),
    "conv_dw_fused": ("b", "h_pad", "g", "w_pad", "cg", "h_out", "w_out", "c_pad", "c_valid",
                      "kh", "kw", "sh", "sw", "dh", "dw", "kb", "bs", "s", "chunk", "bf16"),
    "conv_dx_fused": ("b", "h", "w", "ph0", "pw0", "g", "cg", "h_out", "w_out", "c_pad",
                      "c_valid", "kh", "kw", "sh", "sw", "dh", "dw", "kb", "bs", "bf16"),
    "matmul": ("m", "n", "k", "sa_m", "sa_k", "sb_k", "sb_n", "s", "chunk", "bf16"),
    "importance": ("m", "n", "s", "chunk", "bf16"),
    "paged_attention": ("b", "s", "h", "kv", "d", "n_pages", "bs", "nb", "rows", "chunk", "p",
                        "q_bf16", "kv_bf16"),
}

_SPECS = {
    "dx_gathered": dx_gathered_spec, "dw_gathered": dw_gathered_spec,
    "conv_dw_fused": conv_dw_fused_spec, "conv_dx_fused": conv_dx_fused_spec,
    "matmul": matmul_spec, "importance": importance_spec,
    "paged_attention": paged_attention_spec,
}


def spec_for_launch(name: str, args: Sequence[int], **data) -> KernelSpec:
    """The spec of one ``<name>_launch`` call from its integer arguments
    (:data:`LAUNCH_ARGS` order); ``data``: ``block_idx`` or ``qpos`` /
    ``tables`` where known."""
    if len(args) != len(LAUNCH_ARGS[name]):
        raise ValueError(f"{name}: {len(args)} arguments, the launch takes "
                         f"{len(LAUNCH_ARGS[name])}")
    return _SPECS[name](*(int(a) for a in args), **data)
