"""Channel-block-gathered backward contractions: the kernels of ssProp.

The twin of ``repro.kernels.gathered_matmul``. The kernels are CUDA C++
for Hopper (``csrc/dx_gathered.cu``, ``csrc/dw_gathered.cu``,
``csrc/conv_dw_fused.cu``, ``csrc/conv_dx_fused.cu``, ``csrc/matmul.cu``,
``csrc/importance.cu``; each source says how it is laid out); this
module holds one wrapper per kernel, its plain PyTorch version
(``*_ref``) and :data:`launches`, the number of times each wrapper
launched its kernel.

  * ``dx_gathered``  : dX[M, D_in]  = Σ_kb dY[:, blk] @ W[:, blk]ᵀ
  * ``dw_gathered``  : dWk[D_in, KB·bs] = Xᵀ @ dY[:, kept]  (compact)
  * ``conv_dw_fused``: compact conv dW ``[Kh, Kw, Cg, KB·bs]`` with the
    im2col patch gather in the addressing
  * ``conv_dx_fused``: conv dX on the interior image ``[B·H, G, W, Cg]``
    (the padding ring is never computed) with the col2im scatter done as
    a gather
  * ``matmul``       : A[M, K] @ B[K, N] in fp32, operands read through
    their strides (the channel-granularity dense backward's products);
    bf16 operands go through TMA and ``wgmma`` and need 16-byte row
    pitches (:func:`gather_columns` makes them, :data:`repacks` counts
    the views that had to be copied), fp32 ones through the SIMT tile
  * ``importance``   : imp[N] = mean_M |dY[M, N]| in fp32

Layouts are the JAX package's (``xg``, ``dy2r``, ``w2k``: see
``kernels/ops.py``). Unlike the TPU kernels these take unpadded
operands: ragged rows, columns and channel tails (channels past ``N``
count as zeros) are masked in the kernel. Every kernel takes fp32 or
bf16 operands (both of one type), int32 ``block_idx``, accumulates in
fp32 and returns fp32.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel, or the wrapper raises.

Tiles and plans: ``matmul``'s bf16 kernel takes 128x128 output tiles
64 deep (:func:`matmul_plan` splits K where too few tiles fill the
card); ``conv_dw_fused``, ``dw_gathered``, ``conv_dx_fused`` and
``dx_gathered`` take 64x64 tiles in 32-deep stages on the tensor cores
(3xTF32 for fp32 operands, which :func:`matmul_tf32_terms` emulates;
``csrc/mma.cuh``); :func:`conv_dw_plan` and :func:`dw_plan` plan the two
dW kernels' split-K; the dX kernels write each output tile once.
``matmul``'s fp32 operands take ``tile.cuh``'s 64x64 SIMT tile. Every
split-K sums its partials in a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches by each wrapper (reset by whoever counts)
launches = {
    "dx_gathered": 0, "dw_gathered": 0, "conv_dw_fused": 0, "conv_dx_fused": 0,
    "matmul": 0, "importance": 0,
}
# operands a wrapper copied into an aligned buffer before launching
repacks = {"matmul": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_TARGET_BLOCKS = 8 * 132  # about eight resident blocks on each of the H100's 132 SMs
_TILE = 64  # output tile edge of the tensor-core kernels
_STAGE = 32  # reduction steps a stage of the tensor-core kernels takes
_SMS = 132  # the H100's streaming multiprocessors
_MM_TILE = 128  # matmul.cu's bf16 output tile edge
_MM_BK = 64  # matmul.cu's bf16 stage depth
_PITCH = 8  # TMA's 16-byte row pitch, in bf16 elements

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "dx_gathered": [_P] * 4 + [_I] * 6 + [_P],
    "dw_gathered": [_P] * 5 + [_I] * 7 + [_I, _P],
    "conv_dw_fused": [_P] * 5 + [_I] * 18 + [_L, _I, _P],
    "conv_dx_fused": [_P] * 4 + [_I] * 19 + [_I, _P],
    "matmul": [_P] * 4 + [_I] * 3 + [_L] * 4 + [_I] * 3 + [_P],
    "importance": [_P] * 3 + [_I] * 4 + [_I, _P],
}
_fns: dict[str, object] = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(name), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _on_cuda(name: str, *ops, block_idx=None, contiguous: bool = True) -> bool:
    """True for CUDA operands, False for CPU ones; raises for anything
    else, and for what the kernel does not take."""
    dev = ops[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if ops[0].dtype not in _DTYPES or any(t.dtype != ops[0].dtype for t in ops):
        raise TypeError(
            f"{name}: dtypes {[str(t.dtype) for t in ops]}; the kernel takes operands "
            "all float32 or all bfloat16"
        )
    tensors = ops
    if block_idx is not None:
        if block_idx.dtype != torch.int32:
            raise TypeError(f"{name}: block_idx must be int32, got {block_idx.dtype}")
        tensors = (*ops, block_idx)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return True


def _expand(block_idx: torch.Tensor, block_size: int) -> torch.Tensor:
    """Channel indices covered by the kept blocks, in block order."""
    offs = torch.arange(block_size, device=block_idx.device)
    return (block_idx.long()[:, None] * block_size + offs[None, :]).reshape(-1)


def pad_channels(a: torch.Tensor, block_size: int) -> torch.Tensor:
    """Zero-pad the last axis to a whole number of blocks."""
    pad = (-a.shape[-1]) % block_size
    return torch.nn.functional.pad(a, (0, pad)) if pad else a


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _working_col_tiles(kb: int, block_size: int, c_out: int) -> int:
    """64-wide column tiles of the compact output that hold a real
    channel: the ragged tail block's phantom tiles do no work (counted as
    if the tail were kept, the case of the stem, whose only block is the
    tail)."""
    col_tiles = _cdiv(block_size, _TILE)
    tail = c_out % block_size
    phantom = col_tiles - _cdiv(tail, _TILE) if tail else 0
    return max(1, kb * col_tiles - phantom)


# ----------------------------------------------------------------------
# dX = dY[:, kept] @ W[:, kept]^T
# ----------------------------------------------------------------------


def dx_gathered_ref(dy, w, block_idx, *, block_size: int = 128) -> torch.Tensor:
    """Plain version: the kept blocks of zero-padded dY and W gathered,
    then one fp32 einsum. dy [M, N], w [D_in, N] -> [M, D_in] fp32."""
    cols = _expand(block_idx, block_size)
    dy_k = pad_channels(dy, block_size).index_select(1, cols).float()
    w_k = pad_channels(w, block_size).index_select(1, cols).float()
    return torch.einsum("mk,dk->md", dy_k, w_k)


def dx_gathered(dy, w, block_idx, *, block_size: int = 128) -> torch.Tensor:
    """dX[M, D_in] from dY[M, N], W[D_in, N] and the kept block indices
    (int32, sorted), fp32."""
    if not _on_cuda("dx_gathered", dy, w, block_idx=block_idx):
        return dx_gathered_ref(dy, w, block_idx, block_size=block_size)
    m, n = dy.shape
    d_in, n2 = w.shape
    if n != n2:
        raise ValueError(f"dx_gathered: dy {tuple(dy.shape)} and w {tuple(w.shape)}")
    out = torch.empty((m, d_in), dtype=torch.float32, device=dy.device)
    _launch(
        "dx_gathered", dy.device, dy.data_ptr(), w.data_ptr(), block_idx.data_ptr(),
        out.data_ptr(), m, n, d_in, block_idx.shape[0], block_size,
        int(dy.dtype == torch.bfloat16),
    )
    return out


# ----------------------------------------------------------------------
# compact dW = X^T @ dY[:, kept]
# ----------------------------------------------------------------------


_SPLIT_SLOTS = 4 * _SMS  # one wave of the dW kernels' split blocks: 4 an SM


_MAX_CHUNK = 4096  # rows a dW split accumulates at most


def _split_plan(rows: int, work: int, min_rows: int) -> tuple[int, int]:
    """(S, chunk) of a dW kernel's deterministic split-K over ``rows``: as
    many splits as fit ``work`` (the output tiles that do work) into one
    wave of resident blocks, none shorter than ``min_rows``, and more
    where a chunk would pass ``_MAX_CHUNK`` rows; chunks are whole 32-row
    stages. The cap bounds the error of the tensor cores' fp32
    accumulation, which truncates, so that its error grows with the rows
    one accumulator sums: at the DDPM's 64x64 convs (524288 rows) one
    wave's 18080-row chunks missed the 1e-4 gate (``tools/dw_split_error.py``
    measures it on the card)."""
    s = max(1, min(_cdiv(rows, min_rows), _SPLIT_SLOTS // max(work, 1)))
    s = max(s, _cdiv(rows, _MAX_CHUNK))
    chunk = max(1, _cdiv(_cdiv(rows, s), _STAGE)) * _STAGE
    return max(1, _cdiv(rows, chunk)), chunk


def dw_plan(m: int, d_in: int, kb: int, block_size: int, n: int) -> tuple[int, int]:
    """(S, chunk) of ``dw_gathered``'s split-K over the ``m`` rows, none
    shorter than 128 rows, so that the partials stay small. Work is
    counted in 32-row halves of 64x64 tiles (two tiles an SM): the ragged
    tail block's phantom column tiles do none, and a tile whose rows end
    within its first half (the stem's D_in = 27) keeps two of its four
    warps idle and counts half. Chunks of whole 32-row stages start on a
    multiple of 8 rows (16 bytes of any row length, fp32 or bf16)."""
    work = _cdiv(d_in, _TILE // 2) * _working_col_tiles(kb, block_size, n)
    return _split_plan(m, work, 128)


def dw_gathered_ref(x, dy, block_idx, *, block_size: int = 128) -> torch.Tensor:
    """Plain version: x [M, D_in], dy [M, N] -> compact [D_in, KB*bs]
    fp32 (column block j is channel block ``block_idx[j]``)."""
    cols = _expand(block_idx, block_size)
    dy_k = pad_channels(dy, block_size).index_select(1, cols).float()
    return torch.einsum("md,mk->dk", x.float(), dy_k)


def dw_gathered(x, dy, block_idx, *, block_size: int = 128) -> torch.Tensor:
    """Compact dW[D_in, KB*block_size] from X[M, D_in], dY[M, N]; the
    caller scatters it."""
    if not _on_cuda("dw_gathered", x, dy, block_idx=block_idx):
        return dw_gathered_ref(x, dy, block_idx, block_size=block_size)
    m, d_in = x.shape
    m2, n = dy.shape
    if m != m2:
        raise ValueError(f"dw_gathered: x {tuple(x.shape)} and dy {tuple(dy.shape)}")
    kb = block_idx.shape[0]
    nc = kb * block_size
    s, chunk = dw_plan(m, d_in, kb, block_size, n)
    out = torch.empty((d_in, nc), dtype=torch.float32, device=x.device)
    partial = torch.empty((s, d_in, nc) if s > 1 else (0,), dtype=torch.float32, device=x.device)
    _launch(
        "dw_gathered", x.device, x.data_ptr(), dy.data_ptr(), block_idx.data_ptr(),
        partial.data_ptr(), out.data_ptr(), m, d_in, n, kb, block_size, s, chunk,
        int(x.dtype == torch.bfloat16),
    )
    return out


# ----------------------------------------------------------------------
# fused-im2col conv backward
#
#   xg   [B*H_pad, G, W_pad, Cg]   zero-padded input, group-blocked
#   dy2r [B*H_out, W_out, C_pad]   cotangent rows, channels zero-padded
#                                  to a block_size multiple
#   w2k  [Kh, Kw, Cg, KB*bs]       the kept blocks of the filters
# ----------------------------------------------------------------------


def _col_groups(block_idx, c_pad, groups, block_size):
    """Group of each compact column: kept block j belongs to group
    ``block_idx[j] // blocks_per_group``."""
    bpg = (c_pad // block_size) // groups
    return (block_idx.long() // bpg).repeat_interleave(block_size)


def conv_dw_plan(rows: int, p: int, kb: int, block_size: int, c_out: int) -> tuple[int, int]:
    """(S, chunk) of ``conv_dw_fused``'s split-K over the ``rows`` output
    positions, none shorter than 256 positions; work is the 64x64 output
    tiles that do work (the ragged tail block's phantom column tiles do
    none)."""
    return _split_plan(rows, _cdiv(p, _TILE) * _working_col_tiles(kb, block_size, c_out), 256)


def conv_dw_fused_ref(
    xg, dy2r, block_idx, *, kh_dim, kw_dim, stride, dilation, h_out,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Plain version: a loop over taps of strided slices of the padded
    rows, one fp32 einsum per tap and group. Returns ``[Kh, Kw, Cg,
    KB*bs]`` fp32."""
    del c_out  # the kernel's skip of phantom channels; zeros either way
    s_total, g, w_pad, cg = xg.shape
    m2, w_out, c_pad = dy2r.shape
    b = m2 // h_out
    h_pad = s_total // b
    (sh, sw), (dh, dw) = stride, dilation
    x5 = xg.reshape(b, h_pad, g, w_pad, cg).float()
    dyk = dy2r.reshape(b, h_out, w_out, c_pad).index_select(
        3, _expand(block_idx, block_size)).float()
    grp = _col_groups(block_idx, c_pad, g, block_size)
    out = torch.zeros((kh_dim, kw_dim, cg, dyk.shape[-1]), dtype=torch.float32, device=xg.device)
    for kh in range(kh_dim):
        rows = slice(kh * dh, kh * dh + sh * (h_out - 1) + 1, sh)
        for kw in range(kw_dim):
            cols = slice(kw * dw, kw * dw + sw * (w_out - 1) + 1, sw)
            xs = x5[:, rows, :, cols, :]  # [B, H_out, G, W_out, Cg]
            for gi in range(g):
                part = torch.einsum("bhwc,bhwn->cn", xs[:, :, gi], dyk)
                out[kh, kw] += part * (grp == gi).float()
    return out


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x``: round to the nearest value with
    10 mantissa bits, ties away from zero (the low 13 bits cleared)."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def matmul_tf32_terms(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """``a @ b`` as the tensor cores compute it for fp32 operands: each
    operand split as ``big + small`` (``big = tf32(x)``, ``small = tf32(x
    - big)``), then ``small·big + big·small + big·big`` (``terms=3``,
    3xTF32, as the gathered kernels run), ``big·small + big·big``
    (``terms=2``: ``a``'s small part dropped, exact where ``a`` is a TF32
    or bf16 value) or ``big·big`` alone (``terms=1``, plain TF32). A
    product of two TF32 values is exact in fp32, so each term is an fp32
    product."""
    if terms not in (1, 2, 3):
        raise ValueError(f"terms must be 1, 2 or 3, got {terms}")
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if terms == 1:
        return a_big @ b_big
    small_big = tf32_rna(a - a_big) @ b_big if terms == 3 else 0.0
    return small_big + a_big @ tf32_rna(b - b_big) + a_big @ b_big


def matmul_bf16_split(a: torch.Tensor, b: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """``a @ b`` on bf16 tensor cores for an fp32 ``a`` and a ``b`` whose
    values are bf16: ``a`` split as ``hi + lo`` (``hi = bf16(a)``, ``lo =
    bf16(a - hi)``), then ``hi·b + lo·b`` (``terms=2``) or ``hi·b`` alone
    (``terms=1``), each product accumulated in fp32."""
    if terms not in (1, 2):
        raise ValueError(f"terms must be 1 or 2, got {terms}")
    hi = a.to(torch.bfloat16).float()
    if terms == 1:
        return hi @ b.float()
    return (a - hi).to(torch.bfloat16).float() @ b.float() + hi @ b.float()


def conv_dw_fused(
    xg, dy2r, block_idx, *, kh_dim, kw_dim, stride, dilation, h_out,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Compact conv dW with the patch gather in the addressing.

    Returns ``[Kh, Kw, Cg, KB*block_size]`` fp32: tap-major; column
    block j is output-channel block ``block_idx[j]``. ``c_out`` (the
    real channel count, default ``C_pad``) lets the kernel skip the
    phantom channels of a ragged tail.
    """
    if not _on_cuda("conv_dw_fused", xg, dy2r, block_idx=block_idx):
        return conv_dw_fused_ref(
            xg, dy2r, block_idx, kh_dim=kh_dim, kw_dim=kw_dim, stride=stride,
            dilation=dilation, h_out=h_out, block_size=block_size,
        )
    s_total, g, w_pad, cg = xg.shape
    m2, w_out, c_pad = dy2r.shape
    b = m2 // h_out
    h_pad = s_total // b
    kb = block_idx.shape[0]
    if m2 % h_out or b * h_pad != s_total or c_pad % block_size or (c_pad // block_size) % g:
        raise ValueError(f"conv_dw_fused: xg {tuple(xg.shape)}, dy2r {tuple(dy2r.shape)}")
    p = kh_dim * kw_dim * cg
    nc = kb * block_size
    s, chunk = conv_dw_plan(m2 * w_out, p, kb, block_size, c_pad if c_out is None else c_out)
    out = torch.empty((kh_dim, kw_dim, cg, nc), dtype=torch.float32, device=xg.device)
    partial = torch.empty((s, p, nc) if s > 1 else (0,), dtype=torch.float32, device=xg.device)
    (sh, sw), (dh, dw) = stride, dilation
    _launch(
        "conv_dw_fused", xg.device, xg.data_ptr(), dy2r.data_ptr(), block_idx.data_ptr(),
        partial.data_ptr(), out.data_ptr(), b, h_pad, g, w_pad, cg, h_out, w_out, c_pad,
        c_pad if c_out is None else c_out, kh_dim, kw_dim, sh, sw, dh, dw, kb, block_size,
        s, chunk, int(xg.dtype == torch.bfloat16),
    )
    return out


def conv_dx_fused_ref(
    dy2r, w2k, block_idx, *, b, hw, padding, groups, stride, dilation,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Plain version: per group and tap, one fp32 einsum of the kept
    cotangent channels with the compact filter, added into a strided
    slice of the padded image; then the interior. Returns ``[B*H, G, W,
    Cg]``."""
    del c_out
    m2, w_out, c_pad = dy2r.shape
    kh_dim, kw_dim, cg, _ = w2k.shape
    h_out = m2 // b
    (h, w), ((ph0, ph1), (pw0, pw1)) = hw, padding
    h_pad, w_pad = h + ph0 + ph1, w + pw0 + pw1
    (sh, sw), (dh, dw) = stride, dilation
    dyk = dy2r.reshape(b, h_out, w_out, c_pad).index_select(
        3, _expand(block_idx, block_size)).float()
    grp = _col_groups(block_idx, c_pad, groups, block_size)
    out = torch.zeros((b, h_pad, groups, w_pad, cg), dtype=torch.float32, device=dy2r.device)
    for gi in range(groups):
        dyg = dyk * (grp == gi).float()
        for kh in range(kh_dim):
            rows = slice(kh * dh, kh * dh + sh * (h_out - 1) + 1, sh)
            for kw in range(kw_dim):
                cols = slice(kw * dw, kw * dw + sw * (w_out - 1) + 1, sw)
                out[:, rows, gi, cols, :] += torch.einsum(
                    "bhwn,cn->bhwc", dyg, w2k[kh, kw].float()
                )
    return out[:, ph0:ph0 + h, :, pw0:pw0 + w].reshape(b * h, groups, w, cg)


def conv_dx_fused(
    dy2r, w2k, block_idx, *, b, hw, padding, groups, stride, dilation,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Conv dX on the interior image from the compact filter ``w2k [Kh,
    Kw, Cg, KB*block_size]`` (kept blocks only, sorted by block). ``hw``
    is the input's (H, W), ``padding`` its ``((lo, hi), (lo, hi))``.
    Returns ``dx [B*H, G, W, Cg]`` fp32; the padding ring is never
    computed. Pass ``arange(NB)`` and the full filter for the dense side
    of a mixed policy. ``c_out`` (the real channel count, default
    ``C_pad``) lets the kernel stop at the ragged tail's real channels."""
    if not _on_cuda("conv_dx_fused", dy2r, w2k, block_idx=block_idx):
        return conv_dx_fused_ref(
            dy2r, w2k, block_idx, b=b, hw=hw, padding=padding, groups=groups,
            stride=stride, dilation=dilation, block_size=block_size,
        )
    m2, w_out, c_pad = dy2r.shape
    kh_dim, kw_dim, cg, kbbs = w2k.shape
    kb = block_idx.shape[0]
    if m2 % b or kbbs != kb * block_size or c_pad % block_size or (c_pad // block_size) % groups:
        raise ValueError(
            f"conv_dx_fused: dy2r {tuple(dy2r.shape)}, w2k {tuple(w2k.shape)}, KB {kb}"
        )
    (h, w), ((ph0, _), (pw0, _)) = hw, padding
    out = torch.empty((b * h, groups, w, cg), dtype=torch.float32, device=dy2r.device)
    (sh, sw), (dh, dw) = stride, dilation
    _launch(
        "conv_dx_fused", dy2r.device, dy2r.data_ptr(), w2k.data_ptr(), block_idx.data_ptr(),
        out.data_ptr(), b, h, w, ph0, pw0, groups, cg, m2 // b, w_out, c_pad,
        c_pad if c_out is None else c_out, kh_dim, kw_dim, sh, sw, dh, dw, kb, block_size,
        int(dy2r.dtype == torch.bfloat16),
    )
    return out


# ----------------------------------------------------------------------
# A[M, K] @ B[K, N] in fp32
# ----------------------------------------------------------------------


def matmul_ref(a, b) -> torch.Tensor:
    """Plain version: both operands widened to fp32, one product."""
    return a.float() @ b.float()


def matmul_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(S, chunk) of the bf16 kernel's deterministic split-K: split s sums
    K in ``[s*chunk, min(k, (s+1)*chunk))``. Splits only while the output
    tiles times S fit on the 132 SMs (one block each), each split at least
    two 64-deep stages; chunks are whole stages."""
    tiles = _cdiv(m, _MM_TILE) * _cdiv(n, _MM_TILE)
    s = max(1, min(_SMS // max(tiles, 1), _cdiv(k, 2 * _MM_BK)))
    chunk = max(1, _cdiv(_cdiv(k, s), _MM_BK)) * _MM_BK
    return max(1, _cdiv(k, chunk)), chunk


def gather_columns(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t.index_select(-1, idx)`` for a row-major ``t``, as a view whose
    row pitch is a multiple of 8 elements, as TMA wants: ``idx`` padded
    with repeats of its last entry, the padding sliced off. The padding
    columns lie past the view's width, so no kernel reads them."""
    k = idx.numel()
    pad = (-k) % _PITCH
    if pad and k:
        idx = torch.cat([idx, idx[-1:].expand(pad)])
    return t.index_select(-1, idx)[..., :k]


def _tma_operand(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """``t`` and the strides the kernel reads it with. TMA reads a 2-D view
    in place when it lies 16-byte aligned with one unit stride and the
    other a multiple of 8 elements, at least the row length; any other
    view is copied, counted in :data:`repacks`, into a row-major buffer
    whose pitch is rounded up to 8."""
    (r, c), (s0, s1) = t.shape, t.stride()
    if t.data_ptr() % 16 == 0:
        if s1 == 1 and s0 % _PITCH == 0 and s0 >= c:
            return t, (s0, 1)
        if s0 == 1 and s1 % _PITCH == 0 and s1 >= r:
            return t, (1, s1)
    buf = torch.empty((r, c + (-c) % _PITCH), dtype=t.dtype, device=t.device)
    buf[:, :c] = t
    repacks["matmul"] += 1
    return buf[:, :c], (buf.shape[1], 1)


def matmul(a, b) -> torch.Tensor:
    """A[M, K] @ B[K, N] -> [M, N] fp32. The operands may be any strided
    2-D views (a transpose is read in place); both fp32 or both bf16.
    bf16 views that TMA cannot read (a row pitch that is not a multiple
    of 8 elements, no unit stride) are copied first and counted in
    :data:`repacks`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: a {tuple(a.shape)} and b {tuple(b.shape)}")
    if not _on_cuda("matmul", a, b, contiguous=False):
        return matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if not (m and n and k):  # nothing to multiply (and no tensor map of an empty axis)
        return out.zero_()
    s, chunk, partial = 1, 0, out
    bf16 = a.dtype == torch.bfloat16
    if bf16:
        a, sa = _tma_operand(a)
        b, sb = _tma_operand(b)
        strides = (*sa, *sb)
        s, chunk = matmul_plan(m, n, k)
        if s > 1:
            partial = torch.empty((s, m, n), dtype=torch.float32, device=a.device)
    else:
        strides = (*a.stride(), *b.stride())
    _launch(
        "matmul", a.device, a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
        m, n, k, *strides, s, chunk, int(bf16),
    )
    return out


# ----------------------------------------------------------------------
# imp[N] = mean_M |dY|
# ----------------------------------------------------------------------

_IMP_COLS = 32  # channels an importance block takes (importance.cu)
_IMP_MIN_ROWS = 64  # the least row chunk a block takes


def importance_ref(dy) -> torch.Tensor:
    """Plain version: mean of |dy| over rows, in fp32. dy [M, N] -> [N]."""
    return dy.abs().float().mean(0)


def importance(dy) -> torch.Tensor:
    """Per-channel importance ``mean_M |dy|`` of dy [M, N] (contiguous,
    fp32 or bf16) -> [N] fp32, divided by the true M."""
    if dy.dim() != 2:
        raise ValueError(f"importance: dy {tuple(dy.shape)} is not [M, N]")
    if not _on_cuda("importance", dy):
        return importance_ref(dy)
    m, n = dy.shape
    # rows cut into S chunks when the channels alone give too few blocks
    s = max(1, min(_cdiv(m, _IMP_MIN_ROWS), _cdiv(_TARGET_BLOCKS // 2, _cdiv(n, _IMP_COLS))))
    chunk = _cdiv(m, s)
    s = _cdiv(m, chunk)
    out = torch.empty((n,), dtype=torch.float32, device=dy.device)
    partial = torch.empty((s, n) if s > 1 else (0,), dtype=torch.float32, device=dy.device)
    _launch(
        "importance", dy.device, dy.data_ptr(), partial.data_ptr(), out.data_ptr(), m, n, s,
        chunk, int(dy.dtype == torch.bfloat16),
    )
    return out
