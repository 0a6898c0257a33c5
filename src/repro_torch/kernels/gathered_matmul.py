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
  * ``conv_dx_fused``: conv dX on the padded image ``[B·H_pad, G, W_pad,
    Cg]`` with the col2im scatter done as a gather
  * ``matmul``       : A[M, K] @ B[K, N] in fp32, operands read through
    their strides (the channel-granularity dense backward's products)
  * ``importance``   : imp[N] = mean_M |dY[M, N]| in fp32

Layouts are the JAX package's (``xg``, ``dy2r``, ``w2k``: see
``kernels/ops.py``). Unlike the TPU kernels these take unpadded
operands: ragged rows, columns and channel tails (channels past ``N``
count as zeros) are masked in the kernel. Every kernel takes fp32 or
bf16 operands (both of one type), int32 ``block_idx``, accumulates in
fp32 and returns fp32.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel, or the wrapper raises.
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

_DTYPES = (torch.float32, torch.bfloat16)
_TARGET_BLOCKS = 8 * 132  # about eight resident blocks on each of the H100's 132 SMs
_MIN_SPLIT_ROWS = 256  # the least reduction length a split-K block takes
_BK = 16  # rows a kernel's panel takes (tile.cuh)
_TILE = 64  # output tile edge (tile.cuh)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "dx_gathered": [_P] * 4 + [_I] * 6 + [_P],
    "dw_gathered": [_P] * 5 + [_I] * 7 + [_I, _P],
    "conv_dw_fused": [_P] * 5 + [_I] * 18 + [_L, _I, _P],
    "conv_dx_fused": [_P] * 4 + [_I] * 17 + [_I, _P],
    "matmul": [_P] * 3 + [_I] * 3 + [_L] * 4 + [_I, _P],
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


def _splits(rows: int, tiles: int) -> tuple[int, int]:
    """(S, chunk) of a deterministic split-K: enough splits that the
    output tiles times S fill the card, none shorter than
    ``_MIN_SPLIT_ROWS`` rows, chunks a whole number of panels."""
    s = max(1, min(_cdiv(rows, _MIN_SPLIT_ROWS), _cdiv(_TARGET_BLOCKS, max(tiles, 1))))
    chunk = _cdiv(_cdiv(rows, s), _BK) * _BK
    return _cdiv(rows, chunk), chunk


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
    tiles = _cdiv(nc, _TILE) * _cdiv(d_in, _TILE)
    s, chunk = _splits(m, tiles)
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
    tiles = _cdiv(p, _TILE) * kb * _cdiv(block_size, _TILE)
    s, chunk = _splits(m2 * w_out, tiles)
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
    dy2r, w2k, block_idx, *, b, h_pad, w_pad, groups, stride, dilation,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Plain version: per group and tap, one fp32 einsum of the kept
    cotangent channels with the compact filter, added into a strided
    slice of the padded image. Returns ``[B*H_pad, G, W_pad, Cg]``."""
    del c_out
    m2, w_out, c_pad = dy2r.shape
    kh_dim, kw_dim, cg, _ = w2k.shape
    h_out = m2 // b
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
    return out.reshape(b * h_pad, groups, w_pad, cg)


def conv_dx_fused(
    dy2r, w2k, block_idx, *, b, h_pad, w_pad, groups, stride, dilation,
    block_size: int = 128, c_out: int | None = None,
) -> torch.Tensor:
    """Padded-image conv dX from the compact filter ``w2k [Kh, Kw, Cg,
    KB*block_size]`` (kept blocks only, sorted by block). Returns
    ``dxp [B*H_pad, G, W_pad, Cg]`` fp32; the caller slices the padding
    off. Pass ``arange(NB)`` and the full filter for the dense side of a
    mixed policy."""
    if not _on_cuda("conv_dx_fused", dy2r, w2k, block_idx=block_idx):
        return conv_dx_fused_ref(
            dy2r, w2k, block_idx, b=b, h_pad=h_pad, w_pad=w_pad, groups=groups,
            stride=stride, dilation=dilation, block_size=block_size,
        )
    m2, w_out, c_pad = dy2r.shape
    kh_dim, kw_dim, cg, kbbs = w2k.shape
    kb = block_idx.shape[0]
    if m2 % b or kbbs != kb * block_size or c_pad % block_size or (c_pad // block_size) % groups:
        raise ValueError(
            f"conv_dx_fused: dy2r {tuple(dy2r.shape)}, w2k {tuple(w2k.shape)}, KB {kb}"
        )
    out = torch.empty((b * h_pad, groups, w_pad, cg), dtype=torch.float32, device=dy2r.device)
    (sh, sw), (dh, dw) = stride, dilation
    _launch(
        "conv_dx_fused", dy2r.device, dy2r.data_ptr(), w2k.data_ptr(), block_idx.data_ptr(),
        out.data_ptr(), b, h_pad, groups, w_pad, cg, m2 // b, w_out, c_pad,
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


def matmul(a, b) -> torch.Tensor:
    """A[M, K] @ B[K, N] -> [M, N] fp32. The operands may be any strided
    2-D views (a transpose is read in place); both fp32 or both bf16."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: a {tuple(a.shape)} and b {tuple(b.shape)}")
    if not _on_cuda("matmul", a, b, contiguous=False):
        return matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch(
        "matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        *a.stride(), *b.stride(), int(a.dtype == torch.bfloat16),
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
