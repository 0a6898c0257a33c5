"""Paged attention: causal per-slot attention read straight off the page pool.

The twin of ``repro.kernels.paged_attention``. The kernel itself is CUDA
C++ for Hopper (``csrc/paged_attention.cu``, which says how it is laid
out); this module holds its wrapper, the plain PyTorch version
:func:`paged_attention_ref`, and :data:`launches`, the number of times
the wrapper launched the kernel.

Addressing (the same as the TPU kernel): logical block ``j`` of slot
``b`` is physical page ``clip(tables[b, j], 0, n_pages - 1)``; the key
at logical position ``t = j*bs + i`` is visible to query row ``s`` iff
``t <= qpos[b, s]``; query head ``h`` reads KV head ``h // (H // KV)``;
softmax in fp32; the output is fp32 ``[B, S, H, D]``.

Split-KV: the kernel spreads each slot's keys over ``P`` blocks of each
(slot, KV head, row tile), in whole chunks of :func:`chunk_keys` keys; each
writes fp32 partials ``(m, l, acc)`` and a second pass combines them in
split order. :func:`paged_split_plan` picks the row tile and ``P`` from
the shapes alone (the qpos are on the device, and reading them would
stall the host); :func:`paged_split_range` is the kernel's own rule for
the chunks of split ``sp``, which it applies to the keys of each slot,
up to the slot's largest qpos.

Dispatch: a CPU tensor goes to :func:`paged_attention_ref`; a CUDA
tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build

# kernel launches by :func:`paged_attention` (reset by whoever counts)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# head dims of the ported configs: the reduced ones (32), whisper (64),
# kimi-k2 (112), qwen2.5-3b with the other dense and MoE archs (128) and
# paligemma (256)
_HEAD_DIMS = (32, 64, 112, 128, 256)
_CHUNK_VALUES = 4096  # keys a chunk times the tiled head dim (paged_attention.cu)
_SMS = 132  # the H100's streaming multiprocessors
_GRID_TARGET = 2 * _SMS  # blocks a split grid aims at: about two waves
_MMA_ROWS = 64  # the tensor-core variant's row tile (four warps of 16 rows)
_ROW_TILES = (8, 16, _MMA_ROWS)
# paged_attention_launch's C signature: 7 pointers, 13 ints, the scale, the stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
MAX_SPLITS = 1024  # the combine pass stages every split's (m, l) of a row in shared memory
_fn = None  # the loaded entry point, its signature declared


def padded_dim(head_dim: int) -> int:
    """The width the kernel tiles a head dim at: the next power of two
    (112 -> 128). Loads and stores cover the real head dim."""
    return 1 << (head_dim - 1).bit_length()


def chunk_keys(head_dim: int) -> int:
    """Keys in one of the kernel's chunks: 128 at D=32, 64 at D=64, 32 at
    D=112 and 128, 16 at D=256."""
    return _CHUNK_VALUES // padded_dim(head_dim)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts one call: ``row_tile`` query rows (s, g) a
    block, ``row_tiles`` of them per (slot, KV head), ``splits`` blocks
    along each slot's keys, in chunks of ``chunk`` keys."""

    row_tile: int
    row_tiles: int
    splits: int
    chunk: int

    @property
    def variant(self) -> str:
        unit = "mma.sync tf32" if self.row_tile == _MMA_ROWS else "simt fp32"
        return f"{unit}, {self.row_tile}-row tiles, split-KV P={self.splits}"


@functools.lru_cache(maxsize=256)
def paged_split_plan(
    b: int, s: int, h: int, kv: int, d: int, nb: int, bs: int, row_tile: int | None = None
) -> SplitPlan:
    """The row tile and the number of splits for ``q [b, s, h, d]`` over
    a ``[b, nb]`` table of ``bs``-token pages; pure Python on ints.
    ``row_tile`` (8, 16 or 64) overrides the tile the rows would pick.

    Row tiles of 8 rows where a KV head has no more (decode at G = 8),
    of 64 on the tensor cores where it has at least 64 (prefill chunks),
    else 16. Splits only where the (slot, KV head, row tile) blocks fall
    short of one wave of the 132 SMs, and then as many as bring the grid
    to about two waves, at most one a chunk of the table's ``nb * bs``
    keys (the most a slot can see)."""
    rows = s * (h // kv)
    if row_tile is None:
        row_tile = 8 if rows <= 8 else _MMA_ROWS if rows >= _MMA_ROWS else 16
    elif row_tile not in _ROW_TILES:
        raise ValueError(f"row_tile {row_tile}: the kernel is built for {_ROW_TILES}")
    row_tiles = -(-rows // row_tile)
    chunk = chunk_keys(d)
    base = b * kv * row_tiles
    chunks = -(-nb * bs // chunk)
    splits = 1 if base >= _SMS else max(1, min(chunks, _GRID_TARGET // max(base, 1)))
    return SplitPlan(row_tile, row_tiles, splits, chunk)


def paged_split_range(sp: int, splits: int, n_keys: int, chunk: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` of split ``sp`` of a slot that sees ``n_keys``
    keys (its largest qpos plus one, clipped to the table): its chunks are
    ``[sp*C // P, (sp+1)*C // P)`` of the slot's ``C`` chunks, so the
    splits tile the keys in whole chunks, their sizes differ by at most
    one chunk, and one is empty only where the slot has fewer chunks than
    splits. The kernel computes the same range."""
    n_chunks = -(-n_keys // chunk)
    lo = sp * n_chunks // splits * chunk
    hi = min((sp + 1) * n_chunks // splits * chunk, n_keys)
    return lo, max(lo, hi)


def paged_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    qpos: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather through the clipped table, repeat K/V over
    the query-head groups, masked fp32 softmax with masked scores at
    -1e30, as in the JAX package. Returns fp32 ``[B,S,H,D]``.

    This is also the gather route of
    :func:`repro_torch.models.layers.attn_apply`: the port has one plain
    paged attention."""
    b, s, h, d = q.shape
    n_pages, bs_pg, kv, _ = k_pool.shape
    nb = block_tables.shape[1]
    tables = block_tables.long().clamp(0, n_pages - 1)
    g = h // kv
    kk = k_pool[tables].reshape(b, nb * bs_pg, kv, d).float().repeat_interleave(g, dim=2)
    vv = v_pool[tables].reshape(b, nb * bs_pg, kv, d).float().repeat_interleave(g, dim=2)
    t = torch.arange(nb * bs_pg, device=q.device)
    mask = t[None, None, :] <= qpos.long()[:, :, None]  # [B, S, T]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~mask[:, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vv)


def _check(q, k_pool, v_pool, block_tables, qpos):
    b, s, h, d = q.shape
    n_pages, bs_pg, kv, d2 = k_pool.shape
    if d != d2 or h % kv or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if block_tables.shape[0] != b or tuple(qpos.shape) != (b, s):
        raise ValueError(f"shapes: tables {tuple(block_tables.shape)}, qpos {tuple(qpos.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel is built for {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"dtypes q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}: the kernel "
            "takes q and pools in float32 or bfloat16"
        )
    if block_tables.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError("block_tables and qpos must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("qpos", qpos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    qpos: torch.Tensor,
    *,
    splits: int | None = None,
    row_tile: int | None = None,
) -> torch.Tensor:
    """Causal per-slot attention straight off the page pool.

    q ``[B,S,H,D]``; pools ``[n_pages, bs, KV, D]`` after this step's
    tokens were written; block_tables ``[B, NB]`` and qpos ``[B, S]``
    int32. Returns fp32 ``[B, S, H, D]``. ``splits`` and ``row_tile``
    override the plan's (knobs for tests and measurements; the output is
    the same up to the summation order).
    """
    global launches, _fn
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, qpos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_pool, v_pool, block_tables, qpos)
    b, s, h, d = q.shape
    n_pages, bs_pg, kv, _ = k_pool.shape
    nb = block_tables.shape[1]
    plan = paged_split_plan(b, s, h, kv, d, nb, bs_pg, row_tile)
    p = plan.splits if splits is None else splits
    if not 1 <= p <= MAX_SPLITS:
        raise ValueError(f"splits must be 1 to {MAX_SPLITS}, got {p}")
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    # each split's partials of each row: acc[d], then m and l, at a 16-byte pitch
    part = torch.empty((p, b * s * h, d + 4) if p > 1 else (0,), dtype=torch.float32,
                       device=q.device)
    if _fn is None:
        _fn = build.load("paged_attention").paged_attention_launch
        _fn.argtypes = _ARGTYPES
        _fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(), part.data_ptr(),
            b, s, h, kv, d, n_pages, bs_pg, nb, plan.row_tile, plan.chunk, p,
            int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
