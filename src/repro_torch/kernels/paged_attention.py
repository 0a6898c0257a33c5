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

Dispatch: a CPU tensor goes to :func:`paged_attention_ref`; a CUDA
tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

# kernel launches by :func:`paged_attention` (reset by whoever counts)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# head dims of the ported configs: qwen2.5-3b (128) and its reduced twin (32)
_HEAD_DIMS = (32, 128)


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
) -> torch.Tensor:
    """Causal per-slot attention straight off the page pool.

    q ``[B,S,H,D]``; pools ``[n_pages, bs, KV, D]`` after this step's
    tokens were written; block_tables ``[B, NB]`` and qpos ``[B, S]``
    int32. Returns fp32 ``[B, S, H, D]``.
    """
    global launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, qpos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_pool, v_pool, block_tables, qpos)
    b, s, h, d = q.shape
    n_pages, bs_pg, kv, _ = k_pool.shape
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            b, s, h, kv, d, n_pages, bs_pg, block_tables.shape[1],
            int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
