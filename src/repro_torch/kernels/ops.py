"""Public wrappers around the hand-written kernels (twin of ``repro.kernels.ops``).

Only ``paged_attention`` is ported so far; the gathered-matmul wrappers
of the sparse backward come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as pa


def paged_attention(q, k_pool, v_pool, block_tables, qpos) -> torch.Tensor:
    """Per-slot causal attention reading K/V pages in place.

    q ``[B,S,H,D]``, pools ``[n_pages, bs, KV, D]``, block_tables
    ``[B, NB]``, qpos ``[B, S]`` -> ``[B, S, H, D]`` in q.dtype. The
    kernel-side contract lives in :mod:`repro_torch.kernels.paged_attention`.
    """
    out = pa.paged_attention(
        q.contiguous(),
        k_pool,
        v_pool,
        block_tables.to(torch.int32).contiguous(),
        qpos.to(torch.int32).contiguous(),
    )
    return out.to(q.dtype)
