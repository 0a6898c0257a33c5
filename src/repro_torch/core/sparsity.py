"""Channel importance and top-k gradient selection (paper Fig. 1(a)).

The twin of ``repro.core.sparsity``. Given an output gradient ``dY``,
the importance of an output channel is the mean of ``|dY|`` over every
other axis (in fp32); the top-K channels (or contiguous blocks of
``block_size`` channels) keep their gradients. Returned indices are
**sorted ascending**, as in the JAX package.

Only the unsharded selection is ported: ``n_shards > 1`` (per-shard
balanced top-k for ``tp_shards`` and grouped convs) raises.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.policy import SsPropPolicy


class Selection(NamedTuple):
    """One selection decision.

    ``idx`` holds ``k`` channel indices (sorted ascending, clamped into
    ``[0, C)``). With block granularity and a ragged channel tail
    (``C % block_size != 0``) some slots are phantoms, clamped
    duplicates of ``C-1``, and ``valid`` marks the real ones; gathers
    zero the phantom slots and scatters accumulate. ``valid is None``
    means every slot is real. ``block_idx`` holds the kept block indices
    (int32, sorted) when the selection was block-granular: the form the
    gathered kernels take. (The JAX package's per-shard fields belong to
    the sharded selection, which is not ported.)
    """

    idx: torch.Tensor
    k: int
    valid: torch.Tensor | None = None
    block_idx: torch.Tensor | None = None


def channel_importance(dy: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Mean of ``|dy|`` over every axis except ``channel_axis``, in fp32."""
    axis = channel_axis % dy.dim()
    reduce_axes = tuple(a for a in range(dy.dim()) if a != axis)
    return dy.abs().float().mean(dim=reduce_axes)


def block_importance(imp: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block importance: the mean over each block, the ragged tail
    padded with zeros (which only dilute the tail block)."""
    c = imp.shape[0]
    nblocks = -(-c // block_size)
    pad = nblocks * block_size - c
    if pad:
        imp = torch.nn.functional.pad(imp, (0, pad))
    return imp.reshape(nblocks, block_size).mean(dim=1)


def select_topk_channels(
    imp: torch.Tensor,
    k: int,
    *,
    selection: str = "topk",
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Indices of the K most important channels, sorted ascending.

    ``selection="random"`` reproduces the paper's Fig. 2(b) ablation: the
    first K of ``jax.random.permutation(key, C)``, drawn bit for bit by
    :func:`repro_torch.core.prng.permutation` from ``key``, a ``[2]``
    int64 tensor of JAX key data (:func:`repro_torch.core.prng.key`).
    """
    c = imp.shape[0]
    if not 0 < k <= c:
        raise ValueError(f"k={k} out of range for {c} channels")
    if selection == "topk":
        idx = torch.topk(imp, k).indices
    elif selection == "random":
        if key is None:
            raise ValueError("selection='random' requires a PRNG key")
        idx = prng.permutation(key.to(imp.device), c)[:k]
    else:
        raise ValueError(f"bad selection {selection!r}")
    return torch.sort(idx).values


def select_topk_blocks(
    imp: torch.Tensor,
    block_size: int,
    k_blocks: int,
    *,
    selection: str = "topk",
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Indices of the K most important channel *blocks*, sorted ascending."""
    bimp = block_importance(imp, block_size)
    return select_topk_channels(bimp, k_blocks, selection=selection, key=key)


def block_indices_to_channels(block_idx: torch.Tensor, block_size: int) -> torch.Tensor:
    """Expand block indices to the flat channel indices they cover."""
    offs = torch.arange(block_size, device=block_idx.device, dtype=block_idx.dtype)
    return (block_idx[:, None] * block_size + offs[None, :]).reshape(-1)


def select(
    dy: torch.Tensor,
    policy: SsPropPolicy,
    *,
    channel_axis: int = -1,
    n_shards: int = 1,
    key: torch.Tensor | None = None,
) -> Selection:
    """Policy-driven selection in its full structured form."""
    c = dy.shape[channel_axis % dy.dim()]
    if n_shards > 1:
        raise NotImplementedError(
            "sharded selection (tp_shards, grouped convs) is not ported yet"
        )
    imp = channel_importance(dy, channel_axis)
    if policy.granularity == "channel":
        k = policy.keep_count(c)
        idx = select_topk_channels(imp, k, selection=policy.selection, key=key)
        return Selection(idx=idx, k=k)
    k_blocks = policy.keep_count(c)
    bidx = select_topk_blocks(
        imp, policy.block_size, k_blocks, selection=policy.selection, key=key
    )
    raw = block_indices_to_channels(bidx, policy.block_size)
    # Ragged tail: clamp the phantom channels past C-1 into range for
    # gathers, and mark them invalid so the engine zeroes their gathered
    # values and scatters by accumulation.
    valid = raw < c if c % policy.block_size != 0 else None
    idx = torch.clamp(raw, max=c - 1)
    return Selection(
        idx=idx, k=k_blocks * policy.block_size, valid=valid,
        block_idx=bidx.to(torch.int32),
    )


def keep_mask(
    dy_shape: Sequence[int],
    idx: torch.Tensor,
    *,
    channel_axis: int = -1,
    dtype=torch.bool,
) -> torch.Tensor:
    """Mask over the channel axis, True (1) on kept channels, shaped to
    broadcast against ``dy_shape``."""
    axis = channel_axis % len(dy_shape)
    c = dy_shape[axis]
    flat = torch.zeros((c,), dtype=torch.bool, device=idx.device)
    flat[idx] = True
    shape = [1] * len(dy_shape)
    shape[axis] = c
    return flat.reshape(shape).to(dtype)
