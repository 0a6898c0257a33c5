"""Channel importance and top-k gradient selection (paper Fig. 1(a)).

The twin of ``repro.core.sparsity``. Given an output gradient ``dY``,
the importance of an output channel is the mean of ``|dY|`` over every
other axis (in fp32); the top-K channels (or contiguous blocks of
``block_size`` channels) keep their gradients. Returned indices are
**sorted ascending**, as in the JAX package.

``n_shards > 1`` selects a balanced top-k within each of that many
contiguous equal channel groups: the form of TP-local selection
(``tp_shards``) and of grouped convs, whose gathered contraction stays
well-formed only when every group keeps the same number of channels.
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
    gathered kernels take. A sharded selection fills it too whenever each
    shard's channel count and kept width are multiples of the policy's
    block size (the shard-local blocks then tile whole global blocks).
    ``shard_idx [n_shards, k_loc]`` carries the per-shard form
    (within-shard indices) of a sharded selection; ``n_shards`` and
    ``k_loc`` read its shape (1 and 0 unsharded, as the JAX package's
    fields default).
    """

    idx: torch.Tensor
    k: int
    valid: torch.Tensor | None = None
    block_idx: torch.Tensor | None = None
    shard_idx: torch.Tensor | None = None

    @property
    def n_shards(self) -> int:
        return 1 if self.shard_idx is None else self.shard_idx.shape[0]

    @property
    def k_loc(self) -> int:
        return 0 if self.shard_idx is None else self.shard_idx.shape[1]


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
    """Policy-driven selection in its full structured form.

    ``n_shards > 1`` partitions the channel axis into that many
    contiguous equal groups and selects a balanced top-k within each
    (:func:`select_indices_per_shard`); ``idx`` is then the sorted global
    indices of all shards' kept channels."""
    axis = channel_axis % dy.dim()
    c = dy.shape[axis]
    if n_shards > 1:
        imp = channel_importance(torch.movedim(dy, axis, -1).reshape(-1, c), -1)
    else:
        imp = channel_importance(dy, channel_axis)
    return select_from_importance(imp, policy, n_shards=n_shards, key=key)


def select_from_importance(
    imp: torch.Tensor,
    policy: SsPropPolicy,
    *,
    n_shards: int = 1,
    key: torch.Tensor | None = None,
) -> Selection:
    """:func:`select`'s decision from the channel importance ``imp [C]``."""
    c = imp.shape[0]
    if n_shards > 1:
        shard_idx, k_loc = _per_shard(imp, policy, n_shards, key=key)
        c_loc = c // n_shards
        offs = torch.arange(n_shards, device=imp.device)[:, None] * c_loc
        flat = torch.sort((shard_idx + offs).reshape(-1)).values
        block_idx = None
        bs = policy.block_size
        if policy.granularity == "block" and c_loc % bs == 0 and k_loc % bs == 0:
            # the shard block was not shrunk: the sorted channel indices
            # regroup into whole kept blocks, the kernels' form
            block_idx = (flat.reshape(-1, bs)[:, 0] // bs).to(torch.int32)
        return Selection(idx=flat, k=n_shards * k_loc, block_idx=block_idx, shard_idx=shard_idx)
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


def select_on_mesh(
    dy: torch.Tensor,
    policy: SsPropPolicy,
    site_mesh,
    *,
    n_shards: int = 1,
    key: torch.Tensor | None = None,
) -> Selection:
    """The one-device run's selection, taken by one rank of a mesh from its
    piece ``dy [M_loc, C_loc]`` of the site's output gradient.

    ``site_mesh`` (``dist/parallel.py::SiteMesh``) averages the importance
    over the data ranks' rows first, so every data rank keeps the same
    channels. A site whose output channels are not split over ``model``
    then selects as one device does (``n_shards`` the op's). A
    column-parallel site (``site_mesh.col``, this rank holding columns
    ``[r*C_loc, (r+1)*C_loc)`` of ``C``):

    * with ``tp_shards`` a multiple ``t * model`` that divides ``C``, the
      shards are the ranks' own: a balanced top-k over the rank's ``t``
      local shards, no collective (``t = 1``: one plain top-k of the
      global per-shard width, which takes the kernel route);
    * otherwise the importance is all-gathered over ``model``, the
      full-width selection taken, and this rank keeps the kept channels in
      its range, shifted to local indices: ``k`` differs from rank to
      rank, possibly 0. Tail phantoms are dropped. ``block_idx`` is kept
      only where the local indices are whole blocks of ``block_size``
      (else the gathered route runs: a block that straddles two ranks is
      no whole block on either).
    """
    c_loc = dy.shape[-1]
    imp = site_mesh.data_mean(channel_importance(dy, -1))
    if not site_mesh.col:
        return select_from_importance(imp, policy, n_shards=n_shards, key=key)
    m, r = site_mesh.model, site_mesh.model_rank
    c, tp, bs = c_loc * m, policy.tp_shards, policy.block_size
    whole = policy.granularity == "block" and c_loc % bs == 0  # the rank's columns tile blocks
    if tp > 1 and c % tp == 0 and tp % m == 0:
        t = tp // m
        shard_idx, k_loc = _per_shard(imp, policy, t, key=key, part=(r * t, tp))
        if t > 1:
            offs = torch.arange(t, device=imp.device)[:, None] * (c_loc // t)
            flat = torch.sort((shard_idx + offs).reshape(-1)).values
            return Selection(idx=flat, k=t * k_loc, shard_idx=shard_idx)
        idx = shard_idx[0]
        block_idx = (idx.reshape(-1, bs)[:, 0] // bs).to(torch.int32) if whole else None
        return Selection(idx=idx, k=k_loc, block_idx=block_idx)
    full = select_from_importance(site_mesh.gather_model(imp), policy,
                                  n_shards=selection_shards(policy, c), key=key)
    idx = full.idx if full.valid is None else full.idx[full.valid]
    lo = r * c_loc
    idx = idx[(idx >= lo) & (idx < lo + c_loc)] - lo
    block_idx = None
    if whole and full.block_idx is not None:
        b, nb = full.block_idx, c_loc // bs
        block_idx = b[(b >= r * nb) & (b < (r + 1) * nb)] - r * nb
    return Selection(idx=idx, k=len(idx), block_idx=block_idx)


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
    # a fill at the indices: ``flat[idx] = True`` stalled the host on the
    # card (an in-place ``index_put_`` of a scalar), once a biased site a step
    flat = torch.zeros((c,), dtype=torch.bool, device=idx.device).index_fill_(0, idx, True)
    shape = [1] * len(dy_shape)
    shape[axis] = c
    return flat.reshape(shape).to(dtype)


def select_indices(
    dy: torch.Tensor,
    policy: SsPropPolicy,
    *,
    channel_axis: int = -1,
    key: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """``(sorted channel indices, K)`` of :func:`select`: block
    granularity gives the kept blocks' channels, tail phantoms clamped to
    ``C-1`` (safe for a keep-mask; gathers use :func:`select`)."""
    sel = select(dy, policy, channel_axis=channel_axis, key=key)
    return sel.idx, sel.k


def selection_shards(policy: SsPropPolicy, c_out: int, groups: int = 1) -> int:
    """How many contiguous channel groups an op's selection balances
    over: the policy's ``tp_shards`` where it divides ``C_out`` (else 1),
    and a conv's ``groups`` where that is not a multiple of them (per-group
    balance is structural for a gathered grouped conv)."""
    s = policy.tp_shards if policy.tp_shards > 1 and c_out % policy.tp_shards == 0 else 1
    if groups > 1 and (s < groups or s % groups != 0):
        s = groups
    return s


def shard_select_width(c: int, policy: SsPropPolicy, n_shards: int) -> tuple[int, int]:
    """``(k_loc, bs_loc)`` of sharded selection over ``C`` channels: the
    channels each shard keeps and the shard-local block size (halved
    until it tiles the shard; 1 at channel granularity). The sizing half
    of :func:`select_indices_per_shard`, which the FLOPs model
    (``core/flops.py``) reads too, so both count the same widths."""
    c_loc = c // n_shards
    if policy.granularity == "block":
        bs = policy.block_size
        while bs > 1 and (c_loc < bs or c_loc % bs):
            bs //= 2
        nblocks_loc = c_loc // bs
        k_total = max(1, int(round((1.0 - policy.drop_rate) * (c // bs))))
        return max(1, min(nblocks_loc, k_total // n_shards)) * bs, bs
    return max(1, policy.keep_count(c) // n_shards), 1


def select_indices_per_shard(
    dy2: torch.Tensor,
    policy: SsPropPolicy,
    tp_shards: int,
    *,
    key: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Top-k within each of ``tp_shards`` contiguous channel groups of
    ``dy2 [M, C]``: ``(idx [tp_shards, k_loc] of within-shard channel
    indices, sorted, k_loc)``.

    As in the JAX package, the block branch takes the top-k of block
    importance whatever ``policy.selection`` says, and channel ``random``
    takes the top-k of ``jax.random.uniform(key, [S, c_loc])`` noise,
    drawn bit for bit by :func:`repro_torch.core.prng.uniform`."""
    c = dy2.shape[1]
    if c % tp_shards:
        raise ValueError(f"{c} channels do not split into {tp_shards} shards")
    return _per_shard(channel_importance(dy2, -1), policy, tp_shards, key=key)


def _per_shard(imp, policy, n, *, key=None, part=None):
    """:func:`select_indices_per_shard` from the importance ``imp [C]`` of
    ``n`` shards. ``part = (first, S)``: these are shards ``first ..
    first+n-1`` of ``S`` (a mesh rank's local shards), sized as ``S``
    shards of the whole, the random branch drawing the whole's noise and
    taking their rows."""
    first, total = part or (0, n)
    c_loc = imp.shape[0] // n
    imp = imp.reshape(n, c_loc)
    k_loc, bs = shard_select_width(c_loc * total, policy, total)
    if policy.granularity == "block":
        bimp = imp.reshape(n, c_loc // bs, bs).mean(-1)
        bidx = torch.sort(torch.topk(bimp, k_loc // bs, dim=-1).indices, dim=-1).values
        offs = torch.arange(bs, device=bidx.device)
        return (bidx[:, :, None] * bs + offs).reshape(n, -1), k_loc
    if policy.selection == "random":
        if key is None:
            raise ValueError("random selection requires key")
        imp = prng.uniform(key.to(imp.device)[None], total * c_loc)[0].reshape(
            total, c_loc)[first:first + n]
    idx = torch.topk(imp, k_loc, dim=-1).indices
    return torch.sort(idx, dim=-1).values, k_loc


def mask_grad(
    dy: torch.Tensor,
    policy: SsPropPolicy,
    *,
    channel_axis: int = -1,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Zero out the dropped channels of ``dy`` (mask-mode sparsification)."""
    if not policy.active:
        return dy
    idx, _ = select_indices(dy, policy, channel_axis=channel_axis, key=key)
    return dy * keep_mask(dy.shape, idx, channel_axis=channel_axis, dtype=dy.dtype)
