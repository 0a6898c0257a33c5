"""Top-k gradient compression with error feedback (the DP collective lever).

The twin of ``repro.optim.compression``, over the port's param trees
(nested dicts and per-layer lists of tensors, :mod:`repro_torch.optim.adam`'s
tree helpers). Each gradient leaf is cut to its top-k magnitude entries
before a data-parallel all-reduce, and what was cut is carried to the
next step in an fp32 residual (error feedback, Stich et al. 2018), so
the update stays unbiased over time. ssProp already zeroes (1-D) of the
dW columns, so the compressor's k lands on what remains.

    cgrads, residual = compress_tree(grads, residual, ratio=0.01)
    # all-reduce cgrads (exact at the kept coordinates, zero elsewhere)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adam import tree_leaves, tree_map


def topk_compress(g: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the ``k`` largest-|.| entries of ``g`` (flattened), zero the
    rest. Entries tied at the k-th magnitude are kept lowest index first,
    as ``jax.lax.top_k`` keeps them (bf16 gradients tie often)."""
    flat = g.reshape(-1)
    k = max(1, min(k, flat.numel()))
    mag = flat.abs()
    kth = torch.topk(mag, k).values[-1]
    above = torch.nonzero(mag > kth)[:, 0]
    tied = torch.nonzero(mag == kth)[: k - above.numel(), 0]
    idx = torch.cat([above, tied])
    return torch.zeros_like(flat).index_copy_(0, idx, flat[idx]).reshape(g.shape)


def compress_tree(
    grads: Any, residual: Any, *, ratio: float = 0.01, min_size: int = 4096
) -> tuple[Any, Any]:
    """Error-feedback top-k over every leaf of at least ``min_size``
    elements: ``(compressed grads, new residual)``. The kept values are
    those of ``g + residual`` in fp32, cast back to the leaf's dtype; the
    new residual is the fp32 remainder. Smaller leaves (norms, biases)
    pass through with a zero residual in their own dtype."""

    def one(g, r):
        if g.numel() < min_size:
            return g, torch.zeros_like(g)
        acc = g.float() + r
        kept = topk_compress(acc, max(1, int(g.numel() * ratio)))
        return kept.to(g.dtype), acc - kept

    pairs = tree_map(one, grads, residual)  # containers come back as dicts and lists
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree, i):
    """Element ``i`` of each ``(kept, residual)`` pair of ``tree``."""
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return [_pick(v, i) for v in tree]


def init_residual(params) -> Any:
    """fp32 zeros shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_bytes(params, ratio: float = 0.01, min_size: int = 4096) -> int:
    """Bytes on the wire after compression: the kept values plus an int32
    index each; a leaf under ``min_size`` goes whole."""
    total = 0
    for p in tree_leaves(params):
        n = p.numel()
        if n < min_size:
            total += n * p.element_size()
        else:
            total += max(1, int(n * ratio)) * (p.element_size() + 4)
    return total
