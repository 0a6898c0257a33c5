"""Partition-spec rules over param, batch and cache trees (the rules, not
the placements).

The twin of ``repro.dist.sharding``. Specs are given
by parameter *name* (the dict keys on a leaf's path; list indices are
skipped, as the JAX package skips ``SequenceKey``) over trees in the JAX
package's layout (``models/model.py::jax_layout``: period-stacked
``[np, ...]`` leaves, the layout the port's checkpoints are written in),
and repaired against a mesh shape (an ordered ``{axis: size}`` mapping,
``launch/mesh.py``) by :func:`fit_spec`, so one rule table covers every
architecture at every mesh size. See ``repro_torch/dist/__init__.py`` for
the table. On a device mesh (``launch/mesh.py::Mesh``) a fitted spec
gives each rank a block of a leaf (:func:`local_index`):
:func:`shard_tree` gives each rank its local shards, and
:func:`gather_tree` the full tensors back by an all-gather of each split
dim.

A tree's leaves are anything with a ``shape`` (tensors, meta tensors,
the checkpoint's ``Stacked``); ``None`` is an empty subtree.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.launch.mesh import axis_sizes, dp_axes, shape_mesh

# attention module names across the decoder / encoder / cross-decoder
_ATTN_KEYS = ("attn", "self", "cross")
# kernels sharded on their LAST dim (output features)
_COL_PARALLEL = ("q", "k", "v", "up", "gate", "in_proj")
# kernels sharded on dim -2 (input features)
_ROW_PARALLEL = ("o", "down", "out_proj")


class Spec(tuple):
    """The twin of ``jax.sharding.PartitionSpec``: one entry a dim, each
    ``None`` (replicated), a mesh axis name, or a tuple of names (the dim
    split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_size(shape, axis) -> int:
    """Size of one spec entry: a mesh axis name or a tuple of them."""
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Repair ``spec`` so every assignment divides its dim on ``mesh`` (a
    ``{axis: size}`` mapping, or anything with such a ``shape``).

    An axis on a dim it does not divide moves to the nearest free
    (``None``) dim that it does divide, the later dim on a tie; with no
    such dim it is dropped (replicated). A spec longer than the shape is
    truncated. A *tuple* of axes whose product does not divide its dim is
    split jointly: the sub-tuple of largest product that divides stays,
    and each remaining axis relocates on its own (the multi-pod
    ``("pod", "data")`` batch split at ``batch < dp_size`` keeps ``pod``
    on the batch and moves ``data`` to the sequence).
    """
    sizes = axis_sizes(mesh)
    entries = list(spec)[: len(shape)] + [None] * (len(shape) - len(spec))

    def relocate_one(i, axis):
        n = _axis_size(sizes, axis)
        cands = [j for j, e in enumerate(entries) if e is None and shape[j] % n == 0]
        if cands:
            best = min(cands, key=lambda j: (abs(j - i), 0 if j > i else 1))
            entries[best] = axis

    for i, axis in enumerate(list(entries)):
        if axis is None:
            continue
        n = _axis_size(sizes, axis)
        if n <= 1 or shape[i] % n == 0:
            continue
        entries[i] = None
        if isinstance(axis, tuple) and len(axis) > 1:
            best_sub, best_n = (), 1
            for mask in range(1, 1 << len(axis)):
                sub = tuple(a for k, a in enumerate(axis) if mask & (1 << k))
                sn = _axis_size(sizes, sub)
                if shape[i] % sn == 0 and sn > best_n:
                    best_sub, best_n = sub, sn
            if best_sub:
                entries[i] = best_sub if len(best_sub) > 1 else best_sub[0]
            for a in axis:
                if a not in best_sub:
                    relocate_one(i, a)
        else:
            relocate_one(i, axis)
    return Spec(*entries)


def _map_with_keys(fn, tree, keys=()):
    """``fn(dict keys on the path, leaf)`` over a tree of dicts, lists and
    tuples (list indices are not keys; ``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, (*keys, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_keys(fn, v, keys) for v in tree]
    return None if tree is None else fn(keys, tree)


def _rule_for(keys: Sequence[str], ndim: int) -> Spec:
    """Mesh-independent spec of one named parameter leaf."""
    none = [None] * ndim
    if "embed" in keys and keys[-1] == "table":
        # [V, d]: vocab-sharded embedding and tied unembedding
        return Spec("model", *none[1:])
    if keys and keys[-1] == "w" and "router" not in keys:
        name = keys[-2] if len(keys) >= 2 else ""
        if name in _COL_PARALLEL and ndim >= 2:
            return Spec(*none[:-1], "model")
        if name in _ROW_PARALLEL and ndim >= 2:
            return Spec(*none[:-2], "model", None)
    if "moe" in keys and keys[-1] in ("gate", "up", "down") and ndim >= 3:
        # stacked experts [np, E, d, ff] / [np, E, ff, d]: expert-parallel
        sp = list(none)
        sp[1] = "model"
        return Spec(*sp)
    # norms, biases, router, the ssm's conv/A/dt/D: replicated
    return Spec(*none)


def param_specs(params: Any, *, replicate_kv: bool = False) -> Any:
    """A tree of :class:`Spec` like ``params`` (JAX layout), unrepaired.

    ``replicate_kv=True`` replicates the k/v projection kernels: serving
    configs have fewer kv-heads than the TP degree, and replicated kv
    saves resharding the score tensor every layer."""

    def one(keys, leaf):
        sp = _rule_for(keys, len(leaf.shape))
        if (replicate_kv and any(k in _ATTN_KEYS for k in keys) and len(keys) >= 2
                and keys[-2] in ("k", "v")):
            return Spec(*([None] * len(sp)))
        return sp

    return _map_with_keys(one, params)


def param_shardings(mesh, params: Any, *, replicate_kv: bool = False) -> Any:
    """The specs of ``params`` (JAX layout) fitted to ``mesh``: the rule
    table's, repaired by :func:`fit_spec` leaf by leaf (the reference's
    ``NamedSharding`` tree, as specs)."""
    return map_specs(lambda leaf, sp: fit_spec(sp, leaf.shape, mesh), params,
                     param_specs(params, replicate_kv=replicate_kv))


def opt_state_shardings(mesh, params: Any) -> Any:
    """Adam's moments mirror the params' layout (same shapes, fp32; k/v
    never replicated, as the reference's)."""
    return param_shardings(mesh, params)


def _batch_axis(mesh):
    dpax = dp_axes(mesh)
    if not dpax:
        return None
    return dpax if len(dpax) > 1 else dpax[0]


def replicated() -> Spec:
    return Spec()


def batch_specs(mesh, batch: Any) -> Any:
    """Inputs: the leading (batch) dim over the data-parallel axes."""
    baxis = _batch_axis(mesh)

    def one(_, a):
        ndim = len(a.shape)
        if not ndim:
            return replicated()
        return fit_spec(Spec(baxis, *([None] * (ndim - 1))), a.shape, mesh)

    return _map_with_keys(one, batch)


def cache_specs(mesh, cache: Any, *, seq_shard: bool = False, paged: bool = False) -> Any:
    """Decode caches (period-stacked ``[np, B, ...]`` leaves): batch over
    dp; attention k/v ``[np, B, T, KV, hd]`` put ``model`` on the kv-head
    dim, or on the seq dim with ``seq_shard``; SSM states ``[np, B, H, N,
    P]`` shard the head dim, conv buffers their channel dim.

    ``paged=True`` declares the paged layout: k/v leaves are a page pool
    ``[np, n_blocks, bs, KV, hd]`` whose page axis is replicated (block
    tables index the pool globally); ``model`` stays on the kv-head dim
    (``seq_shard`` moves it to the within-page dim). SSM and conv leaves
    stay slot-major and shard as in the contiguous layout."""
    baxis = _batch_axis(mesh)

    def one(keys, a):
        ndim = len(a.shape)
        entries = [None] * ndim
        name = keys[-1] if keys else ""
        kv_leaf = name in ("k", "v") and ndim >= 5
        if ndim >= 2 and not (paged and kv_leaf):
            entries[1] = baxis
        if kv_leaf:
            entries[2 if seq_shard else 3] = "model"
        elif name == "state" and ndim >= 3:
            entries[2] = "model"
        elif name == "conv" and ndim >= 3:
            entries[-1] = "model"
        return fit_spec(Spec(*entries), a.shape, mesh)

    return _map_with_keys(one, cache)


def swap_specs(mesh, swapped: Any) -> Any:
    """One slot's swapped-out cache bundle (the slot dim removed), laid out
    like the pool it is scattered back into: k/v page bundles ``[np,
    n_pages, bs, KV, hd]`` with ``model`` on the kv-head dim, SSM state
    rows ``[np, H, N, P]`` on the head dim, conv rows ``[np, K-1, C]`` on
    the channel dim; anything else replicated."""

    def one(keys, a):
        ndim = len(a.shape)
        entries = [None] * ndim
        name = keys[-1] if keys else ""
        if name in ("k", "v") and ndim >= 5:
            entries[3] = "model"
        elif name == "state" and ndim >= 2:
            entries[1] = "model"
        elif name == "conv" and ndim >= 2:
            entries[-1] = "model"
        return fit_spec(Spec(*entries), a.shape, mesh)

    return _map_with_keys(one, swapped)


def block_table_spec() -> Spec:
    """Block tables are small int32 host state, replicated everywhere
    (every shard of the pool needs the whole logical-to-physical map)."""
    return replicated()


# ----------------------------------------------------------------------
# placements on a device mesh
# ----------------------------------------------------------------------


def local_index(spec: Sequence, shape: Sequence[int], mesh) -> tuple[slice, ...]:
    """The slice of a ``shape`` tensor that ``mesh``'s rank holds under the
    fitted ``spec``: the rank's block of each dim an axis splits."""
    sizes = axis_sizes(mesh)
    idx = []
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        if e is None:
            idx.append(slice(None))
            continue
        nblk, blk = 1, 0
        for a in e if isinstance(e, tuple) else (e,):
            nblk *= sizes[a]
            blk = blk * sizes[a] + mesh.coord(a)
        per = d // nblk
        idx.append(slice(blk * per, (blk + 1) * per))
    return tuple(idx)


def block_sources(spec: Sequence, shape: Sequence[int], mesh_shape, index):
    """Which ranks of a mesh of ``mesh_shape`` hold the block ``index``
    (per-dim ``(start, stop)``) of a ``shape`` leaf under the fitted
    ``spec``: ``[(rank, box, origin)]``, ``box`` the part of ``index`` the
    rank holds and ``origin`` where the rank's own block starts, each part
    from the lowest of the ranks that hold it (a block replicated over an
    axis is read once)."""
    sizes = axis_sizes(mesh_shape)
    world = 1
    for n in sizes.values():
        world *= n
    out, seen = [], set()
    for r in range(world):
        blk = local_index(spec, shape, shape_mesh(sizes, r))
        held = tuple((sl.start or 0, d if sl.stop is None else sl.stop)
                     for sl, d in zip(blk, shape, strict=True))
        if held in seen:
            continue
        seen.add(held)
        box = tuple((max(a, c), min(b, e)) for (a, b), (c, e) in zip(held, index, strict=True))
        if all(lo < hi for lo, hi in box):
            out.append((r, box, tuple(a for a, _ in held)))
    return out


def is_split(spec: Sequence, axis: str = "model") -> bool:
    """Does the fitted ``spec`` split a dim over ``axis``?"""
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in spec)


def shard_tree(tree: Any, specs: Any, mesh, *, consume: bool = False) -> Any:
    """Each leaf's local shard on this rank (a fresh contiguous tensor):
    the :func:`local_index` block of the rank's own copy of the full
    leaf, so nothing moves between ranks. ``consume`` drops each full
    leaf from ``tree`` (set to ``None``) once its shard is taken, so that
    the full tree and its shards are not held at once."""

    def one(leaf, spec):
        return leaf[local_index(spec, leaf.shape, mesh)].clone(
            memory_format=torch.contiguous_format)

    if not consume:
        return map_specs(one, tree, specs)
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    out = {} if isinstance(tree, dict) else [None] * len(tree)
    for k in keys:
        v = tree[k]
        if isinstance(v, (dict, list)):
            out[k] = shard_tree(v, specs[k], mesh, consume=True)
        elif v is not None:
            out[k] = one(v, specs[k])
        tree[k] = v = None
    return out


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The full tensors of a tree of local shards, on every rank: an
    all-gather of each split dim over its axes, the inner axis of a
    combined entry first."""
    from repro_torch.dist import parallel

    groups = {"data": (mesh.data_group, mesh.data), "model": (mesh.model_group, mesh.model)}

    def one(loc, spec):
        out = loc
        for i, e in enumerate(spec):
            for axis in reversed(e if isinstance(e, tuple) else (e,) if e else ()):
                group, n = groups[axis]
                if n > 1:
                    out = parallel.all_gather(out, group, n, dim=i)
        return out

    return map_specs(one, tree, specs)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts and lists) and a tree of
    :class:`Spec` of the same structure; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs, strict=True)]
    return None if tree is None else fn(tree, specs)
