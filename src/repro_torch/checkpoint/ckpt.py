"""Checkpointing: the JAX package's msgpack tensor store, async save,
restart discovery, per-host sharded checkpoints with partial-read restore.

The twin of ``repro.checkpoint.ckpt``, in its format: a checkpoint one
package writes, the other restores, bit for bit.

Layout: ``<dir>/step_<N>/{manifest.json, shard_<r>.msgpack}``. A leaf is
stored under its ``jax.tree_util.keystr`` path (dict keys sorted, as JAX
flattens) as ``{"dtype", "shape", "data"}`` with numpy's dtype name
(``"bfloat16"`` for bf16, read and written through a byte view of a
``torch.bfloat16`` tensor: neither package needs numpy's bf16 here). A
``COMMITTED`` marker file makes partially-written checkpoints invisible
to restart discovery (crash-safe). The msgpack is the port's own
(:mod:`repro_torch.checkpoint.codec`): a tensor's bytes go from host
memory straight to the file.

:class:`AsyncCheckpointer` copies the tree to host memory synchronously
(pinned buffers for device tensors; the copy has landed when ``save``
returns, so a train step that then updates the params in place cannot
change what is written) and writes on a daemon thread. A leaf may be a
:class:`Stacked` list of equal-shape tensors: it is stored as their
stack, filled a part at a time into its host buffer, never stacked on
the device (the port keeps a list of per-layer params where the JAX
package stacks them).

**Per-host sharding.** In a multi-process run each rank writes its own
``shard_<r>.msgpack`` covering only the pieces :func:`make_shard_plan`
gives it (FSDP-style balanced slices). A single ``manifest.json``
(written by the leader) records key -> piece -> shard placement plus
global dtype/shape; ``COMMITTED`` is written only after every shard
named in the manifest is on disk and holds the pieces the manifest
gives it, so a writer killed mid-save leaves a torn step that restart
discovery skips.

**Partial-read restore.** :func:`restore` reads the manifest and loads
only the shard files containing pieces of the keys in ``like`` (mapped,
so only the pages of those pieces are read), assembles each tensor in
index space on the host and lands it on ``device``. A shard file
required by the request but missing on disk is a hard, actionable error.
On a device mesh the training driver restores the full leaves and each
rank keeps its placement's slices (``dist/sharding.py::shard_tree``).

**Mesh-shaped plans.** :func:`plan_from_specs` gives each host the
pieces its devices would hold on a mesh of a given shape under given
partition specs (``dist/sharding.py``), so ``save_sharded(plan=...)``
writes a checkpoint laid out as that mesh's per-host shards, as the JAX
package's ``Array.addressable_shards`` does. On a device mesh each rank
is one host of one device: :class:`AsyncCheckpointer` given a ``plan``
over the mesh's ranks writes each rank's pieces from its local shards
(:func:`write_local_shard`), and rank 0 commits the manifest, so the
checkpoint is the JAX package's sharded format. A fleet whose ranks each
run a mesh writes the fleet's format (a plan over the fleet ranks), each
fleet rank's pieces fetched from its mesh ranks' shards.
"""
from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import json
import mmap
import os
import shutil
import threading
import time
from typing import Any
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import codec

_COMMIT = "COMMITTED"

_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of ``dtype``, as the JAX package records it."""
    return _NAMES[dtype]


class Stacked:
    """A leaf stored as ``torch.stack(parts)``, made on the host only: the
    snapshot copies each part into its slice of one host buffer."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)
        first = self.parts[0]
        if any(p.shape != first.shape or p.dtype != first.dtype for p in self.parts):
            raise ValueError("Stacked parts differ in shape or dtype")
        self.shape = torch.Size((len(self.parts), *first.shape))
        self.dtype = first.dtype
        self.device = first.device


def _flatten(tree) -> tuple[list[tuple[str, Any]], Any]:
    """``[(keystr path, leaf)]`` in JAX's flattening order (dict keys
    sorted, sequences in order; ``None`` is an empty subtree), and the
    tree itself as the structure :func:`_unflatten` refills."""
    items: list[tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif node is not None:
            items.append((path, node))

    walk(tree, "")
    return items, tree


def leaf_items(tree) -> list[tuple[str, Any]]:
    """``[(keystr path, leaf)]`` of a tree, in the order a checkpoint
    stores its keys (the order :func:`plan_from_specs` reads its specs in)."""
    return _flatten(tree)[0]


def _unflatten(like, leaves: Sequence[Any]):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it) if node is not None else None

    return build(like)


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous host tensor as a numpy ``uint8``
    array sharing its memory (bf16 through its byte view, not numpy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _encode(t: torch.Tensor) -> dict[str, Any]:
    return {
        "dtype": dtype_name(t.dtype),
        "shape": list(t.shape),
        "data": memoryview(_byte_view(t)),
    }


def _decode(obj, out: torch.Tensor | None = None) -> torch.Tensor:
    """A fresh host tensor (or ``out``, filled) from an encoded leaf."""
    dtype, shape = _DTYPES[obj["dtype"]], tuple(obj["shape"])
    t = torch.empty(shape, dtype=dtype) if out is None else out
    dst = _byte_view(t)
    src = np.frombuffer(obj["data"], dtype=np.uint8)
    if src.size != dst.size:
        raise ValueError(f"{obj['dtype']}{list(shape)}: {src.size} bytes stored, {dst.size} "
                         "expected")
    dst[...] = src
    return t


def _snapshot(items, stats: dict | None = None) -> list[tuple[str, torch.Tensor]]:
    """Host copies of every leaf: device tensors into pinned buffers
    (non-blocking, one synchronize at the end), host tensors cloned,
    :class:`Stacked` leaves a part at a time into their stacked buffer.
    Every buffer is allocated before the first copy; given ``stats``, its
    ``alloc_s`` and ``copy_s`` get the seconds of each."""
    t0 = time.perf_counter()
    leaves = [v if isinstance(v, Stacked) else torch.as_tensor(v) for _, v in items]
    on_dev = [v.device.type != "cpu" for v in leaves]
    host = [torch.empty(tuple(v.shape), dtype=v.dtype, pin_memory=d)
            for v, d in zip(leaves, on_dev, strict=True)]
    t1 = time.perf_counter()
    for v, dst, d in zip(leaves, host, on_dev, strict=True):
        if isinstance(v, Stacked):
            for i, p in enumerate(v.parts):
                dst[i].copy_(p.detach(), non_blocking=d)
        else:
            dst.copy_(v.detach(), non_blocking=d)
    if any(on_dev):
        torch.cuda.synchronize()
    if stats is not None:
        stats.update(alloc_s=t1 - t0, copy_s=time.perf_counter() - t1)
    return [(k, t) for (k, _), t in zip(items, host, strict=True)]


def like_of(tree):
    """``tree`` with every leaf a ``meta`` tensor of its shape and dtype:
    a ``like`` for :func:`restore` that holds no data."""
    items, like = _flatten(tree)
    return _unflatten(like, [torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
                             for _, v in items])


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path."""
    items, _ = _flatten(tree)
    return _write(ckpt_dir, step, _snapshot(items), keep)


def _dump_file(path: str, payload) -> None:
    with open(path, "wb") as f:
        codec.dump(payload, f)


def _write(ckpt_dir: str, step: int, host_items, keep: int) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": [k for k, _ in host_items]}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    payload = {k: _encode(v) for k, v in host_items}
    _dump_file(os.path.join(tmp, "shard_0.msgpack"), payload)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(ckpt_dir, keep)
    return path


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write on a daemon thread.

    At most one in-flight save; a new save waits for the previous write
    (bounded memory). ``wait()`` drains before exit/restore.

    **Sharded mode**: construct with ``rank=`` and ``ranks=`` (the
    active fleet) and each rank's checkpointer writes only its own
    ``shard_<r>.msgpack``; the leader (lowest active rank) writes the
    manifest and commits once every peer's shard lands, all on the
    background thread so a slow peer never blocks the train loop. A
    commit that times out (a peer died mid-save) leaves the step torn —
    restart discovery skips it and the fleet falls back to the previous
    committed step. Reassign ``.ranks`` after a membership change; the
    next save's plan spans the new fleet.

    **Mesh mode**: given ``plan`` (``plan_from_specs`` over the mesh's
    ranks) and ``like`` (the full state's tree of ``meta`` tensors), the
    tree a rank saves holds its local shards: each rank writes the pieces
    the plan gives it (:func:`write_local_shard`) and the leader commits
    the manifest of ``like``'s shapes.

    **A mesh under a fleet**: given ``like``, ``mesh`` and ``specs`` (no
    ``plan``), ``rank`` is a fleet rank that runs ``mesh``, and a save's
    plan is :func:`make_shard_plan` over the active fleet ranks applied to
    ``like``'s full shapes: the fleet format a fleet of one-process ranks
    writes. Every mesh rank calls :meth:`save` with its local shards
    (``specs``: the fitted spec of each leaf, in ``like``'s order);
    :func:`gather_pieces` assembles the pieces the plan gives ``rank`` on
    mesh rank 0, whose save writes ``shard_<rank>`` (:func:`write_pieces`)
    while the others' end there, and the leader (the lowest active fleet
    rank's mesh rank 0) commits, as in sharded mode.

    ``last_stats`` holds the last save's step, bytes of tensor data on
    this rank, blocking snapshot seconds (``snapshot_s``: the host
    buffers' allocation ``alloc_s`` and the copies into them ``copy_s``)
    and background write seconds (``write_s``: into the page cache, with
    no fsync, as the JAX package writes; the leader's commit wait
    included).
    """

    def __init__(
        self,
        ckpt_dir: str,
        keep: int = 3,
        *,
        rank: int = 0,
        ranks: Sequence[int] | None = None,
        commit_timeout_s: float = 60.0,
        plan: Plan | None = None,
        like=None,
        mesh=None,
        specs=None,
    ):
        self.ckpt_dir = ckpt_dir
        self.plan = plan
        self.mesh, self.specs = mesh, specs
        self.like_items = None if like is None else _flatten(like)[0]
        self.keep = keep
        self.rank = rank
        self.ranks = list(ranks) if ranks is not None else None
        self.commit_timeout_s = commit_timeout_s
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None
        self.last_error: BaseException | None = None
        self.last_stats: dict[str, float] = {}

    def save(self, step: int, tree: Any):
        t0 = time.perf_counter()
        items, _ = _flatten(tree)
        stats = {"step": step}
        ranks = list(self.ranks) if self.ranks is not None else None
        if self.mesh is not None:
            plan = make_shard_plan(self.like_items, ranks)
            host = gather_pieces(items, self.specs, self.like_items, plan, self.mesh, self.rank)
            stats["snapshot_s"] = time.perf_counter() - t0
            if host is None:  # another mesh rank writes this fleet rank's shard
                self.last_stats = stats | {"bytes": 0}
                return
            nbytes = sum(t.numel() * t.element_size() for _, ps in host for _, t in ps)
        else:
            plan = None
            host = _snapshot(items, stats)
            stats["snapshot_s"] = time.perf_counter() - t0
            nbytes = sum(t.numel() * t.element_size() for _, t in host)
        self.wait()
        self.last_stats = stats | {"bytes": nbytes}
        self._thread = threading.Thread(
            target=self._run, args=(step, host, ranks, plan), daemon=True
        )
        self._thread.start()

    def _run(self, step, host, ranks, fleet_plan):
        t0 = time.perf_counter()
        try:
            if fleet_plan is not None:
                self.last_path = write_pieces(self.ckpt_dir, step, host, rank=self.rank)
                if self.rank == min(ranks):
                    write_sharded_manifest(
                        self.ckpt_dir, step, self.like_items, plan=fleet_plan, ranks=ranks
                    )
                    commit_sharded(
                        self.ckpt_dir, step, timeout_s=self.commit_timeout_s, keep=self.keep
                    )
            elif self.plan is not None:
                self.last_path = write_local_shard(
                    self.ckpt_dir, step, host, rank=self.rank, plan=self.plan
                )
                if self.rank == min(ranks):
                    write_sharded_manifest(
                        self.ckpt_dir, step, self.like_items, plan=self.plan, ranks=ranks
                    )
                    commit_sharded(
                        self.ckpt_dir, step, timeout_s=self.commit_timeout_s, keep=self.keep
                    )
            elif ranks is not None and len(ranks) > 1:
                plan = make_shard_plan(host, ranks)
                self.last_path = write_shard(
                    self.ckpt_dir, step, host, rank=self.rank, plan=plan
                )
                if self.rank == min(ranks):
                    write_sharded_manifest(
                        self.ckpt_dir, step, host, plan=plan, ranks=ranks
                    )
                    commit_sharded(
                        self.ckpt_dir,
                        step,
                        timeout_s=self.commit_timeout_s,
                        keep=self.keep,
                    )
            else:
                self.last_path = _write(self.ckpt_dir, step, host, self.keep)
            self.last_error = None
        except BaseException as e:  # surfaced via .last_error on wait()
            self.last_error = e
        self.last_stats["write_s"] = time.perf_counter() - t0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


Saver = AsyncCheckpointer


def list_steps(ckpt_dir: str) -> list[int]:
    """Committed checkpoint steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            full = os.path.join(ckpt_dir, name)
            if os.path.exists(os.path.join(full, _COMMIT)):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


# ----------------------------------------------------------------------
# per-host shard plans
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Piece:
    """One rank's slice of one tensor: ``index`` is a per-dim
    ``(start, stop)`` tuple covering the full rank of the array."""

    shard: int
    index: tuple[tuple[int, int], ...]

    def slices(self) -> tuple[slice, ...]:
        return tuple(slice(s, e) for s, e in self.index)


Plan = dict[str, list[Piece]]


def _owner(key: str, eligible: Sequence[int]) -> int:
    """Deterministic owner pick (crc32, NOT the salted builtin hash —
    every process must compute the identical plan)."""
    return sorted(eligible)[zlib.crc32(key.encode()) % len(eligible)]


def make_shard_plan(items, ranks: Sequence[int]) -> Plan:
    """FSDP-style balanced ownership: each tensor is sliced along its
    largest ``len(ranks)``-divisible axis, one contiguous slice per
    rank; tensors with no divisible axis are owned whole by a
    deterministic rank (crc32 spread, so small norms/biases balance
    across shards instead of piling onto rank 0).

    ``items`` is ``[(key, leaf)]`` as produced by the flattener (a leaf
    needs only ``.shape``); the plan is a pure function of (keys, shapes,
    ranks), so every rank derives the same plan independently.
    """
    ranks = sorted(ranks)
    n = len(ranks)
    plan: Plan = {}
    for key, leaf in items:
        shape = tuple(int(d) for d in leaf.shape)
        axis = None
        if n > 1 and shape:
            divisible = [i for i, d in enumerate(shape) if d % n == 0 and d > 0]
            if divisible:
                axis = max(divisible, key=lambda i: (shape[i], -i))
        if axis is None:
            full = tuple((0, d) for d in shape)
            plan[key] = [Piece(_owner(key, ranks), full)]
            continue
        per = shape[axis] // n
        pieces = []
        for j, r in enumerate(ranks):
            idx = tuple(
                (j * per, (j + 1) * per) if i == axis else (0, d)
                for i, d in enumerate(shape)
            )
            pieces.append(Piece(r, idx))
        plan[key] = pieces
    return plan


def plan_from_specs(items, specs, mesh_shape: dict[str, int], ranks: Sequence[int]) -> Plan:
    """The pieces each host's devices own on a mesh, without allocating.

    The mesh is ``mesh_shape`` (ordered axis -> size, devices enumerated
    row-major); hosts are ``ranks``, each holding an equal contiguous
    block of devices; each leaf's partition spec (``specs``, aligned
    with ``items``, repaired with ``fit_spec`` against the mesh first)
    says which index block each device holds. A block held by several
    hosts is written by exactly one (a crc32 pick among its holders), so
    the pieces cover every tensor exactly once."""
    from repro_torch.dist.sharding import fit_spec

    ranks = sorted(ranks)
    n_hosts = len(ranks)
    axis_names = list(mesh_shape)
    sizes = [int(mesh_shape[a]) for a in axis_names]
    n_dev = 1
    for s in sizes:
        n_dev *= s
    if n_dev % n_hosts:
        raise ValueError(f"{n_dev} mesh devices not divisible by {n_hosts} hosts")
    per_host = n_dev // n_hosts

    def device_coords(d: int) -> dict[str, int]:
        out = {}
        for name, size in zip(reversed(axis_names), reversed(sizes), strict=True):
            out[name] = d % size
            d //= size
        return out

    plan: Plan = {}
    for (key, leaf), spec in zip(items, specs, strict=True):
        shape = tuple(int(d) for d in leaf.shape)
        spec = fit_spec(spec, shape, mesh_shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        holders: dict[tuple[tuple[int, int], ...], set] = {}  # block -> hosts holding it
        for d in range(n_dev):
            coords = device_coords(d)
            idx = []
            for dim, entry in zip(shape, entries, strict=True):
                if entry is None:
                    idx.append((0, dim))
                    continue
                nblk, blk = 1, 0
                for a in entry if isinstance(entry, tuple) else (entry,):
                    nblk *= mesh_shape[a]
                    blk = blk * mesh_shape[a] + coords[a]
                per = dim // nblk
                idx.append((blk * per, (blk + 1) * per))
            holders.setdefault(tuple(idx), set()).add(ranks[d // per_host])
        plan[key] = [
            Piece(_owner(f"{key}{idx}", sorted(hosts)), idx)
            for idx, hosts in sorted(holders.items())
        ]
    return plan


def validate_plan(plan: Plan, shapes: dict[str, Sequence[int]]) -> None:
    """Assert the plan partitions every key: pieces pairwise disjoint
    and their volumes sum to the full array (⇒ no gap, no overlap)."""
    for key, shape in shapes.items():
        pieces = plan.get(key)
        if not pieces:
            raise AssertionError(f"plan has no pieces for {key}")
        total = 1
        for d in shape:
            total *= int(d)
        vol = 0
        for p in pieces:
            if len(p.index) != len(shape):
                raise AssertionError(f"{key}: piece rank mismatch {p}")
            v = 1
            for (s, e), d in zip(p.index, shape, strict=True):
                if not (0 <= s <= e <= d):
                    raise AssertionError(f"{key}: piece out of bounds {p}")
                v *= e - s
            vol += v
        for i, a in enumerate(pieces):
            for b in pieces[i + 1:]:
                if all(
                    a.index[k][0] < b.index[k][1] and b.index[k][0] < a.index[k][1]
                    for k in range(len(shape))
                ):
                    raise AssertionError(f"{key}: overlapping pieces {a} / {b}")
        if vol != total:
            raise AssertionError(
                f"{key}: pieces cover {vol} of {total} elements (gap)"
            )


# ----------------------------------------------------------------------
# sharded save / commit / restore
# ----------------------------------------------------------------------


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _shard_name(rank: int) -> str:
    return f"shard_{rank}.msgpack"


def _read_file(path: str):
    """The decoded payload of one shard file, its bin values slices of the
    mapped file (only the pages a caller copies out are read). The
    mapping is released with the last slice that refers to it."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return codec.unpackb(mm)


def write_pieces(ckpt_dir: str, step: int, pieces, *, rank: int) -> str:
    """Write ``shard_<rank>`` from its pieces, ``[(key, [(piece, host
    tensor of the piece's block)])]`` (crash-atomic). Returns its path."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    payload = {
        key: [dict(_encode(t.contiguous()), index=[list(se) for se in p.index]) for p, t in own]
        for key, own in pieces if own
    }
    shard_path = os.path.join(path, _shard_name(rank))
    tmp = f"{shard_path}.tmp.{os.getpid()}"
    _dump_file(tmp, payload)
    os.replace(tmp, shard_path)
    return shard_path


def write_shard(ckpt_dir: str, step: int, host_items, *, rank: int, plan: Plan) -> str:
    """Write this rank's pieces (crash-atomic). ``host_items`` must hold
    host tensors. Returns the shard path."""
    return write_pieces(ckpt_dir, step, [
        (key, [(p, arr[p.slices()]) for p in plan.get(key, ()) if p.shard == rank])
        for key, arr in host_items], rank=rank)


def gather_pieces(local_items, specs, full_items, plan: Plan, mesh, shard: int):
    """The pieces ``plan`` gives ``shard`` of a tree whose leaves the ranks
    of ``mesh`` hold as blocks (``local_items``, this rank's; ``specs``,
    each leaf's fitted spec; ``full_items``, the full leaves' shapes), as
    ``[(key, [(piece, host tensor)])]`` on mesh rank 0 and ``None`` on the
    others. Every rank calls it. Each part of a piece comes from the
    lowest rank that holds it (:func:`~repro_torch.dist.sharding.block_sources`):
    rank 0's own parts are copied, the others' sent to it (through the
    host over gloo, on the card over NCCL), into pinned host buffers. A
    rank whose copy fails sends zeros in its place, so that no peer waits
    on it, and then every rank raises."""
    import torch.distributed as dist

    from repro_torch.dist import parallel
    from repro_torch.dist.sharding import block_sources

    lead, on_card = mesh.rank == 0, mesh.backend == "nccl"
    out, err = [], None
    for (key, loc), spec, (_, full) in zip(local_items, specs, full_items, strict=True):
        if isinstance(loc, Stacked):
            loc = torch.stack(loc.parts)
        own = []
        for p in (p for p in plan[key] if p.shard == shard):
            host = None
            if lead and err is None:
                try:
                    host = torch.empty([e - s for s, e in p.index], dtype=loc.dtype,
                                       pin_memory=loc.is_cuda)
                except Exception as e:
                    err = e
            for src, box, origin in block_sources(spec, full.shape, mesh.shape, p.index):
                dims = [b - a for a, b in box]
                if mesh.rank == src:
                    part = loc[tuple(slice(a - o, b - o)
                                     for (a, b), o in zip(box, origin, strict=True))]
                    if src != 0:
                        try:
                            part = part.contiguous() if on_card else part.cpu().contiguous()
                        except Exception as e:
                            err = err or e
                            part = torch.zeros(dims, dtype=loc.dtype,
                                               device=mesh.device if on_card else "cpu")
                        dist.send(part, 0)
                        continue
                elif lead:
                    part = torch.empty(dims, dtype=loc.dtype,
                                       device=mesh.device if on_card else "cpu")
                    dist.recv(part, src)
                else:
                    continue
                if host is not None:
                    host[tuple(slice(a - s, b - s) for (a, b), (s, _) in
                               zip(box, p.index, strict=True))].copy_(part, non_blocking=True)
            own.append((p, host))
        out.append((key, own))
        del loc
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    parallel.raise_any(err, mesh)
    return out if lead else None


def write_local_shard(ckpt_dir: str, step: int, local_items, *, rank: int, plan: Plan) -> str:
    """Write a mesh rank's pieces from its local shards (crash-atomic).
    On a mesh of one device a host, the one piece of a leaf the plan gives
    ``rank`` is the block the rank holds, so its data is the local tensor
    itself (``local_items``: host tensors). Returns the shard path."""
    pieces = []
    for key, loc in local_items:
        own = [p for p in plan.get(key, ()) if p.shard == rank]
        if not own:
            continue
        (piece,) = own
        if tuple(e - s for s, e in piece.index) != tuple(loc.shape):
            raise ValueError(f"{key}: rank {rank} holds {tuple(loc.shape)}, its piece is "
                             f"{piece.index}")
        pieces.append((key, [(piece, loc)]))
    return write_pieces(ckpt_dir, step, pieces, rank=rank)


def write_sharded_manifest(
    ckpt_dir: str, step: int, host_items, *, plan: Plan, ranks: Sequence[int]
) -> str:
    """Leader-side: publish key → piece → shard placement (atomic)."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    keys = {
        key: {
            "dtype": dtype_name(arr.dtype),
            "shape": [int(d) for d in arr.shape],
            "pieces": [
                {"shard": p.shard, "index": [list(se) for se in p.index]}
                for p in plan[key]
            ],
        }
        for key, arr in host_items
    }
    manifest = {
        "step": step,
        "format": "sharded",
        "ranks": sorted(ranks),
        "keys": keys,
    }
    mpath = os.path.join(path, "manifest.json")
    tmp = f"{mpath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)
    return mpath


def _shard_holds(path: str, rank: int, manifest) -> bool:
    """Does ``shard_<rank>`` hold exactly the pieces the manifest gives
    it? A shard left by an earlier save of the same step under another
    fleet (a plan over other ranks) does not, and must not be committed."""
    want = {
        k: sorted(p["index"] for p in meta["pieces"] if p["shard"] == rank)
        for k, meta in manifest["keys"].items()
    }
    want = {k: v for k, v in want.items() if v}
    try:
        got = _read_file(os.path.join(path, _shard_name(rank)))
    except (OSError, ValueError):
        return False
    return set(got) == set(want) and all(
        sorted(e["index"] for e in got[k]) == want[k]
        and all(e["dtype"] == manifest["keys"][k]["dtype"] for e in got[k])
        for k in want
    )


def commit_sharded(
    ckpt_dir: str,
    step: int,
    *,
    timeout_s: float = 60.0,
    poll_s: float = 0.02,
    keep: int = 3,
) -> str:
    """Wait until every shard the manifest names exists and holds the
    pieces the manifest gives it, then write ``COMMITTED``. A peer that
    died mid-save makes this time out and the step stays torn (invisible
    to restart discovery) — that is the crash-atomicity contract, not an
    error to paper over. (The reference waits for the files only, so a
    shard an earlier fleet left for the same step can be committed under
    the new manifest; here it counts as missing until it is rewritten.)"""
    path = _step_dir(ckpt_dir, step)
    mpath = os.path.join(path, "manifest.json")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(mpath):
        if time.monotonic() > deadline:
            raise TimeoutError(f"commit: no manifest at {path}")
        time.sleep(poll_s)
    with open(mpath) as f:
        manifest = json.load(f)
    needed = sorted(
        {p["shard"] for meta in manifest["keys"].values() for p in meta["pieces"]}
    )
    done: set[int] = set()
    while True:
        done |= {r for r in needed if r not in done and _shard_holds(path, r, manifest)}
        missing = [r for r in needed if r not in done]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"commit: step {step} still missing shards from ranks "
                f"{missing} after {timeout_s}s — leaving the step torn"
            )
        time.sleep(poll_s)
    with open(os.path.join(path, _COMMIT), "w") as f:
        f.write("ok")
    _gc(ckpt_dir, keep)
    return path


def save_sharded(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    rank: int,
    ranks: Sequence[int],
    plan: Plan | None = None,
    commit: bool | None = None,
    commit_timeout_s: float = 60.0,
    keep: int = 3,
) -> str:
    """One rank's synchronous sharded save.

    Every rank calls this with the same ``tree``/``ranks``; each writes
    only its own pieces. The leader (lowest rank) also writes the
    manifest and — unless ``commit=False`` — waits for its peers'
    shards and commits. Returns the shard path.
    """
    items, _ = _flatten(tree)
    host = _snapshot(items)
    if plan is None:
        plan = make_shard_plan(host, ranks)
    shard_path = write_shard(ckpt_dir, step, host, rank=rank, plan=plan)
    if rank == min(ranks):
        write_sharded_manifest(ckpt_dir, step, host, plan=plan, ranks=ranks)
        if commit is None or commit:
            commit_sharded(
                ckpt_dir, step, timeout_s=commit_timeout_s, keep=keep
            )
    return shard_path


class MissingShardError(FileNotFoundError):
    """A restore needs a shard file that is not on disk."""


def _restore_sharded(path: str, manifest, items) -> list[torch.Tensor]:
    """Assemble the leaves of ``items`` from a sharded checkpoint,
    reading ONLY the shard files their pieces live in."""
    by_key = manifest["keys"]
    missing_keys = [k for k, _ in items if k not in by_key]
    if missing_keys:
        raise KeyError(
            f"checkpoint {path} has no entry for {missing_keys[:5]} "
            f"(manifest keys look like: {sorted(by_key)[:3]})"
        )
    needed = sorted(
        {p["shard"] for k, _ in items for p in by_key[k]["pieces"]}
    )
    missing = [
        r for r in needed
        if not os.path.exists(os.path.join(path, _shard_name(r)))
    ]
    if missing:
        covered = [
            k for k, _ in items
            if any(p["shard"] in missing for p in by_key[k]["pieces"])
        ]
        raise MissingShardError(
            f"checkpoint {path} is missing "
            f"{[_shard_name(r) for r in missing]} covering "
            f"{len(covered)} requested tensors (e.g. {covered[:3]}); the "
            f"save was torn or the files were lost — restore an earlier "
            f"committed step, or restrict `like` to the keys you need"
        )
    shards = {r: _read_file(os.path.join(path, _shard_name(r))) for r in needed}
    out = []
    for k, _ in items:
        meta = by_key[k]
        arr = torch.empty(tuple(meta["shape"]), dtype=_DTYPES[meta["dtype"]])
        for p in meta["pieces"]:
            stored = next(
                (
                    e
                    for e in shards[p["shard"]].get(k, [])
                    if [list(se) for se in e["index"]] == p["index"]
                ),
                None,
            )
            if stored is None:
                raise MissingShardError(
                    f"{_shard_name(p['shard'])} in {path} has no piece "
                    f"{p['index']} of {k} — shard/manifest mismatch "
                    f"(mixed-up save?); restore an earlier committed step"
                )
            sl = tuple(slice(s, e) for s, e in p["index"])
            if arr[sl].is_contiguous():
                _decode(stored, arr[sl])
            else:
                arr[sl] = _decode(stored)
        out.append(arr)
    return out


def restore(ckpt_dir: str, step: int, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like``, whose leaves give the
    dtypes to cast to (tensors, ``meta`` tensors or :class:`Stacked`);
    the restored leaves are fresh host tensors, moved to ``device`` when
    one is given.

    ``like`` may itself be a *partial* tree (e.g. only ``{"params":
    ...}`` out of a params/m/v checkpoint): only its leaves are
    restored, and on a sharded checkpoint only the shard files covering
    those leaves are read (partial-read restore).
    """
    path = _step_dir(ckpt_dir, step)
    items, like_tree = _flatten(like)
    manifest = None
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        pass  # legacy layout: monolithic shard_0 with no/old manifest
    if manifest is not None and manifest.get("format") == "sharded":
        arrays = _restore_sharded(path, manifest, items)
    else:
        payload = _read_file(os.path.join(path, "shard_0.msgpack"))
        arrays = [_decode(payload[k]) for k, _ in items]
        del payload
    out = []
    for (_, proto), arr in zip(items, arrays, strict=True):
        dtype = getattr(proto, "dtype", None)
        if isinstance(dtype, torch.dtype) and dtype != arr.dtype:
            arr = arr.to(dtype)
        out.append(arr.to(device) if device is not None else arr)
    return _unflatten(like_tree, out)
