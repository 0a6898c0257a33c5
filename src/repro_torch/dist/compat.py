"""Multi-process init for the distributed layer: the file-based process group.

The twin of ``repro.dist.compat``'s second half (its jax shims have no
counterpart). ``initialize()`` is the coordinator entry point every rank
calls before training, mirroring ``jax.distributed.initialize(
coordinator_address, num_processes, process_id)`` but coordinated
through a *shared filesystem directory* instead of a service. That is
the same substrate the fault protocol already uses (heartbeat files on
the checkpoint filesystem), needs no ports, and lets the multi-process
tests spawn N real ranks as plain subprocesses sharing a tmpdir. The
returned :class:`ProcessGroup` carries the collective primitives the
control plane needs (``barrier``, ``put``/``gather``, ``broadcast``) —
*control-plane only*: scalars and JSON metadata, never tensors. Tensor
resharding stays on the checkpoint layer (per-host shards + partial-read
restore, ``repro_torch.checkpoint.ckpt``).
"""
from __future__ import annotations

from collections.abc import Sequence
import json
import os
import time
from typing import Any

import torch


class ProcessGroupTimeout(TimeoutError):
    """A collective did not complete within its deadline (a peer is
    missing or dead). The caller decides whether that is fatal — the
    fault protocol treats it as an eviction signal, not a crash."""


def _atomic_write_json(path: str, obj: Any) -> None:
    """Crash-atomic publish: a reader never observes a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Any | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # not yet published, or racing the atomic rename


class ProcessGroup:
    """Control-plane collectives over a shared directory.

    Every primitive is **tagged**: a tag names one logical collective
    and must be unique per use (callers include the step/epoch in it,
    e.g. ``f"commit.{step}"``) so reuse across restarts never aliases a
    stale file. Participants default to all ranks but every call takes
    ``ranks=`` — after an eviction the survivors synchronize among
    themselves without waiting on the dead.

    Payload writes are crash-atomic (tmp + rename), so a peer killed
    mid-``put`` is indistinguishable from one that never wrote: the
    collective times out instead of reading garbage.
    """

    def __init__(
        self,
        coord_dir: str,
        rank: int,
        num_processes: int,
        *,
        poll_s: float = 0.01,
        timeout_s: float = 60.0,
    ):
        if not (0 <= rank < num_processes):
            raise ValueError(f"rank {rank} outside world of {num_processes}")
        self.coord_dir = coord_dir
        self.rank = rank
        self.num_processes = num_processes
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self._kv = os.path.join(coord_dir, "kv")
        os.makedirs(self._kv, exist_ok=True)

    # -- point-to-point publish / read ---------------------------------

    def _path(self, tag: str, rank: int) -> str:
        safe = tag.replace(os.sep, "_")
        return os.path.join(self._kv, f"{safe}.{rank:05d}.json")

    def put(self, tag: str, payload: Any = None) -> None:
        """Publish this rank's payload for one tagged collective."""
        _atomic_write_json(self._path(tag, self.rank), payload)

    def try_get(self, tag: str, rank: int) -> Any | None:
        """Non-blocking read of one peer's payload (None if absent)."""
        path = self._path(tag, rank)
        if not os.path.exists(path):
            return None
        return _read_json(path)

    def get(self, tag: str, rank: int, timeout_s: float | None = None) -> Any:
        deadline = time.monotonic() + (
            self.timeout_s if timeout_s is None else timeout_s
        )
        while True:
            if os.path.exists(self._path(tag, rank)):
                out = _read_json(self._path(tag, rank))
                if out is not None or self._exists_nonempty(tag, rank):
                    return out
            if time.monotonic() > deadline:
                raise ProcessGroupTimeout(
                    f"get({tag!r}) from rank {rank} timed out"
                )
            time.sleep(self.poll_s)

    def _exists_nonempty(self, tag: str, rank: int) -> bool:
        try:
            return os.path.getsize(self._path(tag, rank)) > 0
        except OSError:
            return False

    # -- collectives ---------------------------------------------------

    def gather(
        self,
        tag: str,
        payload: Any = None,
        *,
        ranks: Sequence[int] | None = None,
        timeout_s: float | None = None,
    ) -> dict[int, Any]:
        """All-gather of JSON payloads among ``ranks``; returns
        rank → payload once every participant has published."""
        ranks = list(range(self.num_processes)) if ranks is None else list(ranks)
        self.put(tag, payload)
        return {r: self.get(tag, r, timeout_s) for r in ranks}

    def barrier(
        self,
        tag: str,
        *,
        ranks: Sequence[int] | None = None,
        timeout_s: float | None = None,
    ) -> None:
        self.gather(f"bar.{tag}", None, ranks=ranks, timeout_s=timeout_s)

    def broadcast(
        self,
        tag: str,
        payload: Any = None,
        *,
        src: int = 0,
        timeout_s: float | None = None,
    ) -> Any:
        """One rank publishes, everyone reads (src returns its own)."""
        if self.rank == src:
            self.put(tag, payload)
        return self.get(tag, src, timeout_s)


def initialize(
    coord_dir: str,
    *,
    process_id: int,
    num_processes: int,
    timeout_s: float = 60.0,
) -> ProcessGroup:
    """``jax.distributed.initialize``-style entry point, filesystem-backed
    (``torch.distributed`` takes no part).

    Registers this process (pid + local device count) under
    ``<coord_dir>/ranks/`` and blocks until all ``num_processes`` peers
    have registered, so by the time it returns every rank's heartbeat
    file can be expected to exist (missing ⇒ dead, no startup grace
    logic needed downstream). Safe to call again after a restart of the
    same rank: registration is overwritten in place.
    """
    os.makedirs(os.path.join(coord_dir, "ranks"), exist_ok=True)
    pg = ProcessGroup(
        coord_dir, process_id, num_processes, timeout_s=timeout_s
    )
    reg = {
        "pid": os.getpid(),
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "registered_at": time.time(),
    }
    _atomic_write_json(
        os.path.join(coord_dir, "ranks", f"rank_{process_id:05d}.json"), reg
    )
    deadline = time.monotonic() + timeout_s
    want = {f"rank_{r:05d}.json" for r in range(num_processes)}
    while not want.issubset(set(os.listdir(os.path.join(coord_dir, "ranks")))):
        if time.monotonic() > deadline:
            missing = sorted(
                want - set(os.listdir(os.path.join(coord_dir, "ranks")))
            )
            raise ProcessGroupTimeout(
                f"initialize: peers never registered: {missing}"
            )
        time.sleep(pg.poll_s)
    return pg


def registered_ranks(coord_dir: str) -> list[int]:
    """Ranks that have ever registered with :func:`initialize`."""
    d = os.path.join(coord_dir, "ranks")
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if name.startswith("rank_") and name.endswith(".json"):
            try:
                out.append(int(name[5:-5]))
            except ValueError:
                continue
    return sorted(out)
