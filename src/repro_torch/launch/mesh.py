"""Mesh shapes and device meshes over ``torch.distributed`` (twin of
``repro.launch.mesh``).

A mesh shape is an ordered mapping of axis name to size (``{"data": 16,
"model": 16}``), the duck type the JAX package's shape-only ``_DictMesh``
stands for: :func:`dp_axes` / :func:`dp_size` read a mapping or any
object with a ``shape`` mapping, and ``dist/sharding.py`` repairs specs
against one.

The reference drives every device of a ``jax.make_mesh`` from one
process. The port is multi-controller: one OS process a rank.
:func:`run_on_mesh` spawns the ``data x model`` ranks and returns rank
0's result, and in each rank :func:`make_host_mesh` builds the
``("data", "model")`` mesh, devices enumerated row-major as JAX
enumerates them (rank ``r`` is at ``(r // model, r % model)``) and rank
``r`` on ``cuda:{r % device_count}``.

The backend follows one rule (:func:`backend_for`): NCCL when each rank
has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU. :class:`Mesh` holds the two axis
process groups itself, made by ``new_group`` for every backend, and
``dist/sharding.py`` places tensors from the specs by index arithmetic
(a ``DeviceMesh`` of device type ``cuda`` over gloo groups does not run
DTensor on torch 2.11: its ranks die in a segfault).

The dry run plays one rank of the production mesh in this process:
:func:`make_production_mesh` initialises ``torch.distributed``'s ``fake``
backend (its collectives return at once, on meta tensors too) at 256 or
512 ranks and builds the same groups, with a ``pod`` axis on 512: the
data group then spans ``pod x data``, pod-major, as the JAX package's
``("pod", "data")`` batch axis does, and each of the two axes also has a
group of its own (``data`` within one pod, ``pod`` across pods).

A training step whose global batch the data axes do not divide runs on a
view of the mesh (:meth:`Mesh.over`): its data group is the group of the
axes that split the step's tokens (``models/model.py::BatchLayout``, from
the reference's fitted batch spec), so its loss, importance and gradient
sums run over those ranks alone, and ``seq`` is the sequence split.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping
import ctypes
import dataclasses
import os
import pickle
import signal
import sys
import tempfile
import time
from typing import Any

import torch


def axis_sizes(mesh) -> Mapping[str, int]:
    """The ``{axis: size}`` mapping of a mesh shape or of an object with one."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def production_mesh_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """The JAX package's production mesh: 16x16 on one pod (256 chips),
    2x16x16 across two (512)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ``("pod", "data")`` when present."""
    shape = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def dp_size(mesh) -> int:
    shape = axis_sizes(mesh)
    n = 1
    for a in dp_axes(shape):
        n *= shape[a]
    return n


def backend_for(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (ranks that
    share a card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``r``'s device: ``cuda:{r % device_count}``, ``meta`` for a
    dry run, or the CPU."""
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "meta":
        return device
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``data x model`` mesh (``pod x data x model``
    with ``pod > 1``): the sizes, this rank's coordinates, its device, the
    backend and the process group of each axis (the ranks that share this
    rank's other coordinates; the data group spans ``pod x data``,
    ``data_only_group`` is ``data`` within one pod and ``pod_group``
    ``pod`` alone). ``prefix`` is the scope of the site names a layer
    records (``layer_{li}/``, :meth:`scoped`).

    A view made by :meth:`over` narrows the data group to some of the
    data axes (``dp_n`` ranks, this one at ``dp_i``) and carries the
    step's batch ``layout`` and sequence split ``seq`` (a
    ``models/layers.py::SeqSplit``)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any
    model_group: Any
    prefix: str = ""
    pod: int = 1
    data_only_group: Any = None
    pod_group: Any = None
    dp_n: int = 0
    dp_i: int = -1
    layout: Any = None
    seq: Any = None

    def scoped(self, prefix: str) -> Mesh:
        return dataclasses.replace(self, prefix=prefix)

    def axis_group(self, axes: tuple[str, ...]) -> tuple[Any, int, int]:
        """``(group, size, this rank's index)`` of the data axes ``axes``
        (a subset of ``("pod", "data")``, pod-major)."""
        axes = tuple(a for a in ("pod", "data") if a in axes)
        n = 1
        i = 0
        for a in axes:
            n *= self.shape[a]
            i = i * self.shape[a] + self.coord(a)
        if axes == ("pod", "data") or self.pod == 1 and axes == ("data",):
            group = self.data_group
        elif axes == ("data",):
            group = self.data_only_group
        elif axes == ("pod",):
            group = self.pod_group
        else:
            group = None
        return group, n, i

    def over(self, axes: tuple[str, ...], layout=None, seq=None) -> Mesh:
        """This rank's view with the data group narrowed to ``axes`` (no
        data axis: :meth:`model_only`), carrying ``layout`` and ``seq``."""
        if not axes:
            return dataclasses.replace(self.model_only(), layout=layout)
        group, n, i = self.axis_group(axes)
        return dataclasses.replace(self, data_group=group, dp_n=n, dp_i=i, layout=layout,
                                   seq=seq)

    @property
    def shape(self) -> dict[str, int]:
        if self.pod > 1:
            return {"pod": self.pod, "data": self.data, "model": self.model}
        return {"data": self.data, "model": self.model}

    @property
    def dp(self) -> int:
        """The data group's size: ``pod * data`` (a view's: its axes')."""
        return self.dp_n or self.pod * self.data

    @property
    def world(self) -> int:
        return self.pod * self.data * self.model

    @property
    def data_rank(self) -> int:
        """This rank's place in the data group (pod-major)."""
        return self.dp_i if self.dp_i >= 0 else self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def model_only(self) -> Mesh:
        """This rank's view without the data axis, for a step whose rows
        every data rank holds alike (a serving batch the data size does
        not divide): the model group and coordinates stay."""
        return dataclasses.replace(self, data=1, pod=1, data_group=None, data_only_group=None,
                                   pod_group=None, dp_n=0, dp_i=-1, seq=None)

    def coord(self, axis: str) -> int:
        if axis == "pod":
            return self.rank // self.model // self.data
        if axis == "data":
            return self.rank // self.model % self.data
        return self.model_rank


def make_host_mesh(data: int, model: int, device, *, pod: int = 1) -> Mesh:
    """The ``("data", "model")`` mesh (``("pod", "data", "model")`` with
    ``pod > 1``) over the ranks of the initialised default process group
    (``pod * data * model`` of them), and its two axis groups. Every rank
    calls it, in the same order as every other collective."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world != pod * data * model:
        raise ValueError(f"a {pod}x{data}x{model} mesh needs {pod * data * model} ranks, "
                         f"not {world}")
    rank = dist.get_rank()
    device = torch.device(device)
    backend = dist.get_backend()
    grid = torch.arange(world).reshape(pod * data, model)
    dev = rank_device(device, rank)
    # every rank creates every group, in one order, as new_group requires
    data_group = model_group = data_only = pod_group = None
    for j in range(model):
        g = dist.new_group(grid[:, j].tolist())
        if rank % model == j:
            data_group = g
    for i in range(pod * data):
        g = dist.new_group(grid[i].tolist())
        if rank // model == i:
            model_group = g
    if pod > 1:  # each data axis alone: data within a pod, pod across pods
        cube = grid.reshape(pod, data, model)
        for p in range(pod):
            for j in range(model):
                g = dist.new_group(cube[p, :, j].tolist())
                if rank // model // data == p and rank % model == j:
                    data_only = g
        for i in range(data):
            for j in range(model):
                g = dist.new_group(cube[:, i, j].tolist())
                if rank // model % data == i and rank % model == j:
                    pod_group = g
    return Mesh(data, model, rank, dev, backend, data_group, model_group, pod=pod,
                data_only_group=data_only, pod_group=pod_group)


def shape_mesh(mesh_shape, rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a mesh of ``mesh_shape`` without process
    groups, on ``meta``: what a placement reads (its coordinates), for
    reports that run no step."""
    shape = axis_sizes(mesh_shape)
    return Mesh(shape["data"], shape["model"], rank, torch.device("meta"), "none", None, None,
                pod=shape.get("pod", 1))


_fake: dict[tuple[int, int, int, int], Mesh] = {}


def make_fake_mesh(data: int, model: int, *, pod: int = 1, rank: int = 0) -> Mesh:
    """Rank ``rank`` of a ``pod x data x model`` mesh in this process, over
    ``torch.distributed``'s ``fake`` backend on ``meta``: its collectives
    return at once and move nothing. The default process group is
    (re)initialised for the mesh's world size; a mesh already made is
    returned again."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    key = (pod, data, model, rank)
    if key in _fake and dist.is_initialized():
        return _fake[key]
    if dist.is_initialized():
        dist.destroy_process_group()
        _fake.clear()
    dist.init_process_group("fake", rank=rank, world_size=pod * data * model, store=FakeStore())
    mesh = make_host_mesh(data, model, "meta", pod=pod)
    _fake[key] = mesh
    return mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """Rank ``rank`` of the production mesh (16x16, or 2x16x16 with
    ``multi_pod``) on the fake backend (:func:`make_fake_mesh`)."""
    shape = production_mesh_shape(multi_pod=multi_pod)
    return make_fake_mesh(shape["data"], shape["model"], pod=shape.get("pod", 1), rank=rank)


_PR_SET_PDEATHSIG = 1  # linux/prctl.h


def _end_with(parent: int) -> None:
    """End this process when ``parent`` (its launcher) dies, a SIGKILL
    included: the kernel then sends it SIGKILL (Linux's ``prctl
    PR_SET_PDEATHSIG``). torch's spawn asks for SIGINT, which a rank
    blocked in a collective does not act on: it would live on, holding the
    card's memory. A parent already gone ends it now."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(rank, world, data, model, device, store_path, out_path, parent, fn, args):
    import torch.distributed as dist

    _end_with(parent)
    # the ranks share their launcher's output: a line a write, never torn
    sys.stdout.reconfigure(line_buffering=True)
    torch.set_num_threads(1)
    dev = rank_device(torch.device(device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(torch.device(device), world)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            **({"device_id": dev} if backend == "nccl" else {}))
    try:
        mesh = make_host_mesh(data, model, device)
        out = fn(mesh, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn: Callable, data: int, model: int, device, *args,
                timeout_s: float | None = None) -> Any:
    """Run ``fn(mesh, *args)`` in each of ``data * model`` spawned ranks
    (``spawn``: CUDA cannot fork) rendezvoused through a ``FileStore`` in
    a temporary directory, and return rank 0's result. ``fn`` and
    ``args`` must pickle. The kernels are built here, once, before any
    rank starts. A rank that raises ends the run (the others are
    terminated) and its traceback is raised here; past ``timeout_s`` every
    rank is terminated and ``TimeoutError`` raised. No rank outlives this
    process: each ends when it dies, killed or not (:func:`_end_with`)."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    world = data * model
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
        from repro_torch.kernels import build

        build.build_all()
    backend = backend_for(device, world)
    share = "" if backend == "nccl" or device.type == "cpu" else (
        f", {world} ranks on {torch.cuda.device_count()} card(s)")
    print(f"[mesh] data={data} model={model} ranks={world} backend={backend} "
          f"device={device.type}{share}", flush=True)
    with tempfile.TemporaryDirectory(prefix="mesh-") as td:
        out_path = os.path.join(td, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_main,
            args=(world, data, model, str(device), os.path.join(td, "store"), out_path,
                  os.getpid(), fn, args),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=0.2):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"a {data}x{model} mesh run passed {timeout_s} s")
        with open(out_path, "rb") as f:
            return pickle.load(f)
