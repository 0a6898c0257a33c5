"""A census of one step, taken by a ``TorchDispatchMode`` (twin of
``repro.analysis.jaxpr_walk``).

The reference walks a traced jaxpr. The port runs the step itself, on
``meta`` tensors (nothing is allocated, nothing runs on a device), under
:class:`Census`, which sees every ATen op it dispatches and records:

  * **contractions** — ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``convolution``, ``convolution_backward`` and what
    ``torch.utils.flop_counter`` registers (attention), each with its
    FLOPs, operand and result dtypes, the site scope it ran under
    (``core/backward.py::scope`` / ``region``: the ``SitePolicies`` names)
    and the ``bwd_dtype`` of the sparse backward region it ran in;
  * **kernel launches** — every launch of a hand-written kernel, through
    the wrappers' meta route (``kernels/gathered_matmul.py``), with its
    ``kernels/specs.py`` spec: its tile FLOPs, the product it computes and
    its useful FLOPs. The plain versions never run, so their work is not
    counted;
  * **dtype conversions** (``_to_copy``), **host syncs**, each as often
    as it stalls the host on a card (``.item()`` — ``_local_scalar_dense``
    —, ``nonzero``, ``masked_select``, a boolean mask index or
    ``index_put``, an in-place ``index_put_`` of one scalar value,
    ``bincount`` twice, a tensor-repeated ``repeat_interleave``,
    ``unique``, ``equal``, copies between the host and the device,
    ``torch.tensor`` / ``torch.as_tensor`` of host data on a device:
    ``chip_smoke.py``'s ``[audit]`` holds the count to the card's
    ``set_sync_debug_mode("warn")`` warnings) and
    **collectives** (the c10d ops, by kind, with the bytes each rank sends);
  * **peak live bytes**: every storage an op allocates is tracked from
    its allocation to its free (``StorageWeakRef``), on top of the bytes
    of the arguments the census was given;
  * **liveness**: a contraction whose result no later op reads (views do
    not count as reads) and that the step does not return is dead, the
    twin of the reference's dead-equation sweep.

On ``meta`` a data-dependent op has no kernel. The census answers it with
its largest shape (every element of a mask counted as set; a scalar read
as 1) and records a host sync at that site; the model code is unchanged.

FLOPs conventions are the reference walker's (``jaxpr_walk.py``'s module
docstring): a product ``2 * |out| * contracted``; a conv ``2 * B * C_out
* (C_in / G) * prod(O_i * K_i)``, where for the dX of a strided conv
``O_i`` is the cotangent's extent ``L_i`` (the undilated operand), not
the dilated output, and for a stride-1 dX the dX's own extent; the dW
of a conv counts as its forward.
"""
from __future__ import annotations

from collections.abc import Iterable
import dataclasses
import math
from typing import Any

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.core import backward
from repro_torch.kernels import gathered_matmul as gm

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_CONVS = {aten.convolution, aten.convolution_backward}
_SYNCS = {
    aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.bincount,
    aten.unique_consecutive, aten._unique2, aten.unique_dim, aten.equal, aten.is_nonzero,
}


@dataclasses.dataclass(frozen=True)
class Contraction:
    """One contraction op: what it is, its dtypes, FLOPs and where it ran
    (``region_dtype``: the ``bwd_dtype`` of the sparse backward it ran in,
    ``None`` outside one)."""

    op: str
    operand_dtypes: tuple[str, ...]
    out_dtype: str
    flops: int
    scope: str
    region_dtype: str | None
    live: bool = True


@dataclasses.dataclass(frozen=True)
class Convert:
    src: str
    dst: str
    scope: str


@dataclasses.dataclass(frozen=True)
class HostSync:
    op: str
    scope: str


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str
    bytes: int
    scope: str


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One kernel launch on the meta route, with its spec."""

    name: str
    spec: Any
    scope: str
    region_dtype: str | None


@dataclasses.dataclass
class Counts:
    """Everything the census measures about one step."""

    contractions: list[Contraction] = dataclasses.field(default_factory=list)
    converts: list[Convert] = dataclasses.field(default_factory=list)
    syncs: list[HostSync] = dataclasses.field(default_factory=list)
    collectives: list[Collective] = dataclasses.field(default_factory=list)
    launches: list[KernelLaunch] = dataclasses.field(default_factory=list)
    arg_bytes: int = 0
    peak_bytes: int = 0  # the arguments' bytes plus the most tracked storage live at once

    @property
    def flops(self) -> int:
        """Live contraction FLOPs of the torch ops (kernels apart)."""
        return sum(c.flops for c in self.contractions if c.live)

    @property
    def dead_flops(self) -> int:
        return sum(c.flops for c in self.contractions if not c.live)

    @property
    def dead_ops(self) -> int:
        return sum(not c.live for c in self.contractions)

    @property
    def kernel_flops(self) -> int:
        """The launched tiles' FLOPs (``specs.py``'s ``tile_flops``)."""
        return sum(k.spec.tile_flops for k in self.launches)

    @property
    def kernel_product_flops(self) -> int:
        """The products the kernels were asked for (their plain versions')."""
        return sum(k.spec.product_flops for k in self.launches)

    @property
    def total_flops(self) -> int:
        """Torch-op contractions plus the kernels' tile FLOPs."""
        return self.flops + self.kernel_flops

    @property
    def flops_lo(self) -> int:
        """The reference's interval: one number here (eager runs no
        ``cond``), the torch ops' plus the kernels' products."""
        return self.flops + self.kernel_product_flops

    flops_hi = flops_lo

    def launches_by_name(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for k in self.launches:
            out[k.name] = out.get(k.name, 0) + 1
        return out

    def collectives_by_kind(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for c in self.collectives:
            rec = out.setdefault(c.kind, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += c.bytes
        return out


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def conv_flops(x_shape, w_shape, out_shape, transposed: bool = False) -> int:
    """A forward conv's FLOPs: ``2 * B * C_out * (C_in/G) * prod(O_i * K_i)``;
    transposed (``w [C_in, C_out/G, K...]``), ``O_i`` is the input's extent
    (the undilated operand)."""
    b = x_shape[0]
    if transposed:
        c_in, c_out_g = w_shape[0], w_shape[1]
        pairs = math.prod(x_shape[2 + i] * w_shape[2 + i] for i in range(len(w_shape) - 2))
        return 2 * b * c_in * c_out_g * pairs
    c_out, c_in_g = w_shape[0], w_shape[1]
    pairs = math.prod(out_shape[2 + i] * w_shape[2 + i] for i in range(len(w_shape) - 2))
    return 2 * b * c_out * c_in_g * pairs


def conv_backward_flops(dy_shape, x_shape, w_shape, stride, mask) -> int:
    """dX (``mask[0]``): ``prod(L_i * K_i)`` with ``L_i`` the cotangent's
    extent where the stride is above 1, else the dX's; dW (``mask[1]``):
    the forward's count."""
    b, c_out, c_in_g = x_shape[0], w_shape[0], w_shape[1]
    nd = len(w_shape) - 2
    total = 0
    if mask[0]:
        pairs = math.prod((dy_shape[2 + i] if stride[i] > 1 else x_shape[2 + i]) * w_shape[2 + i]
                          for i in range(nd))
        total += 2 * b * c_out * c_in_g * pairs
    if mask[1]:
        total += conv_flops(x_shape, w_shape, dy_shape)
    return total


def _product_flops(func, args, out) -> int:
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet is aten.convolution:
        return conv_flops(args[0].shape, args[1].shape, out.shape, transposed=bool(args[6]))
    if packet is aten.convolution_backward:
        if args[7]:
            raise NotImplementedError("the census counts no transposed conv's backward")
        return conv_backward_flops(args[0].shape, args[1].shape, args[2].shape, args[4],
                                   args[10])
    from torch.utils.flop_counter import flop_registry

    return int(flop_registry[packet](*args, out_val=out))


def _operands(func, args) -> tuple[torch.Tensor, ...]:
    packet = func.overloadpacket
    if packet in (aten.addmm, aten.baddbmm):
        return args[1], args[2]
    if packet is aten.convolution_backward:
        return args[0], args[1], args[2]
    return tuple(a for a in args[:2] if isinstance(a, torch.Tensor))


def _is_contraction(func) -> bool:
    packet = func.overloadpacket
    if packet in _PRODUCTS or packet in _CONVS:
        return True
    from torch.utils.flop_counter import flop_registry

    return packet in flop_registry


def _scalar_one(t: torch.Tensor):
    if t.dtype == torch.bool:
        return True
    return 1.0 if t.dtype.is_floating_point else 1


class Census(TorchDispatchMode):
    """Counts one step (module docstring). Use as a context manager around
    the step, then :meth:`finish` with what the step returned::

        with Census(args=(params, opt_state, batch)) as c:
            out = step(params, opt_state, batch)
        counts = c.finish(out)
    """

    def __init__(self, *, args: Any = ()):
        super().__init__()
        self.counts = Counts()
        self._pinned: set[int] = set()
        for t in _tensors(args):
            cd = t.untyped_storage()._cdata
            if cd not in self._pinned:
                self._pinned.add(cd)
                self.counts.arg_bytes += t.untyped_storage().nbytes()
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._live_bytes = 0  # exact at the last sweep, plus allocations since
        self._peak = 0
        self._pending: dict[int, list[int]] = {}  # storage -> contractions that wrote it
        self._writer_live: list[bool] = []
        self._observing = None

    # ------------------------------------------------------------------

    def __enter__(self):
        self._observing = gm.observe_launches(meta=self._on_launch)
        self._observing.__enter__()
        self._factories = (torch.tensor, torch.as_tensor)
        torch.tensor, torch.as_tensor = (self._from_host(f) for f in self._factories)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            torch.tensor, torch.as_tensor = self._factories
            self._observing.__exit__(*exc)

    def _from_host(self, factory):
        """``torch.tensor`` / ``torch.as_tensor`` counting a host sync where
        they copy host data to a device (a pageable copy: the host waits
        for the stream). They dispatch no op that the mode would see."""
        def make(data, *args, **kwargs):
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev).type != "cpu" and not isinstance(
                    data, torch.Tensor):
                self._sync(factory.__name__)
            return factory(data, *args, **kwargs)
        return make

    def _where(self) -> tuple[str, str | None]:
        region = backward.current_region()
        if region is not None:
            site, policy = region
            return site, policy.bwd_dtype or ""
        return backward.current_scope(), None

    def _on_launch(self, name, spec) -> None:
        scope, region = self._where()
        self.counts.launches.append(KernelLaunch(name, spec, scope, region))

    def _sync(self, op: str) -> None:
        self.counts.syncs.append(HostSync(op, self._where()[0]))

    # ------------------------------------------------------------------
    # storages: allocation, liveness, reads

    def _sweep(self) -> None:
        dead = [cd for cd, (ref, _) in self._live.items() if ref.expired()]
        for cd in dead:
            self._live.pop(cd)
        self._live_bytes = sum(n for _, n in self._live.values())
        self._peak = max(self._peak, self._live_bytes)

    def _track(self, outs: Iterable[torch.Tensor]) -> None:
        grew = False
        for t in outs:
            st = t.untyped_storage()
            cd = st._cdata
            if cd in self._pinned or cd in self._live:
                continue
            n = st.nbytes()
            self._live[cd] = (StorageWeakRef(st), n)
            self._live_bytes += n
            grew = True
        if grew and self._live_bytes > self._peak:
            self._sweep()

    def _read(self, ins: Iterable[torch.Tensor]) -> None:
        if not self._pending:
            return
        for t in ins:
            idx = self._pending.pop(t.untyped_storage()._cdata, None)
            if idx is not None:
                for i in idx:
                    self._writer_live[i] = True

    # ------------------------------------------------------------------

    def _answer(self, func, args, kwargs):
        """The meta answer of a data-dependent op, or None to run it."""
        packet = func.overloadpacket
        x = args[0] if args else None
        if not (isinstance(x, torch.Tensor) and x.device.type == "meta"):
            return None
        if packet is aten._local_scalar_dense:
            return _scalar_one(x)
        if packet is aten.is_nonzero or packet is aten.equal:
            return True
        if packet is aten.nonzero:
            return torch.empty((x.numel(), x.dim()), dtype=torch.long, device="meta")
        if packet is aten.masked_select:
            n = torch.broadcast_shapes(x.shape, args[1].shape)
            return torch.empty((math.prod(n),), dtype=x.dtype, device="meta")
        if packet is aten.bincount:
            minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            w = kwargs.get("weights", args[1] if len(args) > 1 else None)
            dt = torch.long if w is None else torch.promote_types(w.dtype, torch.float32)
            return torch.empty((max(int(minlength), 1),), dtype=dt, device="meta")
        if packet in (aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_):
            idx = args[1]
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
                flat = []
                for i in idx:
                    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                        flat += [torch.empty((i.numel(),), dtype=torch.long, device="meta")] * i.dim()
                    else:
                        flat.append(i)
                return func(args[0], flat, *args[2:], **kwargs)
            return None
        if packet is aten.repeat_interleave and func._overloadname == "Tensor":
            if kwargs.get("output_size") is None:
                return torch.empty((x.numel(),), dtype=x.dtype, device="meta")
            return None
        return None

    def _syncs_of(self, func, args, kwargs) -> int:
        """How many times the op stalls the host on a card: ``bincount``
        twice (its bounds check reads the min, its size the max), an
        in-place ``index_put_`` of one scalar value at integer indices once
        (``t[idx] = True``), the others of the module docstring once."""
        packet = func.overloadpacket
        if packet is aten.bincount:
            return 2
        if packet in _SYNCS:
            return 1
        if packet in (aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]):
                return 1
            return int(packet is aten.index_put_ and args[2].dim() == 0)
        if packet is aten.repeat_interleave and func._overloadname == "Tensor":
            return int(kwargs.get("output_size") is None)
        if packet in (aten._to_copy, aten.copy_):
            src = args[1] if packet is aten.copy_ else args[0]
            dst = args[0].device if packet is aten.copy_ else kwargs.get("device")
            if isinstance(src, torch.Tensor) and dst is not None:
                dst = torch.device(dst)
                host = {src.device.type == "cpu", dst.type == "cpu"}
                return int(host == {True, False} and not kwargs.get("non_blocking", False))
        return 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        for _ in range(self._syncs_of(func, args, kwargs)):
            self._sync(str(packet).split(".")[-1])
        if str(packet).startswith("c10d."):
            self._collective(packet, args)
        out = self._answer(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view:
            self._read(_tensors((args, kwargs)))
            # an output storage no input shares is new, whatever its address:
            # a dead product's storage the allocator hands out again is no read
            for t in outs:
                self._pending.pop(t.untyped_storage()._cdata, None)
        if packet is aten._to_copy and "dtype" in kwargs and kwargs["dtype"] != args[0].dtype:
            self.counts.converts.append(
                Convert(str(args[0].dtype), str(kwargs["dtype"]), self._where()[0]))
        if _is_contraction(func):
            scope, region = self._where()
            ops_ = _operands(func, args)
            self.counts.contractions.append(Contraction(
                str(packet).split(".")[-1], tuple(str(t.dtype) for t in ops_),
                str(outs[0].dtype) if outs else "", _product_flops(func, args, out), scope, region))
            self._writer_live.append(False)
            i = len(self._writer_live) - 1
            for t in outs:
                self._pending.setdefault(t.untyped_storage()._cdata, []).append(i)
        self._track(t for t in outs if t.device.type == "meta")
        return out

    def _collective(self, packet, args) -> None:
        name = str(packet).split(".")[-1].rstrip("_")
        kind = {"allreduce": "all-reduce", "allgather": "all-gather",
                "_allgather_base": "all-gather", "allgather_into_tensor_coalesced": "all-gather",
                "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
                "alltoall": "all-to-all", "alltoall_base": "all-to-all",
                "broadcast": "broadcast"}.get(name, name)
        src = args[1] if name in ("allgather", "_allgather_base") else args[0]
        self.counts.collectives.append(
            Collective(kind, sum(_nbytes(t) for t in _tensors(src)), self._where()[0]))

    def finish(self, returned: Any = ()) -> Counts:
        """The counts, with the contractions the step returned (``returned``)
        or some later op read marked live."""
        self._read(_tensors(returned))
        self._sweep()
        self.counts.contractions = [
            dataclasses.replace(c, live=live)
            for c, live in zip(self.counts.contractions, self._writer_live, strict=True)]
        self.counts.peak_bytes = self.counts.arg_bytes + self._peak
        return self.counts


def meta_like(tree):
    """``tree`` with every tensor replaced by an empty one on ``meta`` of
    its shape and dtype (``requires_grad`` kept)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        m = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return m.requires_grad_(t.requires_grad) if t.is_floating_point() else m

    return tree_map(one, tree)
