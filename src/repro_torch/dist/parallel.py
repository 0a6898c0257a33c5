"""The collectives of a step on a ``data x model`` mesh.

The reference partitions one program with GSPMD, so its mesh step
computes what its one-device step computes. The port runs one process a
rank (``launch/mesh.py``) and writes the collectives out, each an
``autograd.Function`` with its backward, on plain local tensors (the
hand-written kernels and the ssProp ``autograd.Function`` s take plain
tensors):

* :func:`copy_to_model` — identity forward, all-reduce over ``model``
  backward: the input of every column-parallel product (q/k/v/up/gate),
  whose input gradient is a partial sum over the rank's columns;
* :func:`reduce_from_model` — all-reduce forward, identity backward: the
  output of every row-parallel product (o/down);
* :func:`slice_for_model` — this rank's columns of a replicated leaf (the
  QKV biases), its gradient all-gathered back to the full width, so every
  rank holds the same full gradient;
* :func:`gather_from_model` — gather-on-use of a leaf whose spec does not
  line up with heads (k/v at half a KV head a rank): all-gathered over
  ``model``; its gradient, replicated by then, is sliced back to this
  rank's piece;
* :func:`gather_span_from_model` — q's columns where they cut across
  heads: every rank's columns all-gathered and this rank's span of whole
  heads kept; ranks whose spans share a head send different partial
  gradients into its columns, so the backward sums every rank's span
  gradient into this rank's columns, in rank order;
* :func:`vocab_embed` and :func:`vocab_cross_entropy` — the vocab-parallel
  embedding lookup and the cross-entropy over the tied unembedding's
  local logits;
* :func:`sum_over_data` — the masked mean's numerator and denominator,
  summed over ``data`` (and the MoE load-balance statistics);
* :func:`sum_stat_over_model` — a statistic each model rank takes of its
  own columns (the SSM's gated RMSNorm's sum of squares over its heads)
  summed over ``model``; every rank's output reads it, so the gradient is
  summed over ``model`` too;
* :func:`gather_ids_over_data` — int ids (the MoE router's top-k experts,
  a serving step's sampled tokens and accepted counts) of every data
  rank's rows, in global row order (no gradient);
* :func:`from_data_rank` — one data rank's tensor on every data rank (a
  swapped-out slot's SSM rows, staged by every rank);
* :func:`softmax_combine` — seq-sharded decode attention: each rank's
  per-head partial softmax ``(max, sum, out)`` over its slice of the KV
  sequence, all-gathered over the axis group and combined in rank order;
* the sequence split of a training step (``SeqSplit``: a data axis on the
  sequence dim where it does not divide the batch):
  :func:`gather_seq` (every rank's block along the sequence, its gradient
  summed over the group and sliced back to the rank's block: the K/V of
  causal attention), :func:`sum_grad_over_seq` (identity forward, the
  gradient summed over the group: the cross-attention's K/V, projected
  alike on every rank from the encoder's whole rows), :func:`seq_halo`
  (the previous rank's last positions: the SSM's causal conv) and
  :func:`seq_fold` (the state that
  enters the rank's block, folded from every earlier rank's in rank
  order: the SSM's scan).

A replicated leaf that each model rank reads only in part (the SSM's
``conv_w`` over its own channels) goes behind :func:`copy_to_model`
itself: its partial gradients are then summed over ``model``, so every
rank holds the same full gradient.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo runs
those three on CUDA tensors (checked on the H100 machine's torch 2.11).
A ``None`` mesh, or an axis of size 1, makes each of these the plain
one-process op.

:data:`counters` counts the calls to :func:`all_reduce` and
:func:`all_gather` and the bytes each rank sends into them; within
:func:`timed_collectives` each is also bracketed by device syncs and its
wall time added to ``counters["s"]`` (a run apart from the timed one:
the syncs stall the stream).
"""
from __future__ import annotations

from collections.abc import Iterator
import contextlib
import time

import torch
import torch.distributed as dist

# the step's collectives on this rank (reset by whoever reads them); the
# sequence split's (:func:`gather_seq` forward and backward,
# :func:`sum_grad_over_seq`'s backward) among them, also counted apart, and
# of those the cross-attention K/V's gradient sums apart again
counters = {"calls": 0, "bytes": 0, "s": 0.0, "seq_calls": 0, "seq_bytes": 0,
            "kv_sum_calls": 0, "kv_sum_bytes": 0}
_timed = False


@contextlib.contextmanager
def timed_collectives() -> Iterator[None]:
    """Within the block every collective syncs the device before and after
    and adds its wall to ``counters["s"]``."""
    global _timed
    prev, _timed = _timed, True
    try:
        yield
    finally:
        _timed = prev


def _collective(fn, t: torch.Tensor, *args, **kwargs) -> None:
    counters["calls"] += 1
    counters["bytes"] += t.numel() * t.element_size()
    if not _timed:
        fn(*args, **kwargs)
        return
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    sync()
    counters["s"] += time.perf_counter() - t0

# ----------------------------------------------------------------------
# raw collectives (no autograd)
# ----------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` summed (or ``op``) over ``group``, in place; returned."""
    _collective(dist.all_reduce, t, t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def all_gather(t: torch.Tensor, group, n: int, dim: int = -1) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _collective(dist.all_gather, t, parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, src: int = 0):
    """A small picklable ``obj`` from global rank ``src`` to every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def raise_any(err: BaseException | None, mesh) -> None:
    """Every rank of ``mesh`` raises if any rank brings an ``err``: that
    rank its own, the others a ``RuntimeError`` naming the lowest such
    rank. A rank that raised alone would leave its peers in the next
    collective."""
    every = [None] * mesh.world
    dist.all_gather_object(every, None if err is None else f"{type(err).__name__}: {err}")
    if err is not None:
        raise err
    for r, e in enumerate(every):
        if e is not None:
            raise RuntimeError(f"mesh rank {r} raised {e}")


def barrier(mesh) -> None:
    """Every rank waits for every other (an all-reduce of one element)."""
    all_reduce(torch.zeros(1, device=mesh.device), None)


def _model_live(mesh) -> bool:
    return mesh is not None and mesh.model > 1


def _data_live(mesh) -> bool:
    return mesh is not None and mesh.dp > 1


# ----------------------------------------------------------------------
# autograd Functions
# ----------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceForModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        n = t.shape[-1] // mesh.model
        return t[..., mesh.model_rank * n:(mesh.model_rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh.model_group, ctx.mesh.model, dim=-1), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_gather(t, mesh.model_group, mesh.model, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.mesh.model
        r = ctx.mesh.model_rank
        return g[..., r * n:(r + 1) * n].contiguous(), None


class _GatherSpanFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, spans):
        ctx.mesh, ctx.spans, ctx.n = mesh, spans, t.shape[-1]
        lo, hi = spans[mesh.model_rank]
        return all_gather(t, mesh.model_group, mesh.model, dim=-1)[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, spans, n = ctx.mesh, ctx.spans, ctx.n
        width = max(hi - lo for lo, hi in spans)  # every rank's span gradient, padded alike
        g = torch.nn.functional.pad(g.contiguous(), (0, width - g.shape[-1]))
        every = all_gather(g[None], mesh.model_group, mesh.model, dim=0)
        c0 = mesh.model_rank * n
        out = torch.zeros((*g.shape[:-1], n), dtype=g.dtype, device=g.device)
        for j, (lo, hi) in enumerate(spans):  # a fixed order: rank 0 first, no atomics
            a, b = max(lo, c0), min(hi, c0 + n)
            if a < b:
                out[..., a - c0:b - c0] += every[j][..., a - lo:b - lo]
        return out, None, None


class _SumStatOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.contiguous().clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh.model_group), None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``model``."""
    return _CopyToModel.apply(x, mesh) if _model_live(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over ``model``; the gradient passed through."""
    return _ReduceFromModel.apply(x, mesh) if _model_live(mesh) else x


def slice_for_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's equal share of ``t``'s last dim; the gradient
    all-gathered over ``model`` to the full width."""
    return _SliceForModel.apply(t, mesh) if _model_live(mesh) else t


def gather_from_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ``model`` ranks' ``t`` concatenated along the last dim; the
    gradient sliced back to this rank's part. Precondition: that gradient
    is the same on every rank (the whole product computed alike on each).
    Where each rank reads its own part of the result, so that the ranks'
    gradients differ, use :func:`gather_span_from_model`, which sums them."""
    return _GatherFromModel.apply(t, mesh) if _model_live(mesh) else t


def gather_span_from_model(t: torch.Tensor, mesh, spans) -> torch.Tensor:
    """Columns ``spans[r]`` (``[lo, hi)`` of the gathered last dim, one
    pair a model rank, in rank order) of the ``model`` ranks' ``t``
    concatenated along the last dim, on rank ``r``. Ranks whose spans
    overlap send partial gradients into the shared columns: the backward
    all-gathers every rank's span gradient and sums, in rank order, those
    that reach this rank's own columns (a reduce-scatter with a fixed
    order and no atomics)."""
    return _GatherSpanFromModel.apply(t, mesh, tuple(spans)) if _model_live(mesh) else t


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over ``data``; the gradient passed through (each rank's
    share of a global sum gets the sum's gradient)."""
    return _SumOverData.apply(x, mesh) if _data_live(mesh) else x


def sum_stat_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (a statistic of this rank's columns) summed over ``model``;
    the gradient summed over ``model`` as well (each rank's own outputs
    read the sum)."""
    return _SumStatOverModel.apply(x, mesh) if _model_live(mesh) else x


def gather_ids_over_data(ids: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``ids [rows, ...]`` concatenated along dim 0 in
    data-rank order (the global row order); no gradient."""
    if not _data_live(mesh):
        return ids
    return all_gather(ids, mesh.data_group, mesh.dp, dim=0)


def from_data_rank(t: torch.Tensor, mesh, src: int) -> torch.Tensor:
    """Data rank ``src``'s ``t`` on every data rank (each rank passes a
    tensor of the same shape; the others' are ignored)."""
    if not _data_live(mesh):
        return t
    return all_gather(t[None], mesh.data_group, mesh.dp, dim=0)[src]


def softmax_combine(m: torch.Tensor, s: torch.Tensor, o: torch.Tensor, group, n: int,
                    heads: tuple[int, int] | None = None) -> torch.Tensor:
    """The attention output from ``n`` ranks' partial softmaxes over their
    slices of the keys: ``m [..., H]`` each head's largest score, ``s [...,
    H]`` the sum of ``exp(score - m)``, ``o [..., H, D]`` the values so
    weighted, all fp32. The triples are all-gathered over ``group`` and
    combined in rank order (a slice whose keys are all masked has ``m`` at
    -1e30 and weighs 0 beside any rank with a key); ``heads`` keeps only
    those heads. Returns the normalised ``[..., H, D]`` fp32 output, the
    same on every rank."""
    packed = torch.cat([o, m[..., None], s[..., None]], dim=-1)
    every = all_gather(packed, group, n, dim=0).reshape(n, *packed.shape)
    if heads is not None:
        every = every[..., heads[0]:heads[1], :]
    ms, ss, os_ = every[..., -2], every[..., -1], every[..., :-2]
    top = ms.amax(dim=0)
    num = den = None
    for i in range(n):  # a fixed order: the same bits on every rank
        w = torch.exp(ms[i] - top)
        num = os_[i] * w[..., None] if num is None else num + os_[i] * w[..., None]
        den = ss[i] * w if den is None else den + ss[i] * w
    return num / den[..., None]


def _seq_count(t: torch.Tensor) -> None:
    counters["seq_calls"] += 1
    counters["seq_bytes"] += t.numel() * t.element_size()


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        _seq_count(x)
        return all_gather(x, seq.group, seq.n, dim=dim)

    @staticmethod
    def backward(ctx, g):
        seq, dim = ctx.seq, ctx.dim
        g = g.contiguous().clone()
        _seq_count(g)
        all_reduce(g, seq.group)  # every rank's share of each block, summed
        n = g.shape[dim] // seq.n
        return g.narrow(dim, seq.index * n, n).contiguous(), None, None


class _SumGradOverSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _seq_count(g)
        counters["kv_sum_calls"] += 1
        counters["kv_sum_bytes"] += g.numel() * g.element_size()
        return all_reduce(g, ctx.seq.group), None


def sum_grad_over_seq(x: torch.Tensor, seq) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the sequence split
    ``seq``'s group (a fixed order, no atomics). The cross-attention's
    K/V, projected alike on every rank of the group from the encoder's
    whole rows while each rank's queries are its own tokens': their
    gradient is the sum of the ranks' shares, as one device's is."""
    if seq is None or seq.n == 1:
        return x
    return _SumGradOverSeq.apply(x, seq)


def gather_seq(x: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    """Every rank of the sequence split ``seq``'s ``x`` (a block of the
    sequence along ``dim``) concatenated in rank order; the gradient of
    the whole is summed over the group (one all-reduce: a fixed order, no
    atomics) and the rank's block sliced out."""
    if seq is None or seq.n == 1:
        return x
    return _GatherSeq.apply(x, seq, dim)


def _unused(t: torch.Tensor) -> torch.Tensor:
    """A zero scalar that depends on ``t``: a gathered tensor a rank does
    not read still reaches the loss, so that every rank's backward runs
    its gather's all-reduce (a rank that skipped it would hang the
    others)."""
    return torch.where(torch.zeros((), dtype=torch.bool, device=t.device), t.sum(), 0.0)


def seq_halo(x: torch.Tensor, seq, k: int) -> torch.Tensor:
    """The previous rank's last ``k`` positions of ``x [B, L, ...]`` (zeros
    on the first rank), with their gradient sent back to that rank."""
    if x.shape[1] < k:
        raise NotImplementedError(f"a sequence block of {x.shape[1]} positions under a halo "
                                  f"of {k}")
    tails = gather_seq(x[:, x.shape[1] - k:], seq, dim=1)
    if seq.index == 0:
        return torch.zeros_like(tails[:, :k]) + _unused(tails).to(tails.dtype)
    return tails[:, (seq.index - 1) * k:seq.index * k]


def seq_fold(decay: torch.Tensor, state: torch.Tensor, seq) -> torch.Tensor:
    """The linear recurrence's state entering this rank's block: with each
    rank's total ``decay [B, H]`` over its block and the ``state [B, H, N,
    P]`` its block ends in from a zero start, ``h_0 = 0`` and ``h_{r+1} =
    decay_r * h_r + state_r``, taken in rank order over the ranks before
    this one (gradients reach each rank's ``decay`` and ``state`` through
    :func:`gather_seq`)."""
    decays = gather_seq(decay[None], seq, dim=0)
    states = gather_seq(state[None], seq, dim=0)
    h = torch.zeros_like(state) + _unused(decays) + _unused(states)
    for r in range(seq.index):
        h = decays[r][..., None, None] * h + states[r]
    return h


def vocab_range(v_loc: int, mesh) -> tuple[int, int]:
    """The global ids ``[lo, hi)`` of this rank's vocabulary rows."""
    r = mesh.model_rank if _model_live(mesh) else 0
    return r * v_loc, (r + 1) * v_loc


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """The vocab-parallel lookup: rows of ``table [V/model, d]`` for the
    tokens this rank holds, zeros for the others, summed over ``model``.
    The gradient reaches the local rows only."""
    if not _model_live(mesh):
        return table[tokens.long()]
    lo, hi = vocab_range(table.shape[0], mesh)
    ids = tokens.long() - lo
    inside = (ids >= 0) & (ids < hi - lo)
    x = table[ids.clamp(0, hi - lo - 1)].masked_fill(~inside[..., None], 0)
    return reduce_from_model(x, mesh)


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, valid, mesh):
        v_loc = logits.shape[-1]
        lo, hi = vocab_range(v_loc, mesh)
        logits = logits.float()
        if valid is not None and valid < hi:
            logits = logits.clone()
            logits[..., max(valid - lo, 0):] = -1e30
        m = logits.amax(dim=-1)
        if _model_live(mesh):
            all_reduce(m, mesh.model_group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        t = targets.long() - lo
        inside = (t >= 0) & (t < v_loc)
        tc = t.clamp(0, v_loc - 1)
        pick = torch.gather(logits, -1, tc[..., None])[..., 0] * inside
        if _model_live(mesh):
            all_reduce(s, mesh.model_group)
            all_reduce(pick, mesh.model_group)
        ctx.save_for_backward(e, s, tc, inside)
        return torch.log(s) + m - pick

    @staticmethod
    def backward(ctx, g):
        e, s, tc, inside = ctx.saved_tensors
        d = e * (g / s)[..., None]
        d.scatter_add_(-1, tc[..., None], -(g * inside)[..., None])
        return d, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, valid, mesh):
    """Per-token ``-log softmax(logits)[target]`` where ``logits [..., V/model]``
    are this rank's vocabulary columns: the max, the sum of exps and the
    target's logit all-reduced over ``model``. Ids ``>= valid`` (the
    padded vocabulary) are masked to -1e30 in the shard that holds them.
    The result is the same on every model rank."""
    return _VocabCrossEntropy.apply(logits, targets, valid, mesh)


def gather_vocab(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The full ``[..., V]`` logits from each rank's columns, in vocab
    order (serving: every rank samples from the whole row)."""
    if not _model_live(mesh):
        return logits
    return all_gather(logits, mesh.model_group, mesh.model, dim=-1)


# ----------------------------------------------------------------------
# the step's reductions
# ----------------------------------------------------------------------


class SiteMesh:
    """How one ssProp site (named ``site``) sees the mesh: ``col`` says
    that its output channels are split over ``model`` (a column-parallel
    product), so that a global selection gathers the importance first;
    ``rows`` how its rows of dY lie over ``data``:

    * ``"split"`` — each data rank holds its equal share of the rows: the
      importance (a row mean) is averaged over ``data``;
    * ``"padded"`` — each data rank holds every row, its own filled and
      the others' zero (a routed expert's capacity buffer under the
      global dispatch): the importance is summed over ``data``, which is
      the one-device row mean;
    * ``"local"`` — the rows are this rank's alone (an expert of a
      token group the rank owns): no reduction."""

    def __init__(self, mesh, col: bool, site: str = "", rows: str = "split"):
        self.mesh = mesh
        self.col = col and _model_live(mesh)
        self.site = site
        self.rows = rows

    @property
    def model(self) -> int:
        return self.mesh.model if self.col else 1

    @property
    def model_rank(self) -> int:
        return self.mesh.model_rank if self.col else 0

    def data_mean(self, imp: torch.Tensor) -> torch.Tensor:
        """The row mean over every data rank's rows (by :attr:`rows`)."""
        if not _data_live(self.mesh) or self.rows == "local":
            return imp
        tot = all_reduce(imp.clone(), self.mesh.data_group)
        return tot if self.rows == "padded" else tot / self.mesh.dp

    def gather_model(self, imp: torch.Tensor) -> torch.Tensor:
        """The full channel vector from each model rank's columns."""
        return all_gather(imp, self.mesh.model_group, self.mesh.model, dim=0)


def sum_grads_over_data(grads, mesh, alike=None, alike_mesh=None) -> None:
    """Sum every gradient leaf over ``data`` (the step view's data group),
    in place, one all-reduce a dtype (the leaves flattened into one
    buffer).

    ``alike`` (a tree of bools like ``grads``) flags the leaves whose
    gradient is already whole and alike on every rank of the step's
    sequence split: the encoder-decoder's encoder leaves, ``enc_norm`` and
    the cross-attention's k/v kernels and biases
    (``models/model.py::seq_alike``), whose products run on the encoder's
    whole rows after the K/V gradient's sum over the sequence group. Those
    are summed over ``alike_mesh``'s data group instead (the batch axes:
    ``pod`` where it splits the rows; nothing on 16x16), never over
    ``data`` again, which would count them once a data rank."""
    from repro_torch.optim.adam import tree_leaves

    leaves = tree_leaves(grads)
    flags = [False] * len(leaves) if alike is None else tree_leaves(alike)
    _sum_leaves([t for t, f in zip(leaves, flags, strict=True) if not f], mesh)
    _sum_leaves([t for t, f in zip(leaves, flags, strict=True) if f], alike_mesh)


def _sum_leaves(leaves, mesh) -> None:
    if not leaves or not _data_live(mesh):
        return
    for dt in sorted({t.dtype for t in leaves}, key=str):
        group = [t for t in leaves if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce(flat, mesh.data_group)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def global_norm(tree, sharded, mesh) -> torch.Tensor:
    """The global L2 norm of a tree of local shards: the squares of leaves
    split over ``model`` (``sharded``, a tree of bools like ``tree``)
    summed over ``model``, replicated leaves counted once."""
    from repro_torch.optim.adam import tree_leaves

    leaves, flags = tree_leaves(tree), tree_leaves(sharded)
    sq = [torch.sum(torch.square(x.float())) for x in leaves]
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    split = torch.stack([s for s, f in zip(sq, flags, strict=True) if f] or [zero]).sum()
    rep = torch.stack([s for s, f in zip(sq, flags, strict=True) if not f] or [zero]).sum()
    if _model_live(mesh):
        all_reduce(split, mesh.model_group)
    return torch.sqrt(split + rep)
