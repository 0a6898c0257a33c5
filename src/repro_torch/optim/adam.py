"""Adam/AdamW, functional, with LR schedules and global-norm clipping.

The twin of ``repro.optim.adam`` over nested dicts/lists of tensors
(the port's param trees): ``m``/``v`` in fp32 whatever the param dtype,
weight decay added to the update ``delta``, ``grad_norm`` measured
before clipping. Functional on purpose (not a ``torch.optim``
subclass): each step returns new params and state, so a step compares
with the JAX package's one for one. ``apply_updates(..., inplace=True)``
does the same arithmetic, bit for bit, into the tensors it is given:
at full width a functional step would hold two copies of the fp32
moments at once. The step count and the learning rate stay on the
params' device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 2e-4  # paper's classification default
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # >0 -> AdamW (decoupled)
    clip_norm: float = 0.0  # 0 disables
    schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in a fixed order: dict keys sorted (as JAX flattens), lists
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` (its keys in ``like``'s order) whose
    leaves, in :func:`tree_leaves` order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def lr_at(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), fp32, on its device."""
    s = step.float()
    # a fill on the device, not a copy from host memory: a pageable copy
    # would stall the host until the stream catches up, every step
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.schedule == "constant":
        return lr
    total = max(cfg.total_steps, 1)
    if cfg.schedule in ("cosine", "warmup_cosine"):
        warm = cfg.warmup_steps if cfg.schedule == "warmup_cosine" else 0
        warm_lr = lr * torch.clamp(s / max(warm, 1), 0.0, 1.0) if warm else lr
        prog = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warm, warm_lr, lr * cos)
    raise ValueError(f"unknown schedule {cfg.schedule}")


def init(params) -> AdamState:
    leaves = tree_leaves(params)
    dev = leaves[0].device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def restored(step: int, m, v) -> AdamState:
    """The state a run resumes from a checkpoint: the restored moments and
    the checkpoint's step as the step count (bias correction reads it),
    on the moments' device."""
    dev = tree_leaves(m)[0].device
    return AdamState(torch.tensor(step, dtype=torch.int32, device=dev), m, v)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


# leaves are updated in groups of at most this many elements: each group is
# one pass of every multi-tensor op, and its fp32 temporaries (the widened
# grads and params, the update) stay a bounded size whatever the model's
GROUP_ELEMS = 1 << 26
# a leaf of at least this many elements is a group of its own, updated by
# single-tensor ops: a multi-tensor launch covers at most 320 chunks of
# 65536 elements, too few blocks to keep a card's memory busy, while a
# single-tensor op spreads a large leaf over the whole card
ALONE_ELEMS = 1 << 22


def _groups(n_elems: list[int]) -> list[list[int]]:
    """The leaves' update groups (leaf indices): a leaf of
    :data:`ALONE_ELEMS` or more alone, the others in order, at most
    :data:`GROUP_ELEMS` elements a group, wherever the large leaves fall
    between them (a group of a few small leaves would be a launch of a
    few blocks)."""
    out, small, total = [], [], 0
    for i, n in enumerate(n_elems):
        if n >= ALONE_ELEMS:
            out.append([i])
            continue
        if small and total + n > GROUP_ELEMS:
            out.append(small)
            small, total = [], 0
        small.append(i)
        total += n
    if small:
        out.append(small)
    return out


def _one_at_a_time(op):
    """``op`` (a ``torch.Tensor`` method) over lists, as the
    ``torch._foreach_*`` op of the same name takes them."""

    def each(xs, *args):
        return [op(x, *(a[i] if isinstance(a, list) else a for a in args))
                for i, x in enumerate(xs)]

    return each


_OPS = ("mul", "mul_", "add_", "div", "div_", "sqrt_", "sub", "sub_", "copy_")
# the update's ops over a group of leaves: multi-tensor, or one leaf's
_MULTI = SimpleNamespace(**{k: getattr(torch, f"_foreach_{k}") for k in _OPS})
_SINGLE = SimpleNamespace(**{k: _one_at_a_time(getattr(torch.Tensor, k)) for k in _OPS})


def apply_updates(cfg: AdamConfig, params, grads, state: AdamState, *, inplace: bool = False,
                  norm=global_norm):
    """One Adam(W) step. Returns (new_params, new_state, metrics).

    The update is multi-tensor: each elementwise stage (the clip too) is
    one ``torch._foreach_*`` call over a group of leaves (:func:`_groups`;
    a large leaf's group is that leaf, updated by the single-tensor ops),
    in the per-leaf order of operations and with its roundings (divisions
    stay divisions, nothing is fused), so every leaf gets the numbers a
    leaf-by-leaf update gives, bit for bit.

    ``inplace=True`` writes the clipped grads, the moments and the params
    into the tensors passed in (none may require grad) and returns those
    same trees; the numbers are the functional step's. ``norm`` measures
    the gradient's global norm (on a mesh, ``dist/parallel.py::global_norm``
    over the local shards)."""
    gn = norm(grads)
    ps, gs, ms, vs = (tree_leaves(t) for t in (params, grads, state.m, state.v))
    scale = _clip_scale(gn, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state.step + 1
    lr = lr_at(cfg, step)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32, device=sf.device), sf)
    b1, b2 = cfg.b1, cfg.b2
    new_p, new_m, new_v = ([None] * len(ps) for _ in range(3))
    for grp in _groups([p.numel() for p in ps]):
        p, g, m, v = ([t[i] for i in grp] for t in (ps, gs, ms, vs))
        ops = _SINGLE if len(grp) == 1 else _MULTI
        if scale is not None:
            if inplace:
                ops.mul_(g, scale)
            else:
                g = ops.mul(g, scale)
        g32 = [t.float() for t in g]
        # m' = b1 * m + (1 - b1) * g, then v' = b2 * v + (1 - b2) * g^2, each
        # temporary freed before the next is made
        if inplace:
            ops.mul_(m, b1)
            ops.mul_(v, b2)
        else:
            m, v = ops.mul(m, b1), ops.mul(v, b2)
        gm = ops.mul(g32, 1 - b1)
        ops.add_(m, gm)
        del gm
        gv = ops.mul(g32, g32)
        del g32
        ops.mul_(gv, 1 - b2)
        ops.add_(v, gv)
        del gv
        # delta = (m' / bc1) / (sqrt(v' / bc2) + eps) [+ wd * p]
        den = ops.div(v, bc2)
        ops.sqrt_(den)
        ops.add_(den, cfg.eps)
        delta = ops.div(m, bc1)
        ops.div_(delta, den)
        del den
        if cfg.weight_decay > 0:
            ops.add_(delta, ops.mul([t.float() for t in p], cfg.weight_decay))
        # p' = p - lr * delta: an fp32 leaf in place, another through fp32
        ops.mul_(delta, lr)
        if inplace:
            wide = [i for i, t in enumerate(p) if t.dtype == torch.float32]
            narrow = [i for i, t in enumerate(p) if t.dtype != torch.float32]
            if wide:
                ops.sub_([p[i] for i in wide], [delta[i] for i in wide])
            if narrow:
                ops.copy_([p[i] for i in narrow], ops.sub(
                    [p[i].float() for i in narrow], [delta[i] for i in narrow]))
        else:
            new = ops.sub([t.float() for t in p], delta)
            for j, i in enumerate(grp):
                new_p[i], new_m[i], new_v[i] = new[j].to(p[j].dtype), m[j], v[j]
        del delta
    if inplace:
        return params, AdamState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}
    new = AdamState(step, tree_unflatten(state.m, new_m), tree_unflatten(state.v, new_v))
    return tree_unflatten(params, new_p), new, {"grad_norm": gn, "lr": lr}


def adamw(cfg: AdamConfig | None = None) -> AdamConfig:
    """The paper's generation-task optimizer (AdamW, default params):
    ``cfg`` if given, else lr 1e-3 with decoupled weight decay 1e-2."""
    return cfg or AdamConfig(lr=1e-3, weight_decay=1e-2)
