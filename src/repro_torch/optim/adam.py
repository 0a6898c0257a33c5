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
    """A tree shaped like ``like`` whose leaves, in :func:`tree_leaves`
    order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
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
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
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


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


def apply_updates(cfg: AdamConfig, params, grads, state: AdamState, *, inplace: bool = False):
    """One Adam(W) step. Returns (new_params, new_state, metrics).

    ``inplace=True`` writes the clipped grads, the moments and the params
    into the tensors passed in (none may require grad) and returns those
    same trees; the numbers are the functional step's."""
    gn = global_norm(grads)
    if cfg.clip_norm > 0:
        if inplace:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        else:
            grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, m, v):
        g32 = g.float()
        if inplace:
            m_n = m.mul_(b1).add_((1 - b1) * g32)
            v_n = v.mul_(b2).add_((1 - b2) * torch.square(g32))
        else:
            m_n = b1 * m + (1 - b1) * g32
            v_n = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m_n / bc1) / (torch.sqrt(v_n / bc2) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        p_n = p.float() - lr * delta
        return (p.copy_(p_n) if inplace else p_n.to(p.dtype)), m_n, v_n

    out = tree_map(upd, params, grads, state.m, state.v)  # (p, m, v) at each leaf

    def pick(i):
        return tree_map(lambda _, o: o[i], params, out)

    return pick(0), AdamState(step, pick(1), pick(2)), {"grad_norm": gn, "lr": lr}


def adamw(cfg: AdamConfig | None = None) -> AdamConfig:
    """The paper's generation-task optimizer (AdamW, default params):
    ``cfg`` if given, else lr 1e-3 with decoupled weight decay 1e-2."""
    return cfg or AdamConfig(lr=1e-3, weight_decay=1e-2)
