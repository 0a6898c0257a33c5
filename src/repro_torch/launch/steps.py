"""Train and serve steps (twin of ``repro.launch.steps``).

``make_train_step`` builds a gradient-accumulation (microbatched) step:
``torch.autograd.grad`` of the LM loss per microbatch, the grads summed
then divided as the JAX package does, and one Adam update, in place.
``make_slot_step`` is the non-speculative mixed prefill/decode serving
step with greedy argmax; sampling and speculative verification are not
ported yet.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DENSE, PolicyLike
from repro_torch.models import model as lm
from repro_torch.optim import adam

# Bound on per-request top_k (``SamplingParams`` validates against it),
# kept equal to the JAX package's static ``lax.top_k`` cap.
TOP_K_CAP = 128


def value_and_grad(fn, params):
    """``((loss, aux), grads)`` of ``fn(params) -> (loss, aux)``, as
    ``jax.value_and_grad(fn, has_aux=True)`` gives them: ``aux`` a dict of
    tensors, grads a tree like ``params``, zeros at a leaf the loss does
    not reach."""
    p = adam.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = fn(p)
    leaves = adam.tree_leaves(p)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs, strict=True)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), adam.tree_unflatten(p, grads)


def make_train_step(
    cfg: ModelConfig,
    policy: PolicyLike,
    opt_cfg: adam.AdamConfig,
    *,
    accum: int = 1,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` is a dict of ``[B, ...]`` tensors; with ``accum > 1`` it is
    cut into ``accum`` microbatches along B, their grads summed in fp32
    and divided by ``accum``, the loss their mean, the other metrics the
    last microbatch's. The Adam update is in place
    (``apply_updates(..., inplace=True)``): the returned params and state
    are the tensors passed in, updated."""

    def train_step(params, opt_state, batch):
        if accum == 1:
            (loss_v, metrics), grads = value_and_grad(
                lambda p: lm.loss_fn(cfg, p, batch, policy), params)
        else:
            grads, loss_v = None, 0.0
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (lv, metrics), g = value_and_grad(
                    lambda p, mb=mb: lm.loss_fn(cfg, p, mb, policy), params)
                grads = (adam.tree_map(lambda t: t.float(), g) if grads is None
                         else adam.tree_map(torch.add, grads, g))
                loss_v = loss_v + lv / accum
            grads = adam.tree_map(lambda t: t / accum, grads)
        with torch.no_grad():
            params, opt_state, om = adam.apply_updates(
                opt_cfg, params, grads, opt_state, inplace=True)
        return params, opt_state, dict(metrics, loss=loss_v, **om)

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the dense cross-entropy, without a graph."""

    def eval_step(params, batch):
        with torch.no_grad():
            return lm.loss_fn(cfg, params, batch, DENSE)[1]["ce"]

    return eval_step


def make_slot_step(cfg: ModelConfig, *, paged_kernel: bool = True) -> Callable:
    """Mixed prefill/decode step over per-slot state (continuous batching).

    state = {"tokens": [B,C] int32, "count": [B] int32 (real tokens per
    slot; 0 = idle), "pos": [B] int32 (per-slot cache offsets), "cache":
    the paged cache (list of per-layer pools), "block_tables": [B, NB]
    int32}. ``paged_kernel`` (default) attends through the paged-attention
    kernel; ``paged_kernel=False`` gathers the pages instead.

    Returns ``(next_tokens [B] int32, new_state)``: greedy argmax at each
    slot's last real token, the cache written in place and ``pos``
    advanced by ``count``. Rows with count == 0 return garbage tokens.
    """

    def slot_step(params, state):
        logits, new_cache = lm.decode_slots(
            cfg, params, state["tokens"], state["cache"],
            state["pos"], state["count"],
            block_tables=state["block_tables"],
            paged_kernel=paged_kernel,
        )
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        new_state = dict(state, cache=new_cache, pos=state["pos"] + state["count"])
        return nxt, new_state

    return slot_step
