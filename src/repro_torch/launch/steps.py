"""Train and serve steps (twin of ``repro.launch.steps``).

``make_train_step`` builds a gradient-accumulation (microbatched) step:
``torch.autograd.grad`` of the LM loss per microbatch, the grads summed
then divided as the JAX package does, and one Adam update, in place.

``make_serve_step`` is the lock-step decode step over the contiguous
cache; ``make_slot_step`` the mixed prefill/decode step of continuous
batching, plain or speculative (``spec=True``). Both emit tokens through
:func:`sample_tokens`: sampling parameters ride in the step state as
per-slot tensors (``temps`` / ``top_ks`` / ``top_ps`` and a ``[B, 2]``
PRNG-lane tensor ``rng``); without ``rng`` the step is greedy argmax.
The draws are ``jax.random``'s own (:mod:`repro_torch.core.prng`), so a
seeded sampled stream is the JAX engine's stream.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.policy import DENSE, PolicyLike
from repro_torch.models import model as lm
from repro_torch.optim import adam

# Bound on per-request top_k (``SamplingParams`` validates against it),
# kept equal to the JAX package's static ``lax.top_k`` cap: the step
# takes the top TOP_K_CAP values once and indexes the k-th per row.
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


_CONTROLS = ("rng", "temps", "top_ks", "top_ps")  # the per-slot sampling tensors


def sampling_state(samplings, device) -> dict[str, torch.Tensor]:
    """The step state's sampling tensors for one ``SamplingParams`` (or
    ``None``, greedy) a row; nothing when every row is greedy, so that
    the step takes the argmax without reading the controls."""
    if all(sp is None or sp.greedy for sp in samplings):
        return {}
    rows = [(0.0, 0, 1.0, (0, 0)) if sp is None else
            (sp.temperature, sp.top_k, sp.top_p, tuple(int(w) for w in sp.key_data()))
            for sp in samplings]
    temps, top_ks, top_ps, rng = zip(*rows, strict=True)
    return {
        "temps": torch.tensor(temps, dtype=torch.float32, device=device),
        "top_ks": torch.tensor(top_ks, dtype=torch.int64, device=device),
        "top_ps": torch.tensor(top_ps, dtype=torch.float32, device=device),
        "rng": torch.tensor(rng, dtype=torch.int64, device=device),
    }


def truncated_logits(logits, temps, top_ks, top_ps):
    """The logits a row draws from: ``logits [B, V]`` over its temperature
    (rows at 0 divided by 1), everything below the k-th of the top
    ``TOP_K_CAP`` values at -inf (``top_ks`` 0 = off), then everything
    past the smallest prefix of the stably sorted distribution whose
    exclusive cumulative mass is under ``top_ps`` at -inf (the top token
    always stays)."""
    v = logits.shape[-1]
    scaled = logits / torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    cap = min(v, TOP_K_CAP)
    top_vals = torch.topk(scaled, cap, dim=-1).values  # [B, cap], descending
    kth = torch.gather(top_vals, 1, (torch.clamp(top_ks, 1, cap) - 1).long()[:, None])
    neg_inf = torch.tensor(float("-inf"), dtype=scaled.dtype, device=scaled.device)
    scaled = torch.where((top_ks[:, None] > 0) & (scaled < kth), neg_inf, scaled)
    idx = torch.sort(-scaled, dim=-1, stable=True).indices
    probs = torch.softmax(torch.gather(scaled, 1, idx), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(1, idx, keep_sorted)
    return torch.where(keep, scaled, neg_inf)


def sample_tokens(logits, *, rng, temps, top_ks, top_ps, fold):
    """Per-row temperature / top-k / top-p sampling over ``[B, V]`` fp32
    logits, as the JAX package's ``sample_tokens`` computes it.

    ``temps [B]`` (0 = greedy argmax for that row), ``top_ks [B]`` (0 =
    off), ``top_ps [B]`` (1.0 = off), ``rng [B, 2]`` the rows' base PRNG
    lanes, ``fold [B]`` the absolute cache position of the token whose
    logits these are. The draw is ``jax.random.categorical`` under
    ``fold_in(rng[b], fold[b])`` over the full (padded) width of
    :func:`truncated_logits`, so a stream is a pure function of (seed,
    position). Returns ``[B]`` int32 tokens."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = truncated_logits(logits, temps, top_ks, top_ps)
    sampled = prng.categorical(prng.fold_in(rng, fold), scaled).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _emit_tokens(logits, state, fold):
    """Greedy-or-sampled next tokens for a step's ``[B, V]`` logits. The
    rows are independent, so only the sampled ones (temperature > 0) go
    through :func:`sample_tokens`; the rest, and every row of a state
    without sampling tensors, take the argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if "rng" not in state:
        return greedy
    rows = torch.nonzero(state["temps"] > 0)[:, 0]
    if not len(rows):
        return greedy
    sampled = sample_tokens(logits[rows], fold=fold[rows], **{k: state[k][rows] for k in _CONTROLS})
    return greedy.index_copy(0, rows, sampled)


def _per_position(controls, c):
    """A slot's sampling controls repeated for each of its ``c`` positions."""
    return {k: torch.repeat_interleave(controls[k], c, dim=0) for k in _CONTROLS if k in controls}


def sample_tokens_chunk(logits, *, rng, temps, top_ks, top_ps, fold):
    """Per-position sampling over a ``[B, C, V]`` chunk: ``fold [B, C]``
    is each position's absolute cache position. Every row of the
    flattened ``[B*C, V]`` takes the width-1 computation with its slot's
    controls, so a position's token equals single-token decode's at the
    same fold. Returns ``[B, C]`` int32."""
    b, c, v = logits.shape
    controls = _per_position(dict(rng=rng, temps=temps, top_ks=top_ks, top_ps=top_ps), c)
    return sample_tokens(logits.reshape(b * c, v), fold=fold.reshape(b * c), **controls).reshape(b, c)


def _emit_chunk_tokens(logits, state, fold):
    """Greedy-or-sampled tokens for every chunk position: [B,C,V] -> [B,C]."""
    b, c, v = logits.shape
    flat = _emit_tokens(logits.reshape(b * c, v), _per_position(state, c), fold.reshape(b * c))
    return flat.reshape(b, c)


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One lock-step decode step over the contiguous cache.

    state = {"tokens": [B,1] int32, "pos": int (every row's write
    position), "cache": the contiguous cache, "enc_out" [B, enc_seq, d]
    (encdec), optional sampling tensors "rng" [B,2] / "temps" /
    "top_ks" / "top_ps" (absent -> greedy)}.
    Returns the new state: ``tokens`` the next tokens ``[B,1]``, ``pos``
    advanced by one, the cache written in place. The draw folds by
    ``pos``, the position of the token whose logits these are."""

    def serve_step(params, state):
        logits, cache = lm.decode_step(cfg, params, state["tokens"], state["cache"], state["pos"],
                                       enc_out=state.get("enc_out"))
        fold = torch.full((logits.shape[0],), state["pos"], dtype=torch.int64,
                          device=logits.device)
        nxt = _emit_tokens(logits, state, fold)[:, None]
        return dict(state, tokens=nxt, pos=state["pos"] + 1, cache=cache)

    return serve_step


def make_slot_step(cfg: ModelConfig, *, paged_kernel: bool = True, spec: bool = False) -> Callable:
    """Mixed prefill/decode step over per-slot state (continuous batching).

    state = {"tokens": [B,C] int32, "count": [B] int32 (real tokens per
    slot; 0 = idle), "pos": [B] int32 (per-slot cache offsets), "cache":
    the paged cache (a list of per-layer pools) or the contiguous one,
    "block_tables": [B, NB] int32 with the paged cache (absent with the
    contiguous one), "enc_out" [B, enc_seq, d] each slot's encoder output
    (encdec), optional per-slot sampling tensors "rng" [B,2] /
    "temps" / "top_ks" / "top_ps" (absent -> greedy argmax)}.
    ``paged_kernel`` (default) attends over the paged cache through the
    paged-attention kernel; ``paged_kernel=False`` gathers the pages.

    Returns ``(next_tokens [B] int32, new_state)``: each slot's token at
    its last real position, drawn at fold ``pos + count - 1``, the cache
    written in place and ``pos`` advanced by ``count``. Rows with count
    == 0 return garbage tokens.

    ``spec=True`` builds the speculative verify step. The state gains
    ``"is_spec" [B]`` bool; a speculative slot's row is ``[t0, d1, ..,
    d_{n-1}]`` (the last committed token, then ``n-1`` draft proposals)
    with ``count = n``. The step emits the target's token at every chunk
    position with that position's fold (``pos + j``) and accepts the
    longest prefix where draft ``d_{j+1}`` equals the target's token at
    position ``j``: ``keep = accepted + 1`` tokens are consumed and
    ``pos`` advances by ``keep``. Other rows take ``keep = count``.
    Rejected K/V writes lie past the committed ``pos``, where the
    per-slot causal mask fences them until they are overwritten. Returns
    ``((tokens [B, C] int32, keep [B] int32), new_state)``.
    """

    def slot_step(params, state):
        tokens, count, pos = state["tokens"], state["count"], state["pos"]
        if not spec:
            logits, new_cache = lm.decode_slots(
                cfg, params, tokens, state["cache"], pos, count, enc_out=state.get("enc_out"),
                block_tables=state.get("block_tables"), paged_kernel=paged_kernel,
            )
            nxt = _emit_tokens(logits, state, pos.long() + count.long() - 1)
            return nxt, dict(state, cache=new_cache, pos=pos + count)

        b, c = tokens.shape
        logits, new_cache = lm.decode_slots(
            cfg, params, tokens, state["cache"], pos, count, enc_out=state.get("enc_out"),
            block_tables=state.get("block_tables"), paged_kernel=paged_kernel,
            all_logits=True, spec_states=True,
        )
        ar = torch.arange(c, device=tokens.device)
        fold = pos.long()[:, None] + ar[None, :]  # [B, C]
        tok = _emit_chunk_tokens(logits, state, fold)  # [B, C]
        keep = count
        if c > 1:
            # draft d_{j+1} rides in the input row: accept while the
            # target's token at position j reproduces it
            matches = (tok[:, :-1] == tokens[:, 1:]) & (ar[None, : c - 1] < (count - 1)[:, None])
            acc = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1).to(count.dtype)
            keep = torch.where(state["is_spec"] & (count > 1), acc + 1, count)
        new_cache = lm.commit_spec_cache(new_cache, keep)
        return (tok, keep), dict(state, cache=new_cache, pos=pos + keep)

    return slot_step
