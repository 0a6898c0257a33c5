"""The static lock-step baseline and parity oracle.

The twin of ``repro.serve.lockstep``: every request of a batch arrives
together, the prompt is teacher-forced one token a step, and the whole
batch decodes in lock-step over the contiguous cache until the longest
generation finishes. It is (a) the reference the continuous engine must
match token for token and (b) the baseline it beats.

It covers sampling too: with per-request
:class:`~repro_torch.serve.request.SamplingParams` the decode draws
through the same per-position PRNG lanes as the engine (the key for the
token at position p is ``fold_in(key_data(seed), p)``), so a seeded
sampled engine run must match the sampled lock-step run exactly.
"""
from __future__ import annotations

from collections.abc import Sequence
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import parallel
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as lm
from repro_torch.serve.request import SamplingParams


def generate_lockstep(
    cfg: ModelConfig,
    params,
    prompts: np.ndarray,  # [B, P] int32 (uniform prompt length)
    gen_lens: Sequence[int],  # per-request generation lengths
    *,
    max_seq: int,
    frames: np.ndarray | None = None,  # [B, enc_seq, d_model] (encdec)
    cache_dtype=torch.float32,
    sampling: Sequence[SamplingParams] | None = None,
    device="cuda",
    mesh=None,
) -> dict[str, object]:
    """Lock-step decode of one static batch (greedy by default;
    ``sampling``, one :class:`SamplingParams` a request, samples through
    the engine's per-position lanes). An encdec batch needs ``frames``,
    encoded once before the first step.

    On a ``data x model`` mesh (``params`` the rank's serving shards) the
    rank runs :func:`~repro_torch.launch.steps.make_serve_step` over its
    rows and shard of the cache (``lm.cache_layout``, with the sequence
    split over ``model`` under ``cfg.decode_seq_shard``, or over ``data``
    where the batch cannot take it), and the generated tokens are
    all-gathered over ``data`` once at the end: every rank returns every
    request's.

    Returns a dict with ``tokens`` (per-request arrays, each cut to its
    gen_len), ``steps`` (model invocations: P-1 teacher steps +
    max(gen_lens) decode steps), the wall-time splits and
    ``generated_tokens``."""
    device = torch.device(device)
    prompts = np.asarray(prompts, np.int32)
    b, p = prompts.shape
    gen_lens = [int(g) for g in gen_lens]
    if len(gen_lens) != b or min(gen_lens) < 1:
        raise ValueError(f"gen_lens {gen_lens}: one length >= 1 per request of {b}")
    max_gen = max(gen_lens)
    if p + max_gen - 1 > max_seq:
        raise ValueError(f"prompt+generation ({p + max_gen - 1}) exceeds max_seq {max_seq}")

    layout = lm.cache_layout(cfg, mesh, b, max_seq, seq_shard=cfg.decode_seq_shard)
    serve_step = steps_lib.make_serve_step(cfg, mesh=mesh, layout=layout)
    rows = layout.rows(prompts)  # this rank's requests
    state = {
        "tokens": torch.from_numpy(rows[:, :1].copy()).to(device),
        "pos": 0,
        "cache": lm.init_local_cache(cfg, layout, mesh, max_seq=max_seq, dtype=cache_dtype,
                                     device=device),
    }
    if sampling is not None:
        sampling = list(sampling)
        if len(sampling) != b:
            raise ValueError(f"sampling has {len(sampling)} entries for batch {b}")
        state.update(steps_lib.sampling_state(layout.rows(sampling), device))
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec lock-step needs frames")
        state["enc_out"] = lm.encode_frames(cfg, params, layout.rows(np.asarray(frames)), device,
                                            mesh=mesh)

    t0 = time.perf_counter()
    for t in range(1, p):
        state = serve_step(params, state)
        state["tokens"] = torch.from_numpy(rows[:, t : t + 1].copy()).to(device)  # teacher-forced
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    for _ in range(max_gen):
        state = serve_step(params, state)
        generated.append(state["tokens"][:, 0].cpu().numpy())
    decode_s = time.perf_counter() - t0

    gen = np.stack(generated, axis=1)  # [B, max_gen] (this rank's rows of B)
    if layout.split:
        gen = parallel.gather_ids_over_data(torch.from_numpy(gen).to(device), mesh).cpu().numpy()
    return {
        "tokens": [gen[i, : gen_lens[i]] for i in range(b)],
        "steps": (p - 1) + max_gen,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "generated_tokens": int(sum(gen_lens)),
    }


def generate_reference(
    cfg: ModelConfig,
    params,
    prompt: np.ndarray,  # [P] int32
    gen_len: int,
    *,
    max_seq: int,
    frames: np.ndarray | None = None,  # [enc_seq, d_model] (encdec)
    cache_dtype=torch.float32,
    sampling: SamplingParams | None = None,
    device="cuda",
) -> np.ndarray:
    """Single-request lock-step decode (greedy, or sampled by
    ``sampling``): the per-request oracle the engine must reproduce."""
    out = generate_lockstep(
        cfg, params, np.asarray(prompt, np.int32)[None], [gen_len],
        max_seq=max_seq, frames=None if frames is None else np.asarray(frames)[None],
        cache_dtype=cache_dtype,
        sampling=None if sampling is None else [sampling], device=device,
    )
    return out["tokens"][0]


def lockstep_waves(requests, capacity: int) -> list[list]:
    """Split a request list into static batches ("waves") of ``capacity``
    in arrival order — how a lock-step server runs a staggered workload."""
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    return [reqs[i : i + capacity] for i in range(0, len(reqs), capacity)]
