"""Synthetic serving workloads: staggered (Poisson) arrivals with
heterogeneous prompt/generation lengths, and a long-tail mix. The port's
own copy of ``repro.serve.workload``: the same seed gives the same
requests in both packages."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.request import Request, SamplingParams


def poisson_workload(
    cfg: ModelConfig,
    *,
    n_requests: int,
    arrival_rate: float = 1.0,  # mean arrivals per engine tick
    prompt_len=(4, 12),  # int or (lo, hi) inclusive
    gen_len=(4, 24),  # int or (lo, hi) inclusive
    seed: int = 0,
    uniform_prompts: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> list[Request]:
    """Build a staggered request list for ``cfg``.

    Arrivals are a Poisson process (exponential inter-arrival, mean
    ``1/arrival_rate`` ticks, floored to integer ticks); prompt and
    generation lengths draw uniformly from their ranges.
    ``uniform_prompts=True`` fixes every prompt at ``prompt_len``'s max.
    ``temperature`` > 0 makes every request sampled under a per-request
    seed drawn from the workload generator. An encdec request gets
    ``frames [enc_seq, d_model]`` fp32, standard normal draws taken
    right after its prompt (before its seed), so every later draw is the
    JAX package's too.
    """
    rng = np.random.default_rng(seed)

    def _range(v):
        return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))

    plo, phi = _range(prompt_len)
    glo, ghi = _range(gen_len)
    if uniform_prompts:
        plo = phi
    arrivals = np.floor(
        np.cumsum(rng.exponential(1.0 / max(arrival_rate, 1e-9), n_requests))
    ).astype(int)
    reqs = []
    for i in range(n_requests):
        p = int(rng.integers(plo, phi + 1))
        g = int(rng.integers(glo, ghi + 1))
        prompt = rng.integers(0, cfg.vocab, size=p).astype(np.int32)
        frames = None
        if cfg.family == "encdec":
            frames = rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(np.float32)
        sp = SamplingParams()
        if temperature > 0:
            sp = SamplingParams(
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                seed=int(rng.integers(2**31)),
            )
        reqs.append(
            Request(
                rid=i,
                prompt=prompt,
                max_new_tokens=g,
                arrival=int(arrivals[i]),
                frames=frames,
                sampling=sp,
            )
        )
    return reqs


def longtail_workload(
    cfg: ModelConfig,
    *,
    n_requests: int,
    arrival_rate: float = 1.0,
    prompt_len=(4, 8),  # int or (lo, hi) inclusive
    gen_short=(3, 6),  # generation range of the short majority
    gen_long=(24, 32),  # generation range of the long tail
    tail_frac: float = 0.2,  # share of requests in the tail
    seed: int = 0,
    uniform_prompts: bool = False,
) -> list[Request]:
    """Long-tail workload: about ``1 - tail_frac`` short requests and a
    few long ones. A contiguous cache budgets every slot for the tail's
    worst case; the paged cache spends pages only on the tail requests
    that grow. The same seed gives the JAX package's requests."""
    rng = np.random.default_rng(seed)
    reqs = poisson_workload(
        cfg,
        n_requests=n_requests,
        arrival_rate=arrival_rate,
        prompt_len=prompt_len,
        gen_len=gen_short,
        seed=seed,
        uniform_prompts=uniform_prompts,
    )
    n_tail = max(1, int(round(tail_frac * n_requests)))
    glo, ghi = (gen_long, gen_long) if isinstance(gen_long, int) else gen_long
    for i in rng.choice(n_requests, size=n_tail, replace=False):
        reqs[i].max_new_tokens = int(rng.integers(glo, ghi + 1))
    return reqs
