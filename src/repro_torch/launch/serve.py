"""LM serving CLI — thin front-end over the continuous-batching engine.

The twin of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; there is no silent fall-back to the CPU:
asking for ``cuda`` without a card raises).

``--engine paged`` (the default here) serves from the paged KV cache
(``--block-size`` tokens a page, ``--n-blocks`` pages, 0 = contiguous
parity) with attention through the paged-attention kernel, unless
``--no-attn-kernel`` asks for the gather route; ``--engine continuous``
serves from the contiguous per-slot cache (plain attention);
``--engine lockstep`` runs the static lock-step baseline (every request
arrives together, the batch stalls until the longest generation ends).
The JAX CLI's default engine is ``continuous``; the port's is ``paged``,
because the paged engine is where the kernel runs.

Sampling: ``--temperature`` > 0 samples every request (with ``--top-k`` /
``--top-p``) under per-request seeds drawn from ``--seed``; the draws
are ``jax.random``'s, so a seeded stream is the JAX CLI's.
``--preempt swap|recompute|auto`` picks the pool-exhaustion policy
(paged engine; sampled requests need swap, which auto picks).
``--spec-k k`` has a drafter propose k tokens a decode slot, verified in
one chunk: the stream is the same, the step count drops.
``--draft-layers n`` builds an n-layer drafter with params from
``--seed + 1``: ``cfg.reduced(n_layers=n)`` with ``--reduced``, as the
JAX CLI does, and the full-width config cut to n layers without it
(the JAX CLI reduces the widths there too, which gives the drafter a
512-token vocabulary the target's tokens overflow). 0 (the default)
self-drafts with the target. Meshes (``--data-mesh`` / ``--model-mesh``
> 1) are not ported yet and raise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --requests 8 --prompt-len 128 --gen 32 --prefill-chunk 32 \
      --arrival-rate 0.5 --temperature 0.8 --top-k 50 --top-p 0.95
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import model as lm
from repro_torch.serve import (
    ContinuousBatchingEngine,
    ServeConfig,
    generate_lockstep,
    lockstep_waves,
    poisson_workload,
)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="slot capacity B")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to serve (default: one per slot)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals per engine tick (0 = all at t=0)")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=0)
    ap.add_argument("--engine", choices=("paged", "continuous", "lockstep"), default="paged",
                    help="paged KV cache with the kernel (default), contiguous "
                    "cache, or the lock-step baseline")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page (paged engine)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="page-pool size (0 = contiguous-parity pool)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0, help="nucleus mass (1.0 = off)")
    ap.add_argument("--preempt", choices=("auto", "swap", "recompute"), default="auto",
                    help="pool-exhaustion policy (paged engine)")
    ap.add_argument("--attn-kernel", action=argparse.BooleanOptionalAction, default=True,
                    help="paged-attention kernel: read K/V pages in place via the "
                    "block table (--no-attn-kernel gathers the pages instead)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per decode slot (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="drafter depth for speculative decoding (0 = self-draft)")
    ap.add_argument("--stream", action="store_true",
                    help="print token events as they are emitted")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(args) -> dict:
    """Serve a Poisson workload with random weights. Returns the JAX
    CLI's result keys (the generated tokens ``[requests, gen]``, steps,
    times, throughput and, for the engines, slot use, preemptions and
    speculation), plus the engine's whole ``stats`` and its per-step
    times."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    if args.data_mesh * args.model_mesh != 1:
        raise NotImplementedError("meshes (--data-mesh/--model-mesh > 1) are not ported yet")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_requests = args.requests or args.batch
    max_seq = args.prompt_len + args.gen + cfg.n_patches  # the JAX CLI's room for the patches

    params = lm.init_params(cfg, args.seed, device)
    reqs = poisson_workload(
        cfg,
        n_requests=n_requests,
        arrival_rate=args.arrival_rate or 1e9,  # 0 -> everything at t=0
        prompt_len=args.prompt_len,
        gen_len=args.gen,
        seed=args.seed,
        uniform_prompts=True,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
    )

    if args.engine == "lockstep":
        # equal capacity with the engines: static waves of --batch
        # requests in arrival order, each stalling on its longest one
        steps = gen_tokens = 0
        prefill_s = decode_s = 0.0
        tokens_by_rid = {}
        for wave in lockstep_waves(reqs, args.batch):
            out = generate_lockstep(
                cfg, params,
                np.stack([r.prompt for r in wave]),
                [r.max_new_tokens for r in wave],
                max_seq=max_seq,
                frames=np.stack([r.frames for r in wave]) if cfg.family == "encdec" else None,
                sampling=[r.sampling for r in wave],
                device=device,
            )
            steps += out["steps"]
            gen_tokens += out["generated_tokens"]
            prefill_s += out["prefill_s"]
            decode_s += out["decode_s"]
            for r, toks in zip(wave, out["tokens"], strict=True):
                tokens_by_rid[r.rid] = toks
        return {
            "generated": np.stack([tokens_by_rid[r.rid] for r in reqs]),
            "steps": steps,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tokens_per_s": gen_tokens / max(prefill_s + decode_s, 1e-9),
            "slot_utilization": 1.0,
        }

    paged = args.engine == "paged"
    draft_cfg = draft_params = None
    if args.spec_k and args.draft_layers:
        draft_cfg = (cfg.reduced(n_layers=args.draft_layers) if args.reduced
                     else dataclasses.replace(cfg, n_layers=args.draft_layers))
        draft_params = lm.init_params(draft_cfg, args.seed + 1, device)
    engine = ContinuousBatchingEngine(
        cfg,
        params,
        ServeConfig(
            max_slots=args.batch,
            max_seq=max_seq,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget,
            block_size=args.block_size if paged else 0,
            n_blocks=args.n_blocks if paged else 0,
            attn_kernel=args.attn_kernel and paged,
            preempt=args.preempt,
            spec_k=args.spec_k,
        ),
        device=device,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
    )
    for r in reqs:
        engine.submit(r)
    on_token = None
    if args.stream:
        def on_token(ev):
            tail = " <eos>" if ev.is_last else ""
            print(f"[stream] rid={ev.rid} token={ev.token}{tail}")
    results = engine.run(on_token=on_token)
    stats = engine.stats()
    out = {
        "generated": np.stack([results[r.rid] for r in reqs]),
        "steps": stats["compute_steps"],
        "prefill_s": stats["prefill_s"],
        "decode_s": stats["decode_s"],
        "tokens_per_s": stats["generated_tokens"]
        / max(stats["prefill_s"] + stats["decode_s"], 1e-9),
    }
    for k in ("tokens_per_step", "slot_utilization", "peak_concurrency", "preemptions",
              "swap_preemptions", "recompute_preemptions", "spec_proposed", "spec_accepted",
              "acceptance_rate", "draft_steps"):
        out[k] = stats[k]
    return dict(out, stats=stats, step_times=list(engine.step_times))


def main():
    args = build_parser().parse_args()
    out = run(args)
    kernel = args.attn_kernel and args.engine == "paged"
    print(f"[serve] engine={args.engine} kernel={kernel} device={args.device} "
          f"slots={args.batch} gen={args.gen} steps={out['steps']}")
    print(f"[serve] prefill {out['prefill_s']*1e3:.0f} ms, decode {out['decode_s']*1e3:.0f} ms"
          f" ({out['tokens_per_s']:.1f} tok/s, "
          f"slot util {out['slot_utilization']*100:.0f}%)")
    if "preemptions" in out:
        print(f"[serve] peak concurrency {out['peak_concurrency']}, "
              f"preemptions {out['preemptions']} "
              f"(swap {out['swap_preemptions']}, "
              f"recompute {out['recompute_preemptions']})")
    if args.spec_k and "spec_proposed" in out:
        print(f"[serve] speculative: accepted {out['spec_accepted']}"
              f"/{out['spec_proposed']} draft tokens "
              f"({out['acceptance_rate']*100:.0f}%), "
              f"{out['draft_steps']} draft steps")
    print("[serve] first request tokens:", out["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
