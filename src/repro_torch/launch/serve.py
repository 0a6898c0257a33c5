"""LM serving CLI — thin front-end over the paged continuous-batching engine.

The twin of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; there is no silent fall-back to the CPU:
asking for ``cuda`` without a card raises). ``--engine`` accepts
``paged`` only, and attention goes through the paged-attention kernel
unless ``--no-attn-kernel`` asks for the gather route. Flags for what
the port does not run yet (sampling, swap preemption, speculative
decoding, meshes) are accepted and refused with an error.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --requests 8 --prompt-len 128 --gen 32 --prefill-chunk 32 \
      --arrival-rate 0.5
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import model as lm
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, poisson_workload


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
    ap.add_argument("--engine", choices=("paged",), default="paged")
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
                    help="drafter depth for speculative decoding")
    ap.add_argument("--stream", action="store_true",
                    help="print token events as they are emitted")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(args) -> dict:
    """Serve a Poisson workload with random weights; returns the
    generated tokens (``[requests, gen]``), the engine's stats and its
    per-step times."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    if args.data_mesh * args.model_mesh != 1:
        raise NotImplementedError("meshes (--data-mesh/--model-mesh > 1) are not ported yet")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_requests = args.requests or args.batch
    max_seq = args.prompt_len + args.gen

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
    engine = ContinuousBatchingEngine(
        cfg,
        params,
        ServeConfig(
            max_slots=args.batch,
            max_seq=max_seq,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget,
            block_size=args.block_size,
            n_blocks=args.n_blocks,
            attn_kernel=args.attn_kernel,
            preempt=args.preempt,
            spec_k=args.spec_k,
        ),
        device=device,
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
    return {
        "generated": np.stack([results[r.rid] for r in reqs]),
        "steps": stats["compute_steps"],
        "prefill_s": stats["prefill_s"],
        "decode_s": stats["decode_s"],
        "tokens_per_s": stats["generated_tokens"]
        / max(stats["prefill_s"] + stats["decode_s"], 1e-9),
        "stats": stats,
        "step_times": list(engine.step_times),
    }


def main():
    args = build_parser().parse_args()
    out = run(args)
    st = out["stats"]
    print(f"[serve] engine={args.engine} kernel={args.attn_kernel} device={args.device} "
          f"slots={args.batch} gen={args.gen} steps={out['steps']}")
    print(f"[serve] prefill {out['prefill_s']*1e3:.0f} ms, decode {out['decode_s']*1e3:.0f} ms"
          f" ({out['tokens_per_s']:.1f} tok/s, "
          f"slot util {st['slot_utilization']*100:.0f}%)")
    print(f"[serve] peak concurrency {st['peak_concurrency']}, "
          f"preemptions {st['preemptions']}")
    print("[serve] first request tokens:", out["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
