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
self-drafts with the target.

``--data-mesh D --model-mesh M`` serves on a ``data x model`` mesh: the
one command spawns D·M ranks, one process each
(``launch/mesh.py::run_on_mesh``; NCCL when each rank has a card, gloo
when they share one or run on the CPU). Each rank holds its shards of
the params and its KV heads of the paged pool (or the contiguous cache)
and runs ``paged_attention`` on them. Over ``data`` the slots split
where D divides ``--batch`` (each rank computes its slots' rows; else
every data rank computes every slot), and the paged pool stays whole
and equal on every data rank: each step all-gathers the data ranks' new
K/V rows into every replica. The engine's host state is the same on
every rank, which every step keeps in lock-step: each rank draws its
slots' tokens from the same full row of logits (all-gathered over the
vocabulary) and the step's tokens are all-gathered over ``data``. The
lock-step engine runs on the mesh too (``serve/lockstep.py``), its
contiguous cache split as the reference's ``cache_specs`` fits it.
Rank 0's result is returned. Every family serves on a mesh: MoE ranks
hold their experts, SSM ranks their heads' state rows, the
encoder-decoder runs its encoder a request on the model mesh. Where the
model size cuts q's columns across heads, each rank runs the heads its
columns touch (``models/layers.py::head_span``), and where it does not
divide the KV heads each rank caches the KV heads its q heads read (the
layout of the reference's ``replicate_kv``). Still refused, naming its
ROADMAP item: a model mesh that does not divide the experts
(``models/model.py::mesh_unported``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --requests 8 --prompt-len 128 --gen 32 --prefill-chunk 32 \
      --arrival-rate 0.5 --temperature 0.8 --top-k 50 --top-p 0.95
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --batch 2 --requests 4 --prompt-len 12 --gen 8 --prefill-chunk 4 \
      --block-size 4 --model-mesh 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --batch 2 --requests 4 --prompt-len 12 --gen 8 --prefill-chunk 4 \
      --block-size 4 --data-mesh 2 --model-mesh 2 --engine lockstep
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import paged_attention as pa
from repro_torch.configs.registry import get_config
from repro_torch.dist import parallel
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import run_on_mesh
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
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction, default=True,
                    help="on the card, the paged engine's steps as captured CUDA graphs (the "
                    "dense family without speculation, one device); --no-graphs runs them "
                    "eagerly")
    return ap


def _refuse_unported(args, cfg) -> None:
    """The mesh combinations serving does not run yet, each with the
    ROADMAP item that ports it."""
    if args.data_mesh * args.model_mesh == 1:
        return
    asked = lm.mesh_unported(cfg, args.model_mesh)
    if asked:
        raise NotImplementedError(f"{'; '.join(asked)}: not ported yet (ROADMAP Queue 1 item 5)")


def rank_params(cfg, seed, device, mesh):
    """The params from ``seed``, or on a mesh this rank's serving shards
    of them (``model.decode_params``). Ranks that share a device (the CPU,
    or one card) build their shards in turn, each full leaf freed once its
    shard is taken: each draws the full tree first, and at once they would
    hold a copy each."""
    if mesh is None:
        return lm.init_params(cfg, seed, device)
    shared = mesh.device.type == "cpu" or torch.cuda.device_count() < mesh.world
    local = None
    for turn in range(mesh.world if shared else 1):
        if not shared or turn == mesh.rank:
            full = lm.init_params(cfg, seed, device)
            specs = lm.mesh_specs(cfg, full, mesh.shape, replicate_kv=cfg.decode_seq_shard)
            local = shd.shard_tree(full, specs, mesh, consume=True)
            del full
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        if shared:
            parallel.barrier(mesh)
    return lm.decode_params(cfg, local, mesh)  # every rank at once: it all-gathers


def run(args, *, cfg=None, timeout_s: float | None = None) -> dict:
    """Serve a Poisson workload with random weights. Returns the JAX
    CLI's result keys (the generated tokens ``[requests, gen]``, steps,
    times, throughput and, for the engines, slot use, preemptions and
    speculation), plus the engine's whole ``stats`` and its per-step
    times. On a mesh, rank 0's, plus every rank's kernel launches
    (``launches_by_rank``, in rank order) and, for the paged engine on a
    data mesh, each rank's running digest of its page pool, a checksum
    after every step (``pool_digests``: equal over the data ranks of a
    model rank).
    ``cfg`` serves another config than the ``--arch`` one (a dtype or
    depth cut, ``decode_seq_shard``: the CLI has no flag for them);
    ``timeout_s`` bounds a mesh run."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    _refuse_unported(args, cfg)
    if args.data_mesh * args.model_mesh > 1:
        return run_on_mesh(serve_rank, args.data_mesh, args.model_mesh, device, args, cfg,
                           timeout_s=timeout_s)
    return serve_rank(None, args, cfg)


def serve_rank(mesh, args, cfg, params=None) -> dict:
    """Serve on this process's device, or as one rank of a ``data x
    model`` mesh (what :func:`run` spawns). ``params``: the model's params
    already built from ``--seed`` (one device), so that a caller that holds
    them serves without a second copy."""
    device = torch.device(args.device) if mesh is None else mesh.device
    n_requests = args.requests or args.batch
    max_seq = args.prompt_len + args.gen + cfg.n_patches  # the JAX CLI's room for the patches

    if params is None:
        params = rank_params(cfg, args.seed, device, mesh)
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

    before = pa.launches
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
                mesh=mesh,
            )
            steps += out["steps"]
            gen_tokens += out["generated_tokens"]
            prefill_s += out["prefill_s"]
            decode_s += out["decode_s"]
            for r, toks in zip(wave, out["tokens"], strict=True):
                tokens_by_rid[r.rid] = toks
        out = {
            "generated": np.stack([tokens_by_rid[r.rid] for r in reqs]),
            "steps": steps,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tokens_per_s": gen_tokens / max(prefill_s + decode_s, 1e-9),
            "slot_utilization": 1.0,
        }
        return _mesh_result(out, mesh, pa.launches - before)

    paged = args.engine == "paged"
    draft_cfg = draft_params = None
    if args.spec_k and args.draft_layers:
        draft_cfg = (cfg.reduced(n_layers=args.draft_layers) if args.reduced
                     else dataclasses.replace(cfg, n_layers=args.draft_layers))
        draft_params = rank_params(draft_cfg, args.seed + 1, device, mesh)
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
        mesh=mesh,
        graphs=args.graphs,
    )
    for r in reqs:
        engine.submit(r)
    on_token = None
    if args.stream:
        def on_token(ev):
            tail = " <eos>" if ev.is_last else ""
            print(f"[stream] rid={ev.rid} token={ev.token}{tail}")
    digest = hashlib.sha256() if mesh is not None and paged and mesh.dp > 1 else None
    while digest is not None and (engine.waiting or engine.by_slot):
        engine.run(max_ticks=1, on_token=on_token)
        digest.update(pool_checksum(engine.slots.cache))
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
    out = dict(out, stats=stats, step_times=list(engine.step_times), captured=engine.captured,
               graphs=engine.graph_stats())
    if digest is not None:
        out["pool_digests"] = [None] * mesh.world
        dist.all_gather_object(out["pool_digests"], digest.hexdigest())
    return _mesh_result(out, mesh, pa.launches - before)


def pool_checksum(cache) -> bytes:
    """A checksum of a paged cache's page pools (its K/V leaves; the SSM
    rows are a data rank's own), made on their device: per leaf the
    position-weighted sum of its words as integers, over the pages a block
    table may name (not the last, the sink, which holds whichever invalid
    token's write landed last). A data mesh's paged run chains one a step
    into a sha256 (``pool_digests``), which is equal on two data ranks
    only if their pools were equal after every step."""
    sums = []
    for layer in cache:
        for k in sorted(set(layer) & {"k", "v"}):
            t = layer[k][:-1].detach().contiguous()
            v = t.view(torch.int16 if t.element_size() == 2 else torch.int32).reshape(-1).long()
            w = torch.arange(v.numel(), device=v.device) % 65521 + 1
            sums.append((v * w).sum())
    return torch.stack(sums).cpu().numpy().tobytes()


def _mesh_result(out: dict, mesh, launches: int) -> dict:
    """``out`` plus, on a mesh, every rank's ``paged_attention`` launches
    (``launches_by_rank``, in rank order)."""
    if mesh is not None:
        n = torch.tensor([launches], dtype=torch.int64, device=mesh.device)
        every = parallel.all_gather(n, None, mesh.world, dim=0)
        out["launches_by_rank"] = [{"paged_attention": int(v)} for v in every.tolist()]
    return out


def main():
    args = build_parser().parse_args()
    out = run(args)
    kernel = args.attn_kernel and args.engine == "paged"
    print(f"[serve] engine={args.engine} kernel={kernel} device={args.device} "
          f"slots={args.batch} gen={args.gen} steps={out['steps']} "
          f"captured={out.get('captured', False)}")
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
