#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``src/repro_torch`` (never the JAX package) through its serving
path and fails (non-zero exit, no result line) on any error:

1. device check: needs CUDA; prints the card's name and power limit and
   turns TF32 off for float32 matmuls and convolutions;
2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a and prints the build time and the ptxas report;
3. kernel phase: ``paged_attention`` against its plain PyTorch version at
   qwen2.5-3b head shapes (H=16, KV=2, D=128, bs=16, B=4, S in {1, 32},
   NB in {10, 128}; bf16 and fp32 queries over fp32 pools; bf16 pools
   too), raw fp32 outputs held at rtol=atol=1e-4, plus the garbage-table
   fence; times the kernel, the plain version and, as a yardstick only,
   ``F.scaled_dot_product_attention`` on the gathered view;
4. route check: one mixed prefill+decode ``decode_slots`` call of the
   full-width qwen2.5-3b (random bf16 weights) through the kernel route
   and the gather route, with bf16 params and an fp32 copy of them
   (fp32 logits within a relative L2 of 1e-4; the bf16 kernel route no
   further from the fp32 logits than 1.5x the bf16 gather route); then a
   profile of one decode step and one mixed step (host wall time, device
   busy time, the kernels that take most of it); then the serving CLI on
   the reduced config through both routes, whose greedy token streams
   must be identical;
5. serve phase: ``repro_torch.launch.serve.run`` serves 8 Poisson-arriving
   requests (prompt 128, gen 32) through 4 slots of the paged engine at
   full width; every request must get exactly 32 tokens in the
   vocabulary, and the kernel must have launched once per layer per step;
6. prints the kernels' JSON line and, last, the device JSON line.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
import subprocess
import sys
import time

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2**20
KERNEL_TOL = 1e-4  # raw fp32 outputs: summation order only
FP32_ROUTE_TOL = 1e-4  # fp32 params: the routes differ in summation order only
BF16_NOISE_FACTOR = 1.5  # bf16 params: kernel route's distance to fp32 vs the gather route's


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def gpu_time_ms(fn, arg_sets, iters) -> float:
    """Device time of one call: ``iters`` calls queued behind a sleeping
    kernel (so host overhead cannot open gaps between them) and timed
    with CUDA events; the argument sets rotate so the 50 MB L2 does not
    hold the next call's inputs."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paged_case(gen, *, b, s, nb, qdt, pdt, kind, h=16, kv=2, d=128, bs=16, dev="cuda"):
    n_pages = b * nb
    t = nb * bs
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(qdt)
    k = torch.randn((n_pages, bs, kv, d), generator=gen, device=dev).to(pdt)
    v = torch.randn((n_pages, bs, kv, d), generator=gen, device=dev).to(pdt)
    tables = torch.randperm(n_pages, generator=gen, device=dev).reshape(b, nb).to(torch.int32)
    if kind == "mixed":  # mid-page, page boundary, deep, middle
        offs = [7, 2 * bs, t - s, t // 2 + 3]
    else:  # every slot near 2048 tokens (NB=128)
        offs = [t - s, t - s - 3, t - s - 8, t - s - 17]
    qpos = (torch.tensor(offs[:b], device=dev)[:, None] + torch.arange(s, device=dev)).to(torch.int32)
    return q, k, v, tables, qpos


def paged_bound_ms(q, k, tables, qpos) -> tuple[float, str]:
    """Least time for the work this input needs: each needed K/V page read
    once, q/tables/qpos read once, the fp32 output written once; QK and PV
    at 2 flops a multiply-add over the visible keys, in fp32."""
    b, s, h, d = q.shape
    _, bs, kv, _ = k.shape
    pages = ((qpos.max(dim=1).values // bs) + 1).clamp(max=tables.shape[1]).sum().item()
    nbytes = (
        q.numel() * q.element_size()
        + 2 * pages * bs * kv * d * k.element_size()
        + tables.numel() * 4 + qpos.numel() * 4
        + b * s * h * d * 4
    )
    flops = 4 * h * d * (qpos.long() + 1).sum().item()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(pa, F):
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for nb, kind in ((10, "mixed"), (128, "mixed"), (128, "deep")):
        for s in (1, 32):
            for qdt, pdt in ((bf16, f32), (f32, f32)):
                cases.append(dict(b=4, s=s, nb=nb, qdt=qdt, pdt=pdt, kind=kind))
    cases.append(dict(b=4, s=1, nb=10, qdt=bf16, pdt=bf16, kind="mixed"))
    cases.append(dict(b=4, s=32, nb=10, qdt=f32, pdt=bf16, kind="mixed"))

    rows = []
    max_err = 0.0
    for c in cases:
        args = paged_case(gen, **c)
        out = pa.paged_attention(*args)
        torch.cuda.synchronize()
        ref = pa.paged_attention_ref(*args)
        torch.testing.assert_close(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)

        # timing: enough copies of the pools that they overflow L2
        q, k, v, tables, qpos = args
        pool_bytes = 2 * k.numel() * k.element_size()
        n_copies = max(2, min(64, math.ceil(3 * L2_BYTES / pool_bytes)))
        sets = [(q, k.clone(), v.clone(), tables, qpos) for _ in range(n_copies)]
        ms = gpu_time_ms(pa.paged_attention, sets, 100)
        plain_ms = gpu_time_ms(pa.paged_attention_ref, sets, 20)
        # yardstick: SDPA over the pages already gathered (the gather untimed)
        b, s, h, d = q.shape
        nb, bs = tables.shape[1], k.shape[1]
        tl = tables.long()
        mask = (torch.arange(nb * bs, device="cuda")[None, None, :] <= qpos.long()[:, :, None])[:, None]
        lib_sets = [
            (
                q.float().transpose(1, 2),
                kc[tl].reshape(b, nb * bs, -1, d).transpose(1, 2).float().contiguous(),
                vc[tl].reshape(b, nb * bs, -1, d).transpose(1, 2).float().contiguous(),
                mask,
            )
            for _, kc, vc, _, _ in sets
        ]

        def sdpa(qq, kk, vv, mm):
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm, enable_gqa=True)

        library_ms = gpu_time_ms(sdpa, lib_sets, 20)
        bound_ms, bound_by = paged_bound_ms(q, k, tables, qpos)
        row = dict(
            shape=f"B={b} S={s} H={h} KV={k.shape[2]} D={d} bs={bs} NB={nb} qpos={c['kind']}",
            q=str(c["qdt"]).replace("torch.", ""), pools=str(c["pdt"]).replace("torch.", ""),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        rows.append(row)
        print("[kernel] " + json.dumps(row))
        del sets, lib_sets

    # garbage table entries past every slot's horizon: clipped and fenced
    q, k, v, tables, _ = paged_case(gen, b=4, s=1, nb=10, qdt=bf16, pdt=f32, kind="mixed")
    qpos = torch.tensor([[2], [5], [17], [30]], dtype=torch.int32, device="cuda")  # pages <= 1
    bad = tables.clone()
    bad[:, 2] = torch.tensor([999, -7, 999, -7], dtype=torch.int32, device="cuda")
    bad[:, 5:] = 999
    good_out = pa.paged_attention(q, k, v, tables, qpos)
    bad_out = pa.paged_attention(q, k, v, bad, qpos)
    torch.cuda.synchronize()
    if not torch.equal(good_out, bad_out):
        raise AssertionError("garbage table entries past the horizon changed the output")
    torch.testing.assert_close(
        bad_out, pa.paged_attention_ref(q, k, v, bad, qpos), rtol=KERNEL_TOL, atol=KERNEL_TOL
    )
    print("[kernel] garbage-table fence: identical output")
    return rows, max_err


def _cast(params, dtype):
    if isinstance(params, dict):
        return {k: _cast(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast(v, dtype) for v in params]
    return params.to(dtype)


def route_check(cfg, lm, params, dev="cuda"):
    """One mixed step (prefill from 0, prefill mid-cache, deep decode,
    idle slot) through both attention routes on the same pools, with the
    bf16 params and with an exact fp32 copy of them.

    fp32: the routes differ only in the attention's summation order, so
    the logits agree to FP32_ROUTE_TOL. bf16: both routes round the
    attention output to bf16, and a last-bit flip there grows over 36
    layers of random weights, so the two bf16 routes differ by about as
    much as either differs from the fp32 logits; the kernel route must be
    no further from them than BF16_NOISE_FACTOR times the gather route."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, c, bs, nb = 4, 32, 16, 10
    n_pages = b * nb
    pools = lm.init_paged_cache(cfg, n_pages, bs, dtype=torch.float32, device=dev)
    for layer in pools:
        layer["k"].normal_(generator=gen)
        layer["v"].normal_(generator=gen)
    tables = torch.randperm(n_pages, generator=gen, device=dev).reshape(b, nb).to(torch.int32)
    tokens = torch.randint(0, cfg.vocab, (b, c), generator=gen, device=dev, dtype=torch.int32)
    slot_pos = torch.tensor([0, 64, 120, 7], dtype=torch.int32, device=dev)
    count = torch.tensor([32, 32, 1, 0], dtype=torch.int32, device=dev)
    live = count > 0

    def logits_of(p, kernel):
        cache = [{k: t.clone() for k, t in layer.items()} for layer in pools]
        lg, _ = lm.decode_slots(cfg, p, tokens, cache, slot_pos, count,
                                block_tables=tables, paged_kernel=kernel)
        # live rows only, and only the real vocabulary: the padded ids
        # carry -1e30, whose square overflows a float32 norm
        lg = lg[live, : cfg.vocab]
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite logits")
        return lg

    def rel(a, g):
        return ((a - g).norm() / g.norm()).item()

    routes = (("kernel", True), ("gather", False))
    bf = {name: logits_of(params, kernel) for name, kernel in routes}
    p32 = _cast(params, torch.float32)
    f32 = {name: logits_of(p32, kernel) for name, kernel in routes}
    del p32
    out = dict(
        fp32=rel(f32["kernel"], f32["gather"]),
        bf16=rel(bf["kernel"], bf["gather"]),
        bf16_kernel_vs_fp32=rel(bf["kernel"], f32["gather"]),
        bf16_gather_vs_fp32=rel(bf["gather"], f32["gather"]),
        argmax_agree_bf16=(bf["kernel"].argmax(-1) == bf["gather"].argmax(-1)).float().mean().item(),
        argmax_agree_fp32=(f32["kernel"].argmax(-1) == f32["gather"].argmax(-1)).float().mean().item(),
    )
    print(f"[route] full width, mixed step, {int(live.sum())} live slots, logits rel L2 "
          f"kernel vs gather: fp32 {out['fp32']:.3e} (limit {FP32_ROUTE_TOL}), bf16 "
          f"{out['bf16']:.3e}; bf16 vs fp32: kernel {out['bf16_kernel_vs_fp32']:.3e}, "
          f"gather {out['bf16_gather_vs_fp32']:.3e} (limit x{BF16_NOISE_FACTOR}); argmax "
          f"agreement fp32 {out['argmax_agree_fp32']:.2f}, bf16 {out['argmax_agree_bf16']:.2f}")
    if out["fp32"] > FP32_ROUTE_TOL:
        raise AssertionError(f"fp32 kernel and gather routes differ: {out['fp32']} > {FP32_ROUTE_TOL}")
    if out["bf16_kernel_vs_fp32"] > BF16_NOISE_FACTOR * out["bf16_gather_vs_fp32"]:
        raise AssertionError(f"bf16 kernel route is further from fp32 than bf16 noise: {out}")
    return out


def reduced_streams_agree(serve):
    """The serving CLI on the reduced fp32 qwen2.5-3b (2 layers, head_dim
    32), kernel route and gather route: the greedy token streams must be
    identical, as the JAX package's serving recipe requires of its own
    kernel."""
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--requests", "4",
            "--prompt-len", "12", "--gen", "8", "--prefill-chunk", "4", "--block-size", "4",
            "--arrival-rate", "0.5", "--seed", "0", "--device", "cuda"]
    ap = serve.build_parser()
    kernel = serve.run(ap.parse_args(argv))["generated"]
    gather = serve.run(ap.parse_args([*argv, "--no-attn-kernel"]))["generated"]
    if kernel.shape != (4, 8) or not (kernel == gather).all():
        raise AssertionError(f"reduced serve: kernel route {kernel.tolist()} != gather {gather.tolist()}")
    print(f"[route] reduced serve, 4 requests: kernel and gather streams identical {kernel[0].tolist()}")


def step_profile(cfg, lm, params, dev="cuda"):
    """Where one step of the main path spends its time: a decode step
    (4 slots, 1 token each) and a mixed step (two prefill chunks of 32,
    two decodes) at 10 pages a slot through the kernel route. Host wall
    time per step over 5 runs, then one profiled run: device busy time
    and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    gen = torch.Generator(device=dev).manual_seed(2)
    b, bs, nb = 4, 16, 10
    cache = lm.init_paged_cache(cfg, b * nb, bs, dtype=torch.float32, device=dev)
    tables = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
    out = {}
    for name, c, pos, cnt in (("decode", 1, [40, 90, 130, 150], [1, 1, 1, 1]),
                              ("mixed", 32, [0, 64, 120, 150], [32, 32, 1, 1])):
        tokens = torch.randint(0, cfg.vocab, (b, c), generator=gen, device=dev, dtype=torch.int32)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        cnt_t = torch.tensor(cnt, dtype=torch.int32, device=dev)

        def run():
            logits, _ = lm.decode_slots(cfg, params, tokens, cache, pos_t, cnt_t,
                                        block_tables=tables, paged_kernel=True)
            return logits.argmax(-1).cpu()  # the engine's read-back, which waits

        run()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=acts) as prof:
            run()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[profile] {name} step (B={b} C={c} NB={nb}): host wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.models import model as lm

    # 1. device check
    card = smi()
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line.lower() or "warning" in line.lower():
                print(f"[build] {name}: {line.strip()}")

    # 3. kernel phase
    rows, max_err = kernel_phase(pa, F)

    # 4. route check at full width
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[route] init_params full width in {time.perf_counter() - t0:.1f} s")
    route_rel = route_check(cfg, lm, params)
    step_profile(cfg, lm, params)
    del params
    torch.cuda.empty_cache()
    reduced_streams_agree(serve)

    # 5. serve phase: the port's entry point, counted
    argv = ["--arch", "qwen2.5-3b", "--batch", "4", "--requests", "8",
            "--prompt-len", "128", "--gen", "32", "--prefill-chunk", "32",
            "--block-size", "16", "--n-blocks", "0", "--arrival-rate", "0.5",
            "--seed", "0", "--device", "cuda"]
    args = serve.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    out = serve.run(args)
    wall = time.perf_counter() - t0
    launches = pa.launches
    gen = out["generated"]
    st = out["stats"]
    if gen.shape != (8, 32):
        raise AssertionError(f"generated {gen.shape}, expected (8, 32)")
    if gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"tokens outside [0, {cfg.vocab}): {gen.min()}..{gen.max()}")
    steps = out["steps"]
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} x {steps} steps")
    step_ms = np.asarray(out["step_times"]) * 1e3
    print(f"[serve] {card}: {steps} steps, {st['total_tokens']} tokens "
          f"({st['generated_tokens']} generated) in {st['wall_s']:.3f} s of steps "
          f"({wall:.1f} s with init): {st['tokens_per_s']:.1f} tokens/s, "
          f"{out['tokens_per_s']:.1f} generated/s; step p50 {np.percentile(step_ms, 50):.2f} ms "
          f"p99 {np.percentile(step_ms, 99):.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"paged_attention launches {launches} = {cfg.n_layers} x {steps}")
    print("[serve] first request tokens:", gen[0][:16].tolist())

    # 6. result lines
    # the main path's decode shape: 4 slots of 160 tokens (10 pages), one
    # query row each, bf16 queries over the engine's fp32 pools
    head = next(r for r in rows if "NB=10 " in r["shape"] and "S=1 " in r["shape"]
                and r["q"] == "bfloat16" and r["pools"] == "float32")
    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:94",
        launches=launches, max_abs_err=max_err,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        shape=head["shape"] + " q=bfloat16 pools=float32",
        route_rel_l2_fp32=route_rel["fp32"],
    )]
    print(f"[device] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
