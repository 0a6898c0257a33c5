#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``src/repro_torch`` (never the JAX package) through its serving
path and its ssProp training paths (ResNet-18, the DDPM UNet, qwen2.5-3b,
mamba2-1.3b), the other decoder-only families (mamba2-1.3b and kimi-k2
serving at full width, the reduced configs of the seven archs beside
qwen2.5-3b), the encoder-decoder and VLM families (whisper-large-v3 and
paligemma-3b serving and training at full width and depth), and fails
(non-zero exit, no result line) on any error:

1. device check: needs CUDA; prints the card's name and power limit and
   turns TF32 off for float32 matmuls and convolutions;
2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a, one process per source, all at once, and prints the
   build time and the ptxas report;
3. kernel phase: ``paged_attention`` against its plain PyTorch version at
   qwen2.5-3b head shapes (H=16, KV=2, D=128, bs=16, B=4, S in {1, 32},
   NB in {10, 128}; bf16 and fp32 queries over fp32 pools; bf16 pools
   too), raw fp32 outputs held at rtol=atol=1e-4, repeated bit for bit,
   plus the garbage-table fence; times the kernel, the plain version and,
   as a yardstick only, ``F.scaled_dot_product_attention`` on the
   gathered view; prints each row's split-KV plan (row tile, splits) and
   its bound beside the fp32 FMA bound, and times the 64-row tensor-core
   rows on the SIMT 16-row tiles too; then, outside the digest, the
   speculative verify chunks: S = 5 (spec_k = 4: 40 rows a KV head, the
   16-row tile) at NB=10 and 128, S = 8 (64 rows, the TF32 tile), and one
   engine step's mix of prefill, verify and decode rows at S = 32; then
   kimi-k2's heads (H=64, KV=8, D=112, which the kernel tiles at 128):
   decode at NB=10 and 128, a 32-row prefill chunk, a spec_k=4 verify
   chunk, fp32 queries, bf16 pools; then (``[kernel-64]``,
   ``[kernel-256]``) whisper's heads (H = KV = 20, D=64) and paligemma's
   (H=8, KV=1, D=256) at the same four cases, bf16 and fp32 queries over
   fp32 pools; every row within 1e-4 * max(1, max|plain|) too;
4. gathered-kernel phase: ``dx_gathered``, ``dw_gathered``,
   ``conv_dw_fused`` and ``conv_dx_fused`` against their plain versions
   at every shape a sparse ResNet-18 training step launches them with
   (B=128, 3x32x32, ``tpu_default(0.8)`` with ``use_pallas``; the route
   table decides which), plus a KB=2-of-4 non-contiguous case and a
   groups=2 case, fp32 and bf16 operands, raw fp32 outputs within
   1e-4 * max(1, max|plain|); dropped blocks exactly 0 after the scatter;
   every kernel repeats bit for bit, and a digest of its outputs at the
   main-path launches is printed, with ``paged_attention``'s at the
   kernel phase's cases (two trees whose kernels compute the same bits
   print the same digests); times each
   kernel, its plain version and one library call (``matmul`` /
   ``conv2d_weight`` / ``conv2d_input`` on the kept channels) at the fp32
   main-path shapes, with the bound of each (all four run fp32 as
   3xTF32 on the tensor cores: their bound is three TF32 products at 495
   TFLOP/s, printed beside the fp32 FMA bound on the per-shape lines),
   the variant that
   ran, the dW kernels' split-K and its TFLOP/s; then each kernel's sum
   over a sparse step's launches beside the library's;
5. LM route check: one mixed prefill+decode ``decode_slots`` call of the
   full-width qwen2.5-3b (random bf16 weights) through the kernel route
   and the gather route, with bf16 params and an fp32 copy of them
   (fp32 logits within a relative L2 of 1e-4; the bf16 kernel route no
   further from the fp32 logits than 1.5x the bf16 gather route); then a
   profile of one decode step and one mixed step (host wall time, device
   busy time, the kernels that take most of it); then the serving CLI on
   the reduced config through both routes, whose greedy token streams
   must be identical; then the reduced fp32 config through the engine
   API: 6 sampled requests on the kernel and the gather route, under swap
   preemption, speculating 4 tokens with a 1-layer drafter (10 verify
   rows a KV head: the 16-row tile), through the contiguous engine and
   the lock-step oracle, every stream identical;
6. serve phase: ``repro_torch.launch.serve.run`` serves 8 Poisson-arriving
   requests (prompt 128, gen 32) through 4 slots of the paged engine at
   full width; every request must get exactly 32 tokens in the
   vocabulary, and the kernel must have launched once per layer per step;
   then ``serve_features_phase``, the rest of serving at full width with
   the same bf16 params, then with an fp32 copy of them: the requests
   sampled (temperature 0.8, top-k 50, top-p 0.95) through the paged
   engine, through a 24-page pool (swap preemptions), speculating 4
   tokens self-drafted and with a full-width 4-layer drafter, through the
   contiguous engine and the lock-step baseline; every page back and
   zero, the kernel launched once a layer a target step, verify steps at
   width 5 on the 16-row tile, acceptance, swaps, tokens/s, p50/p99 step
   time, and the share of tokens equal to the sampled paged run's (at
   least 0.9 in fp32; the bf16 shares are printed: bf16 runs whose steps
   round otherwise part after a few tokens);
7. training-route check: the loss and every gradient of one sparse step
   of the full-width ResNet-18 (B=128, 3x32x32) through the kernels, the
   gather route and the mask oracle, each leaf within a relative L2 of
   1e-4 of the others, with each site's kept blocks printed per route;
8. training phase: ``repro_torch.launch.train_classifier.run`` trains
   ResNet-18 for 8 epoch-bar steps (2 a epoch: steps 2, 3, 6, 7 sparse);
   every loss finite, each gathered kernel launched the route table's
   count times 4, ``paged_attention`` not at all; then a profile of one
   dense and one sparse step;
9. DDPM kernel phase: the four gathered kernels against their plain
   versions at every shape a sparse step of the paper's DDPM UNet
   launches them with (CelebA task: B=128, 3x64x64, base 64, t_dim 256;
   ``tpu_default(0.8)`` with ``use_pallas`` at 32-channel blocks: the 3x3
   convs but the stem fused, the stem and the four 1x1 skips canonical),
   fp32 and bf16, within 1e-4 * max(1, max|plain|), each repeated bit for
   bit, with times, library times and bounds; exact zeros after the
   scatter, and NaN in the 3-channel head's phantom channels leaving
   ``conv_dx_fused``'s output bit for bit as it is;
10. DDPM route check: the loss and every gradient leaf, biases included,
   of one sparse step at full width (B=128) through the kernels, the
   gather route and the mask oracle: the same kept blocks at all 22
   sites (printed, kept/total), each leaf within a relative L2 of 1e-4;
11. DDPM training phase: ``repro_torch.launch.train_ddpm.run`` trains the
   UNet at the CelebA task (T=1000) for 8 epoch-bar steps (2, 3, 6, 7
   sparse) and samples 4 images over the whole schedule; every loss and
   sample finite, each gathered kernel launched the route table's count
   times 4, ``paged_attention`` and ``matmul`` not at all; the backward
   FLOPs ledger, block 32 beside block 128; then a profile of one dense
   and one sparse step (12);
13. LM kernel phase: ``matmul`` at the 8 product shapes of a sparse
   qwen2.5-3b step (B=8, S=128, ``paper_default(0.8)``: K kept = 410, 51,
   2202), with the operands laid out as the backward hands them over
   (``w_k.T`` and ``x2.T`` are transposed views of buffers gathered at a
   pitch of a multiple of 8, as ``gather_columns`` makes them), and
   ``importance`` at the 3 cotangent shapes, bf16 and fp32, raw fp32
   outputs within 1e-4 * max(1, max|plain|), no operand repacked; times
   each kernel, its plain version and one library call (``torch.matmul``
   on the operands as given, whose bf16 output rounding is its only
   difference; for ``importance`` ``torch.linalg.vector_norm`` of order
   1 over the rows in fp32, over M), with the bound of each,
   the variant (bf16: TMA + wgmma, and its split-K; fp32: SIMT) and its
   TFLOP/s;
14. LM route check: one sparse step (0.8) of qwen2.5-3b at full width and
   depth 4, fp32 with TF32 off, through ``matmul``, the gather route and
   the mask oracle: the same kept channels at every site, the same loss,
   every gradient leaf within a relative L2 of 1e-4 between each pair;
15. LM training phase: ``repro_torch.launch.train.run`` trains qwen2.5-3b
   at full width and depth (bf16, B=8, S=128, channel granularity with
   ``--use-pallas``) for 8 epoch-bar steps (steps 2, 3, 6, 7 sparse);
   every loss finite, ``matmul`` launched the launch table's count times
   4, no other kernel, no operand repacked; then a profile of one dense
   and one sparse step, in which the bf16 tensor-core kernel carries all
   504 ``matmul`` launches of the sparse step and the SIMT one none;
16. SSM training: the loss and every gradient leaf of one sparse step of
   mamba2-1.3b at full width and depth 4 (fp32, B=2, S=512) through
   ``matmul``, the gather route and the mask oracle, the same kept
   channels; then ``repro_torch.launch.train.run`` trains mamba2-1.3b at
   full width and depth (48 layers, bf16, B=4, S=512: two 256-token SSD
   chunks) for 8 epoch-bar steps: every loss finite, ``matmul`` launched
   the launch table's 192 times 4, dense and sparse step medians,
   tokens/s and peak memory;
17. SSM serving: mamba2-1.3b at full width and depth serves 8 sampled
   requests (prompt 128, gen 32, 4 slots) through the paged engine, a
   pool small enough to swap, self-drafted speculation (k=4), the
   contiguous engine and the lock-step baseline, bf16 and an fp32 copy;
   the arch has no attention layer, so no kernel runs (checked); every
   page back, every SSM row zero, the fp32 shares of tokens equal to the
   paged run's at least 0.9;
18. MoE serving: kimi-k2 at full width (384 experts, top-8, a shared
   expert, d 7168, heads of 112), depth cut from 61 to 1, bf16 weights:
   8 requests through the paged engine on the kernel route (the kernel
   at head_dim 112) and the gather route; the share of tokens equal
   between them at least 0.9; tokens/s, p50 and p99 step, peak memory;
19. the reduced fp32 configs of the seven new archs and of whisper and
   paligemma: the three-route training check (each routed expert's own
   kept channels, ``matmul`` launches equal to the table; the frames or
   patches in the batch) and identical greedy and sampled streams
   through the paged engine on both routes, swap, speculation with a
   one-period drafter, the contiguous engine and the lock-step oracle;
20. encdec serving (``[encdec-serve]``): whisper-large-v3 at full width
   and depth (32 encoder + 32 decoder layers, d 1280, vocab 51866), 8
   sampled Poisson requests, each with its ``[1500, 1280]`` frames from
   the workload (prompt 16, gen 64, 4 slots, 16-token pages) through the
   paged engine on the kernel and the gather route, a 12-page pool
   (swaps), self-drafted speculation (k=4), the contiguous engine and
   the lock-step baseline, bf16 and an fp32 copy: ``paged_attention``
   launched at D=64 once a layer a target step, every page back and
   zero, tokens/s, p50/p99 step, the encoder's time a call, peak memory,
   the shares of tokens equal to the paged kernel run's (fp32 at least
   0.9); a profile of a decode and a mixed step;
21. VLM serving (``[vlm-serve]``): paligemma-3b at full width and depth
   (18 layers, d 2048, d_ff 16384, vocab 257216), the same runs (prompt
   128, gen 32, ``max_seq`` with room for the 256 patches, a 24-page
   pool), ``paged_attention`` at D=256;
22. encdec and VLM training (``[encdec-kernels]``, ``[vlm-kernels]``,
   ``[encdec-train]``, ``[vlm-train]``): ``matmul`` against its plain
   version, within 1e-4 x max(1, max|plain|), bf16 and fp32, at every
   product of each arch's sparse training step (whisper's encoder and
   cross K/V rows B x 1500, paligemma's B x (256 + 128)), with its time,
   bound, plain and library times; the route check at full width, depth 2, fp32 (kernel / gather / mask:
   the same kept channels, every leaf within 1e-4), then
   ``make_train_step`` at full width and depth, bf16, Adam 2e-4,
   ``paper_default(0.8)`` with ``use_pallas``: whisper B=2 S=128 with
   frames ``[2, 1500, 1280]``, paligemma B=8 S=128 with patches ``[8,
   256, 2048]`` (numpy, from the seed); a warm-up and 3 timed dense and
   sparse steps, ``matmul`` launched ``kernel_launches_per_step`` times
   a sparse step, tokens/s, peak memory;
23. prints the card's line, the kernels' JSON line (a gathered kernel's
   ``launches`` is the sum of the ResNet-18 and DDPM training phases',
   ``paged_attention``'s the serve phase's, the paged runs' of
   ``serve_features_phase``, the kimi-k2, whisper and paligemma serve
   phases', ``matmul``'s the qwen2.5-3b, mamba2-1.3b, whisper and
   paligemma training phases', each in ``launches_by_path``, with the
   verify chunk's times in ``verify``, kimi-k2's decode in ``d112``,
   whisper's in ``d64`` and paligemma's in ``d256``; ``matmul``'s
   ``max_abs_err`` covers the qwen2.5-3b, whisper and paligemma products,
   the latter two also in ``by_arch``; its times are at the ResNet
   path's largest shape, the DDPM path's in ``ddpm``) and,
   last, the device JSON line.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
from pathlib import Path
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
L2_BYTES = 50 * 2**20
KERNEL_TOL = 1e-4  # raw fp32 outputs: summation order only
FP32_ROUTE_TOL = 1e-4  # fp32 params: the routes differ in summation order only
BF16_NOISE_FACTOR = 1.5  # bf16 params: kernel route's distance to fp32 vs the gather route's
TRAIN_ROUTE_TOL = 1e-4  # fp32, TF32 off: the training routes differ in summation order only
RESNET, TRAIN_BATCH, TRAIN_IMAGE = "resnet18", 128, (3, 32, 32)
LM_ARCH, LM_BATCH, LM_SEQ, LM_RATE = "qwen2.5-3b", 8, 128, 0.8
LM_ROUTE_DEPTH = 4  # the route check's depth (full width)
# the paper's CelebA generation task (configs/paper.py GENERATION["celeba"]),
# the UNet at its full width; 32-channel blocks, so blocks really drop
DDPM_BATCH, DDPM_IMAGE, DDPM_T = 128, (3, 64, 64), 1000
DDPM_BASE, DDPM_TDIM, DDPM_BS = 64, 256, 32
LM_KERNELS = {  # kernel -> the TPU kernel it replaces
    "matmul": "src/repro/kernels/gathered_matmul.py:383",
    "importance": "src/repro/kernels/gathered_matmul.py:344",
}
TENSOR_CORE = {  # gathered kernels on the tensor cores -> their design
    "dx_gathered": "3xTF32 mma.sync, 3- or 4-stage cp.async ring",
    "conv_dw_fused": "3xTF32 mma.sync split-K",
    "dw_gathered": "3xTF32 mma.sync split-K",
    "conv_dx_fused": "3xTF32 mma.sync implicit GEMM, interior pixels",
}
GATHERED = {  # kernel -> the TPU kernel it replaces
    "dx_gathered": "src/repro/kernels/gathered_matmul.py:66",
    "dw_gathered": "src/repro/kernels/gathered_matmul.py:119",
    "conv_dw_fused": "src/repro/kernels/gathered_matmul.py:187",
    "conv_dx_fused": "src/repro/kernels/gathered_matmul.py:273",
}


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
    """q, pools, a shuffled table and the qpos of one ``paged_attention``
    case (qwen2.5-3b's heads by default)."""
    n_pages = b * nb
    t = nb * bs
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(qdt)
    k = torch.randn((n_pages, bs, kv, d), generator=gen, device=dev).to(pdt)
    v = torch.randn((n_pages, bs, kv, d), generator=gen, device=dev).to(pdt)
    tables = torch.randperm(n_pages, generator=gen, device=dev).reshape(b, nb).to(torch.int32)
    if kind == "mixed":  # mid-page, page boundary, deep, middle
        offs = [7, 2 * bs, t - s, t // 2 + 3]
    elif kind == "engine":  # a prefill chunk, a verify chunk, a decode token, another verify
        offs = [t - 64, t - 40, t - 33, t // 2 - 20]
    else:  # every slot near 2048 tokens (NB=128)
        offs = [t - s, t - s - 3, t - s - 8, t - s - 17]
    qpos = (torch.tensor(offs[:b], device=dev)[:, None] + torch.arange(s, device=dev)).to(torch.int32)
    return q, k, v, tables, qpos


def paged_bound_ms(q, k, tables, qpos, tf32_terms=None) -> tuple[float, str]:
    """Least time for the work this input needs: each needed K/V page read
    once, q/tables/qpos read once, the fp32 output written once; QK and PV
    at 2 flops a multiply-add over the visible keys, in fp32 at the FMA
    rate, or, given ``tf32_terms = (qk, pv)``, as that many TF32 products
    of each at the tensor cores' rate (the 64-row variant's arithmetic)."""
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
    if tf32_terms is not None:
        t_ops = flops / 2 * sum(tf32_terms) / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def paged_row(pa, F, c, args):
    """One ``paged_attention`` case: held against the plain version at
    KERNEL_TOL and repeated bit for bit; the kernel, the plain version and
    SDPA on the gathered view timed; its bound and split plan. Returns
    (row, output)."""
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_ref(*args)
    torch.testing.assert_close(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    if not torch.equal(out, pa.paged_attention(*args)):
        raise AssertionError(f"paged_attention at {c}: two launches differ")
    err = (out - ref).abs().max().item()
    gate = KERNEL_TOL * max(1.0, ref.abs().max().item())
    if err > gate:
        raise AssertionError(f"paged_attention at {c}: max abs error {err} > {gate}")

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
    fma_ms, fma_by = paged_bound_ms(q, k, tables, qpos)
    plan = pa.paged_split_plan(b, s, h, k.shape[2], d, nb, bs)
    bound_ms, bound_by = fma_ms, fma_by
    simt16 = {}
    if plan.row_tile == 64:  # TF32 products: an fp32 operand takes a second term
        pool32 = k.dtype == torch.float32
        terms = (1 + (q.dtype == torch.float32) + pool32, 2 + pool32)
        bound_ms, bound_by = paged_bound_ms(q, k, tables, qpos, terms)
        # the SIMT 16-row tiles these rows took before the tensor cores, timed beside
        p16 = pa.paged_split_plan(b, s, h, k.shape[2], d, nb, bs, row_tile=16).splits
        torch.testing.assert_close(pa.paged_attention(*args, row_tile=16), ref,
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        simt16 = dict(simt16_ms=gpu_time_ms(
            lambda *a: pa.paged_attention(*a, row_tile=16), sets, 100), simt16_splits=p16)
    row = dict(
        shape=f"B={b} S={s} H={h} KV={k.shape[2]} D={d} bs={bs} NB={nb} qpos={c['kind']}",
        q=str(c["qdt"]).replace("torch.", ""), pools=str(c["pdt"]).replace("torch.", ""),
        variant=plan.variant, splits=plan.splits, row_tile=plan.row_tile,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_fp32_fma_ms=fma_ms, **simt16,
    )
    del sets, lib_sets
    return row, out


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
    digest = hashlib.sha256()  # outputs, in case order
    for c in cases:
        args = paged_case(gen, **c)
        row, out = paged_row(pa, F, c, args)
        digest.update(out.cpu().numpy().tobytes())
        max_err = max(max_err, row["max_abs_err"])
        rows.append(row)
        print("[kernel] " + json.dumps(row))

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

    # speculative verify chunks (1 + spec_k rows a slot), outside the
    # digest so that the earlier cases' digest stays comparable
    vgen = torch.Generator(device="cuda").manual_seed(6)
    verify = [
        dict(b=4, s=5, nb=10, qdt=bf16, pdt=f32, kind="mixed"),  # k=4: 40 rows, 16-row tile
        dict(b=4, s=5, nb=10, qdt=f32, pdt=f32, kind="mixed"),
        dict(b=4, s=5, nb=128, qdt=bf16, pdt=f32, kind="deep"),
        dict(b=4, s=8, nb=10, qdt=bf16, pdt=f32, kind="mixed"),  # k=7: 64 rows, TF32 tile
        # one engine step at the prefill width: prefill, verify and decode rows together
        dict(b=4, s=32, nb=10, qdt=bf16, pdt=f32, kind="engine"),
    ]
    v_rows = []
    for c in verify:
        row, _ = paged_row(pa, F, c, paged_case(vgen, **c))
        row["verify_rows"] = c["s"] * 8
        max_err = max(max_err, row["max_abs_err"])
        v_rows.append(row)
        print("[kernel-verify] " + json.dumps(row))
    if v_rows[0]["row_tile"] != 16 or v_rows[3]["row_tile"] != 64:
        raise AssertionError(f"verify chunks took tiles {[r['row_tile'] for r in v_rows]}")
    print(f"[kernel] {len(cases)} + {len(verify)} verify cases within rtol=atol={KERNEL_TOL}, "
          "each repeated bit for bit")

    # kimi-k2's heads: D=112 (tiled at 128), 64 query heads over 8 KV heads
    kgen = torch.Generator(device="cuda").manual_seed(7)
    kimi = dict(h=64, kv=8, d=112)
    d112 = [
        dict(b=4, s=1, nb=10, qdt=bf16, pdt=f32, kind="mixed", **kimi),  # decode
        dict(b=4, s=1, nb=128, qdt=bf16, pdt=f32, kind="deep", **kimi),
        dict(b=4, s=32, nb=10, qdt=bf16, pdt=f32, kind="mixed", **kimi),  # prefill chunk
        dict(b=4, s=5, nb=10, qdt=bf16, pdt=f32, kind="mixed", **kimi),  # spec_k=4 verify
        dict(b=4, s=1, nb=10, qdt=f32, pdt=f32, kind="mixed", **kimi),
        dict(b=4, s=32, nb=10, qdt=f32, pdt=bf16, kind="mixed", **kimi),
    ]
    k_rows = []
    for c in d112:
        row, _ = paged_row(pa, F, c, paged_case(kgen, **c))
        max_err = max(max_err, row["max_abs_err"])
        k_rows.append(row)
        print("[kernel-112] " + json.dumps(row))
    print(f"[kernel-112] {len(d112)} cases at kimi-k2's heads (D=112 tiled at "
          f"{pa.padded_dim(112)}, chunks of {pa.chunk_keys(112)} keys) within rtol=atol="
          f"{KERNEL_TOL}, each repeated bit for bit")

    # whisper's heads (H = KV = 20, D = 64: one live row in an 8-row decode
    # tile) and paligemma's (8 query heads on one KV head, D = 256: chunks
    # of 16 keys); decode at NB=10 and 128, a 32-row prefill chunk, a
    # spec_k=4 verify chunk; bf16 and fp32 queries over fp32 pools; at
    # D=64 a 64-row chunk on the TF32 tile too
    new_dims = {}
    for d, (h, kv), seed in ((64, (20, 20), 8), (256, (8, 1), 9)):
        ngen = torch.Generator(device="cuda").manual_seed(seed)
        heads = dict(h=h, kv=kv, d=d)
        cases_d = [dict(b=4, s=s, nb=nb, qdt=qdt, pdt=f32, kind=kind, **heads)
                   for qdt in (bf16, f32)
                   for s, nb, kind in ((1, 10, "mixed"), (1, 128, "deep"), (32, 10, "mixed"),
                                       (5, 10, "mixed"))]
        if d == 64:  # G = 1 takes the TF32 tile from 64 rows: fp32 q over fp32 and
            # over bf16 pools, the one D=64 instantiation ptxas spills in
            cases_d += [dict(b=4, s=64, nb=10, qdt=f32, pdt=pdt, kind="mixed", **heads)
                        for pdt in (f32, bf16)]
        new_dims[d] = []
        for c in cases_d:
            row, _ = paged_row(pa, F, c, paged_case(ngen, **c))
            max_err = max(max_err, row["max_abs_err"])
            new_dims[d].append(row)
            print(f"[kernel-{d}] " + json.dumps(row))
        print(f"[kernel-{d}] {len(cases_d)} cases at H={h} KV={kv} D={d} (chunks of "
              f"{pa.chunk_keys(d)} keys) within {KERNEL_TOL} x max(1, max|plain|), each repeated "
              "bit for bit")
    return rows, v_rows, k_rows, new_dims, max_err, digest.hexdigest()[:16]


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


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)  # the sampled runs' controls
SPEC_K = 4
SHARE_MIN = 0.9  # full width, fp32: least share of tokens equal to the sampled paged run's


def _engine_run(S, cfg, params, reqs, dev="cuda", draft=None, **skw):
    """Serve ``reqs`` through a fresh engine; returns (engine, rid -> tokens)."""
    kw = dict(draft_cfg=draft[0], draft_params=draft[1]) if draft else {}
    eng = S.ContinuousBatchingEngine(cfg, params, S.ServeConfig(**skw), device=dev, **kw)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


def _pages_back_and_zero(eng, what):
    if eng.slots.allocator.n_free != eng.slots.n_blocks:
        raise AssertionError(f"{what}: {eng.slots.n_blocks - eng.slots.allocator.n_free} pages "
                             "not back in the pool")
    if any(t.any() for layer in eng.slots.cache for t in layer.values()):
        raise AssertionError(f"{what}: a freed page or SSM row does not read zero")


def reduced_features_agree(lm, S, get_config):
    """The reduced fp32 qwen2.5-3b on the card (2 layers, G = 2, D = 32):
    6 sampled requests through the paged engine on the kernel and the
    gather route, under swap preemption, speculating 4 tokens with a
    1-layer drafter (10 verify rows a KV head: the 16-row tile), through
    the contiguous engine, and each request through the lock-step oracle:
    every stream identical."""
    cfg = get_config("qwen2.5-3b").reduced()
    dcfg = cfg.reduced(n_layers=1)
    params, dparams = lm.init_params(cfg, 0, "cuda"), lm.init_params(dcfg, 1, "cuda")

    def wl():
        return S.poisson_workload(cfg, n_requests=6, arrival_rate=2.0, prompt_len=(3, 7),
                                  gen_len=(8, 12), seed=5, **SAMPLED)

    base = dict(max_slots=3, max_seq=24, prefill_chunk=8, decode_widths=(1, SPEC_K + 1))
    paged = dict(base, block_size=4)
    runs = {
        "paged kernel": dict(paged, attn_kernel=True),
        "paged gather": dict(paged, attn_kernel=False),
        "swap kernel": dict(paged, n_blocks=9, preempt="swap"),
        "swap gather": dict(paged, n_blocks=9, preempt="swap", attn_kernel=False),
        "spec kernel": dict(paged, n_blocks=9, spec_k=SPEC_K),
        "spec gather": dict(paged, n_blocks=9, spec_k=SPEC_K, attn_kernel=False),
        "contiguous": dict(base),
    }
    outs, notes = {}, {}
    for name, skw in runs.items():
        draft = (dcfg, dparams) if "spec" in name else None
        eng, outs[name] = _engine_run(S, cfg, params, wl(), draft=draft, **skw)
        st = eng.stats()
        notes[name] = (st["swap_preemptions"], st["spec_accepted"], st["spec_proposed"])
        if "swap" in name and not st["swap_preemptions"]:
            raise AssertionError(f"reduced {name}: the pool never pressured")
    outs["lockstep"] = {r.rid: S.generate_reference(cfg, params, r.prompt, r.max_new_tokens,
                                                    max_seq=24, sampling=r.sampling)
                        for r in wl()}
    ref = outs["paged kernel"]
    for name, out in outs.items():
        for rid in ref:
            if not (out[rid].shape == ref[rid].shape and (out[rid] == ref[rid]).all()):
                raise AssertionError(f"reduced serve: {name} rid {rid} {out[rid].tolist()} != "
                                     f"paged kernel {ref[rid].tolist()}")
    print(f"[route] reduced serve, 6 sampled requests: {len(outs)} runs identical (paged "
          f"kernel/gather, swap, spec_k={SPEC_K} with a 1-layer drafter, contiguous, lock-step); "
          f"(swaps, accepted, proposed) {notes}; first stream {ref[0].tolist()}")


def _feature_runs(cfg, lm, pa, ops, S, params, dparams, tag):
    """The runs of :func:`serve_features_phase` at one precision of the
    params; returns (rid -> tokens per run, summaries, paged launches)."""
    reqs_kw = dict(n_requests=8, arrival_rate=0.5, prompt_len=128, gen_len=32, seed=0,
                   uniform_prompts=True, **SAMPLED)

    def wl():
        return S.poisson_workload(cfg, **reqs_kw)

    base = dict(max_slots=4, max_seq=160, prefill_chunk=32)
    paged = dict(base, block_size=16)
    dcfg = dataclasses.replace(cfg, n_layers=4)
    runs = {
        "sampled": (dict(paged), None),
        "swap": (dict(paged, n_blocks=24, preempt="swap"), None),
        "spec self": (dict(paged, spec_k=SPEC_K, decode_widths=(1, 4, SPEC_K + 1)), None),
        "spec 4-layer": (dict(paged, spec_k=SPEC_K, decode_widths=(1, 4, SPEC_K + 1)),
                         (dcfg, dparams)),
        "continuous": (dict(base), None),
    }
    real = ops.paged_attention
    widths: dict[int, int] = {}

    def recording(q, *a):  # the chunk widths the kernel is called at
        widths[q.shape[1]] = widths.get(q.shape[1], 0) + 1
        return real(q, *a)

    outs, summary, launches = {}, {}, 0
    for name, (skw, draft) in runs.items():
        widths.clear()
        ops.paged_attention = recording
        pa.launches = 0
        try:
            t0 = time.perf_counter()
            eng, outs[name] = _engine_run(S, cfg, params, wl(), draft=draft, **skw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.paged_attention = real
        n = pa.launches
        st = eng.stats()
        step_ms = [t * 1e3 for t in eng.step_times]
        summary[name] = dict(
            steps=st["compute_steps"], launches=n, widths=dict(sorted(widths.items())),
            preemptions=st["preemptions"], swaps=st["swap_preemptions"],
            swapped_bytes=st["swapped_bytes"], spec_proposed=st["spec_proposed"],
            spec_accepted=st["spec_accepted"], acceptance=st["acceptance_rate"],
            draft_steps=st["draft_steps"], tokens_per_s=st["tokens_per_s"],
            generated_per_s=st["generated_tokens"] / max(st["wall_s"], 1e-9),
            p50_ms=float(np.percentile(step_ms, 50)), p99_ms=float(np.percentile(step_ms, 99)),
            wall_s=wall,
        )
        if eng.serve_cfg.paged:
            if n != cfg.n_layers * st["compute_steps"]:
                raise AssertionError(f"{tag} {name}: kernel launches {n} != {cfg.n_layers} x "
                                     f"{st['compute_steps']} steps")
            launches += n
            _pages_back_and_zero(eng, f"{tag} {name}")
        elif n:
            raise AssertionError(f"{tag} {name}: the contiguous engine launched the paged kernel")
        if name == "swap" and not (st["swap_preemptions"] and st["swapped_bytes"]):
            raise AssertionError(f"{tag} swap run: no swap preemption {st}")
        if skw.get("spec_k"):
            if not st["spec_proposed"]:
                raise AssertionError(f"{tag} {name}: nothing proposed")
            if SPEC_K + 1 not in widths:
                raise AssertionError(f"{tag} {name}: no verify step at width {SPEC_K + 1}: {widths}")
        del eng
        torch.cuda.empty_cache()
        print(f"[serve-features] {tag} {name}: " + json.dumps(summary[name]))

    t0 = time.perf_counter()
    lock = {}
    for wave in S.lockstep_waves(wl(), base["max_slots"]):
        out = S.generate_lockstep(cfg, params, np.stack([r.prompt for r in wave]),
                                  [r.max_new_tokens for r in wave], max_seq=base["max_seq"],
                                  sampling=[r.sampling for r in wave])
        lock.update({r.rid: t for r, t in zip(wave, out["tokens"], strict=True)})
    outs["lockstep"] = lock
    summary["lockstep"] = dict(wall_s=time.perf_counter() - t0)

    ref = outs["sampled"]
    gen = np.stack([ref[r] for r in sorted(ref)])
    if gen.shape != (8, 32) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"{tag} sampled run: tokens {gen.shape} in {gen.min()}..{gen.max()}")
    for name, out in outs.items():
        if name != "sampled":
            other = np.stack([out[r] for r in sorted(ref)])
            summary[name]["share_equal"] = float((other == gen).mean())
    return outs, summary, launches


def serve_features_phase(cfg, lm, pa, ops, S, params):
    """The rest of serving at full width and depth (qwen2.5-3b, the serve
    phase's bf16 params, fp32 caches): 8 sampled requests (temperature
    0.8, top-k 50, top-p 0.95, a seed each; prompt 128, gen 32, 4 slots)
    through the paged engine; through a pool too small for them (swap
    preemption); speculating 4 tokens self-drafted and with a full-width
    4-layer drafter (random, so that it rejects); through the contiguous
    engine; and through the lock-step baseline. Checks every page back
    and zero, ``paged_attention`` launched once a layer a target step of
    each paged run, the verify steps at width 5 on the 16-row tile.

    Then the same runs with an exact fp32 copy of the params, and the
    share of tokens equal to the sampled paged run's. With bf16 params a
    step whose shapes or attention route differ rounds its bf16
    activations otherwise, 36 layers of random weights grow that into
    logits a few percent apart (``route_check``), and a sampled stream
    leaves the other at the first draw that flips: the bf16 shares are
    printed as measured. In fp32 the runs differ in summation order only,
    and every share must reach SHARE_MIN. Returns the launches of the
    paged runs, the summaries by precision and the verify step's plan."""
    dcfg = dataclasses.replace(cfg, n_layers=4)
    dparams = lm.init_params(dcfg, 1, "cuda")
    summaries, launches = {}, 0
    for tag in ("bfloat16", "float32"):
        p = params if tag == "bfloat16" else _cast(params, torch.float32)
        dp = dparams if tag == "bfloat16" else _cast(dparams, torch.float32)
        _, summaries[tag], n = _feature_runs(cfg, lm, pa, ops, S, p, dp, tag)
        launches += n
        del p, dp
        gc.collect()
        torch.cuda.empty_cache()
    del dparams
    plan = pa.paged_split_plan(4, SPEC_K + 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 10, 16)
    g = cfg.n_heads // cfg.n_kv_heads
    print(f"[serve-features] verify step (S={SPEC_K + 1}, {(SPEC_K + 1) * g} rows a KV head): "
          f"{plan.variant}")
    if plan.row_tile != 16:
        raise AssertionError(f"the verify step takes the {plan.row_tile}-row tile")
    shares = {tag: {k: v["share_equal"] for k, v in summ.items() if "share_equal" in v}
              for tag, summ in summaries.items()}
    print(f"[serve-features] tokens equal to the sampled paged run's: {json.dumps(shares)} "
          f"(float32 limit {SHARE_MIN})")
    low = {k: v for k, v in shares["float32"].items() if v < SHARE_MIN}
    if low:
        raise AssertionError(f"fp32 full-width runs part from the sampled one: {low}")
    return launches, summaries, plan


def step_profile(cfg, lm, params, dev="cuda", tag="[profile]", enc_out=None):
    """Where one step of the main path spends its time: a decode step
    (4 slots, 1 token each) and a mixed step (two prefill chunks of 32,
    two decodes) at 10 pages a slot through the kernel route (``enc_out``:
    the slots' encoder outputs, encdec). Host wall time per step over 5
    runs, then one profiled run: device busy time and the kernels that
    take most of it."""
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
                                        enc_out=enc_out, block_tables=tables, paged_kernel=True)
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
        print(f"{tag} {name} step (B={b} C={c} NB={nb}): host wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    return out


# ----------------------------------------------------------------------
# ssProp training: the four gathered kernels and the ResNet-18 path
# ----------------------------------------------------------------------


def train_policy(policy_mod):
    """The main path's sparse policy: ``tpu_default(0.8)`` with
    ``use_pallas`` (128-channel blocks, fused im2col)."""
    return dataclasses.replace(policy_mod.tpu_default(0.8), use_pallas=True)


def launch_table(routes, convs, policy, expect) -> dict:
    """``(kernel, geometry) -> launches`` in one sparse step, from a route
    table; ``convs`` yields ``(site, C_in, C_out, k, H_in, stride)`` and
    a geometry is ``(C_in, C_out, k, H_in, stride, KB)``. The stem's input
    needs no gradient: no dX kernel there. The counts must sum to
    ``expect``, the model's ``kernel_launches_per_step``."""
    kernels_of = {"fused": ("conv_dw_fused", "conv_dx_fused"),
                  "canonical": ("dw_gathered", "dx_gathered")}
    counts: dict = {}
    for site, c_in, c_out, k, h_in, stride in convs:
        geo = (c_in, c_out, k, h_in, stride, policy.keep_count(c_out))
        for name in kernels_of.get(routes[site], ()):
            if site == "stem" and name in ("dx_gathered", "conv_dx_fused"):
                continue
            counts[(name, geo)] = counts.get((name, geo), 0) + 1
    per_kernel = {n: sum(c for (k, _), c in counts.items() if k == n) for n in GATHERED}
    if per_kernel != expect:
        raise AssertionError(f"launch table {per_kernel} != kernel_launches_per_step {expect}")
    return counts


def main_path_launches(resnet, policy) -> dict:
    """:func:`launch_table` of one sparse ResNet-18 step."""
    strides = resnet.block_strides(RESNET)
    convs = []
    for site, c_in, c_out, k, h_out, _ in resnet.iter_conv_shapes(RESNET, TRAIN_IMAGE):
        if site == "stem" or site.endswith("conv2"):
            stride = 1
        else:
            stride = strides[int(site.split("/")[0].split("_")[1])]
        convs.append((site, c_in, c_out, k, h_out * stride, stride))
    return launch_table(resnet.backward_routes(RESNET, TRAIN_BATCH, TRAIN_IMAGE, policy), convs,
                        policy, resnet.kernel_launches_per_step(RESNET, TRAIN_BATCH, TRAIN_IMAGE,
                                                                policy))


def gathered_case(gm, ops, name, geo, dtype, gen, *, groups=1, blocks=None, bs=128,
                  batch=TRAIN_BATCH, dev="cuda"):
    """Inputs of one gathered-kernel launch at ``geo``, with random data
    and random sorted kept blocks (or ``blocks``). Returns the kernel and
    plain calls, their arguments, a library call that computes the same
    function on the kept real channels (its operands gathered here,
    untimed), and what the bound needs."""
    c_in, c_out, k, h_in, stride, kb = geo
    pad = (k - 1) // 2
    h_out = (h_in + 2 * pad - k) // stride + 1
    nb = -(-c_out // bs)
    if blocks is None:
        blocks = torch.randperm(nb, generator=gen, device=dev)[:kb].sort().values.tolist()
    bidx = torch.tensor(blocks, dtype=torch.int32, device=dev)
    real = torch.tensor([c for b in blocks for c in range(b * bs, min(b * bs + bs, c_out))],
                        device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    m, d = batch * h_out * h_out, c_in * k * k
    st, pd = (stride, stride), ((pad, pad), (pad, pad))
    if name in ("dx_gathered", "dw_gathered"):
        dy = rnd(m, c_out)
        dy_k = dy.index_select(1, real)
        if name == "dx_gathered":
            w = rnd(d, c_out)
            args, lib_args = (dy, w, bidx), (dy_k, w.index_select(1, real))
            lib = lambda a, b: a @ b.T  # noqa: E731
        else:
            x = rnd(m, d)
            args, lib_args = (x, dy, bidx), (x, dy_k)
            lib = lambda a, b: a.T @ b  # noqa: E731
        kw = dict(block_size=bs)
        plain_kw = kw
    else:
        x = rnd(batch, c_in, h_in, h_in)
        dy = rnd(batch, c_out, h_out, h_out)
        dy_k = dy.index_select(1, real).contiguous()
        dy2r = ops._dy_rows(dy, bs)
        if name == "conv_dw_fused":
            args = (ops._image_rows(x, pd, groups), dy2r, bidx)
            plain_kw = dict(kh_dim=k, kw_dim=k, stride=st, dilation=(1, 1), h_out=h_out,
                            block_size=bs)
            lib_args = (x, dy_k)
            lib = lambda a, b: torch.nn.grad.conv2d_weight(  # noqa: E731
                a, (b.shape[1], c_in // groups, k, k), b, st, pad, 1, groups)
        else:
            w = rnd(c_out, c_in // groups, k, k)
            args = (dy2r, ops._compact_filters(w, bidx, bs), bidx)
            plain_kw = dict(b=batch, hw=(h_in, h_in), padding=pd, groups=groups, stride=st,
                            dilation=(1, 1), block_size=bs)
            lib_args = (dy_k, w.index_select(0, real).contiguous())
            lib = lambda a, b: torch.nn.grad.conv2d_input(  # noqa: E731
                (batch, c_in, h_in, h_in), b, a, st, pad, 1, groups)
        kw = dict(plain_kw, c_out=c_out)
    splits = {  # the split-K of the tensor-core kernels' plans
        "dw_gathered": lambda: gm.dw_plan(m, d, kb, bs, c_out)[0],
        "conv_dw_fused": lambda: gm.conv_dw_plan(m, d // groups, kb, bs, c_out)[0],
    }
    return dict(
        kernel=lambda *a: getattr(gm, name)(*a, **kw),
        plain=lambda *a: getattr(gm, f"{name}_ref")(*a, **plain_kw),
        args=args, library=lib, lib_args=lib_args, blocks=blocks,
        dims=dict(m=m, d=d, k_real=len(real), kb=kb, bs=bs, c_in=c_in, h=h_in,
                  h_pad=h_in + 2 * pad, batch=batch, itemsize=args[0].element_size()),
        splits=splits[name]() if name in splits else None,
    )


def gathered_bound_ms(name, dims, flops_per_s=FP32_FLOPS, passes=1) -> tuple[float, str]:
    """Least time for the work: each input the function needs read once
    (the kept channels of dY and W only), each output written once in
    fp32; 2 flops a multiply-add over the real kept channels at the fp32
    FMA rate (the SIMT kernels compute in fp32 whatever the operand
    type), or ``passes`` products at another unit's rate (3xTF32: three
    TF32 products at the tensor cores' 495 TFLOP/s)."""
    m, d, kr, it = dims["m"], dims["d"], dims["k_real"], dims["itemsize"]
    compact = d * dims["kb"] * dims["bs"] * 4
    image = dims["batch"] * dims["h_pad"] ** 2 * dims["c_in"]  # the padded input xg
    interior = dims["batch"] * dims["h"] ** 2 * dims["c_in"]  # dX, the interior only
    nbytes = {
        "dx_gathered": (m * kr + d * kr) * it + m * d * 4,
        "dw_gathered": (m * d + m * kr) * it + compact,
        "conv_dw_fused": (image + m * kr) * it + compact,
        "conv_dx_fused": m * kr * it + d * dims["kb"] * dims["bs"] * it + interior * 4,
    }[name] + 4 * dims["kb"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, passes * 2 * m * d * kr / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check_close(name, out, ref, what) -> float:
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    limit = KERNEL_TOL * max(1.0, ref.abs().max().item())
    if not (out.dtype == torch.float32 and out.shape == ref.shape and err <= limit):
        raise AssertionError(f"{name} {what}: max|kernel - plain| {err} > {limit} "
                             f"({out.dtype}, {tuple(out.shape)} vs {tuple(ref.shape)})")
    return err


def kernel_rows(gm, ops, launches, gen, tag, *, bs=128, batch=TRAIN_BATCH):
    """Each ``(kernel, geometry)`` of a launch table against its plain
    version, fp32 and bf16, repeated bit for bit; times, the library call
    and the bounds at fp32. Returns the rows, the max abs error of each
    kernel and a sha256 of each kernel's outputs in launch order."""
    rows, max_err = [], dict.fromkeys(GATHERED, 0.0)
    digests = {name: hashlib.sha256() for name in GATHERED}
    for (name, geo), count in launches.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = gathered_case(gm, ops, name, geo, dtype, gen, bs=bs, batch=batch)
            out, ref = case["kernel"](*case["args"]), case["plain"](*case["args"])
            err = _check_close(name, out, ref, f"at {geo} {dtype}")
            max_err[name] = max(max_err[name], err)
            if not torch.equal(out, case["kernel"](*case["args"])):
                raise AssertionError(f"{name} at {geo} {dtype}: two launches differ")
            digests[name].update(out.cpu().numpy().tobytes())
            if dtype != torch.float32:
                continue
            sets = [case["args"], tuple(a.clone() for a in case["args"])]
            ms = gpu_time_ms(case["kernel"], sets, 20)
            plain_ms = gpu_time_ms(case["plain"], sets, 5)
            lib = case["lib_args"]
            library_ms = gpu_time_ms(case["library"], [lib, tuple(a.clone() for a in lib)], 20)
            # fp32 work on the tensor cores as three TF32 products: the
            # least time drops below the fp32 FMA bound, kept beside it
            fma_ms, _ = gathered_bound_ms(name, case["dims"])
            bound_ms, bound_by = gathered_bound_ms(name, case["dims"], TF32_FLOPS, passes=3)
            c_in, c_out, k, h_in, stride, kb = geo
            flops = 2 * case["dims"]["m"] * case["dims"]["d"] * case["dims"]["k_real"]
            row = dict(name=name, shape=f"B={batch} C_in={c_in} C_out={c_out} k={k} H={h_in} "
                       f"stride={stride} bs={bs} KB={kb} blocks={case['blocks']}",
                       launches_per_step=count, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_fp32_fma_ms=fma_ms, flops=flops, tflops=flops / ms / 1e9,
                       variant=TENSOR_CORE[name], splits=case["splits"])
            rows.append(row)
            print(f"{tag} " + json.dumps(row))
            del sets, case, out, ref
    return rows, max_err, {name: h.hexdigest()[:16] for name, h in digests.items()}


def step_sums(rows, tag) -> None:
    """Each kernel's time over one sparse step's launches, fp32, beside
    the library's and the bound."""
    for name in GATHERED:
        mine = [r for r in rows if r["name"] == name]
        step = sum(r["ms"] * r["launches_per_step"] for r in mine)
        lib = sum(r["library_ms"] * r["launches_per_step"] for r in mine)
        bound = sum(r["bound_ms"] * r["launches_per_step"] for r in mine)
        print(f"{tag} {name}: a sparse step's {sum(r['launches_per_step'] for r in mine)} "
              f"launches {step:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms")


def gathered_phase(gm, ops, resnet, policy_mod, paged_digest):
    """Every gathered kernel against its plain version at the main path's
    shapes (fp32 and bf16) and at the extra cases; timings and bounds at
    the fp32 main-path shapes. The digests line carries ``paged_digest``,
    the kernel phase's, too."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    launches = main_path_launches(resnet, train_policy(policy_mod))
    rows, max_err, digests = kernel_rows(gm, ops, launches, gen, "[gathered]")
    # the extra cases: KB=2 of 4 non-contiguous, groups=2; and exact zeros
    extra = [("dx_gathered", (256, 512, 1, 8, 2, 2), 1, [1, 3]),
             ("dw_gathered", (256, 512, 1, 8, 2, 2), 1, [1, 3]),
             ("conv_dw_fused", (512, 512, 3, 4, 1, 2), 1, [0, 2]),
             ("conv_dx_fused", (512, 512, 3, 4, 1, 2), 1, [0, 2]),
             ("conv_dw_fused", (256, 512, 3, 8, 1, 2), 2, [1, 2]),
             ("conv_dx_fused", (256, 512, 3, 8, 1, 2), 2, [1, 2]),
             ("conv_dw_fused", (128, 256, 3, 16, 2, 1), 2, [1]),
             ("conv_dx_fused", (128, 256, 3, 16, 2, 1), 2, [1])]
    for name, geo, groups, blocks in extra:
        for dtype in (torch.float32, torch.bfloat16):
            case = gathered_case(gm, ops, name, geo, dtype, gen, groups=groups, blocks=blocks)
            err = _check_close(name, case["kernel"](*case["args"]), case["plain"](*case["args"]),
                               f"at {geo} groups={groups} blocks={blocks} {dtype}")
            max_err[name] = max(max_err[name], err)
    print(f"[gathered] {len(launches)} main-path shapes and {len(extra)} extra cases, fp32 and "
          f"bf16: within {KERNEL_TOL} x max(1, max|plain|); max abs err {max_err}; "
          f"each repeats bit for bit")
    print("[gathered] output digests (sha256, fp32 and bf16 main-path launches; "
          "paged_attention: the kernel phase's cases): "
          + json.dumps({**digests, "paged_attention": paged_digest}))
    step_sums(rows, "[gathered]")
    x = torch.randn((TRAIN_BATCH, 256, 8, 8), generator=gen, device="cuda")
    dy = torch.randn((TRAIN_BATCH, 512, 8, 8), generator=gen, device="cuda")
    bidx = torch.tensor([1, 3], dtype=torch.int32, device="cuda")
    dropped = torch.cat([torch.arange(0, 128), torch.arange(256, 384)]).cuda()
    dw2 = ops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1),
                                    padding=((1, 1), (1, 1)), dilation=(1, 1), groups=1)
    dwg = ops.dw_gathered_scatter(x.permute(0, 2, 3, 1).reshape(-1, 256),
                                  dy.permute(0, 2, 3, 1).reshape(-1, 512), bidx, 512)
    torch.cuda.synchronize()
    if dw2[:, dropped].any() or dwg[:, dropped].any() or not dw2.any() or not dwg.any():
        raise AssertionError("dropped blocks are not exactly 0 after the scatter")
    print("[gathered] dropped blocks exactly 0 after the scatter (dw_gathered, conv_dw_fused)")
    return rows, max_err


def _named_leaves(tree, prefix=""):
    """(path, leaf) in the order of ``optim.adam.tree_leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def training_batch(pipeline, dev="cuda"):
    pipe = pipeline.ImagePipeline(
        pipeline.ImagePipelineConfig(TRAIN_IMAGE, 10, TRAIN_BATCH, seed=11), n_train=1024)
    b = pipe.batch_at(0)
    return torch.from_numpy(b["images"]).to(dev), torch.from_numpy(b["labels"]).long().to(dev)


def training_route_check(tc, resnet, backward, policy_mod, pipeline):
    """The loss and all parameter gradients of one sparse step (0.8) of
    the full-width ResNet-18 three ways: through the kernels, the gather
    route (the conv VJP on the kept filters) and the mask oracle. All
    fp32 with TF32 off, so the routes differ in summation order only."""
    params = resnet.init_params(RESNET, 0, 10, device="cuda")
    x, y = training_batch(pipeline)
    kern = train_policy(policy_mod)
    routes = {"kernels": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = {params["stem"]["w"].data_ptr(): "stem"}
    for bi, blk in enumerate(params["blocks"]):
        for key, site in (("conv1", "conv1"), ("conv2", "conv2"), ("down_conv", "down")):
            if key in blk:
                site_of[blk[key]["w"].data_ptr()] = f"block_{bi}/{site}"
    res = {}
    for name, pol in routes.items():
        with backward.record_selections() as log:
            loss, grads = tc.value_and_grad(RESNET, params, x, y, pol)
        torch.cuda.synchronize()
        kept = {site_of[p]: s.block_idx.tolist() for p, s in log}
        res[name] = (loss.item(), _named_leaves(grads), kept)
    for site in resnet.site_names(RESNET)[0]:
        print(f"[train-route] {site:15s} kept blocks: " + "  ".join(
            f"{name} {res[name][2][site]}" for name in routes))
    worst = {}
    for a, b in (("kernels", "gather"), ("kernels", "mask"), ("gather", "mask")):
        if res[a][0] != res[b][0]:
            raise AssertionError(f"loss {a} {res[a][0]} != {b} {res[b][0]}")
        flips = [s for s in res[a][2] if res[a][2][s] != res[b][2][s]]
        bad, top = [], 0.0
        for (path, ga), (_, gb) in zip(res[a][1], res[b][1], strict=True):
            n = gb.norm().item()
            rel = (ga - gb).norm().item() / n if n > 0 else ga.norm().item()
            top = max(top, rel)
            if rel > TRAIN_ROUTE_TOL:
                bad.append(f"{path} {rel:.3e}")
        worst[f"{a}_vs_{b}"] = top
        if flips or bad:
            raise AssertionError(f"{a} vs {b}: selection flipped at {flips}; leaves over "
                                 f"{TRAIN_ROUTE_TOL}: {bad}")
    print(f"[train-route] full width, B={TRAIN_BATCH}, one sparse step: loss {res['kernels'][0]:.6f} "
          f"on every route; {len(res['kernels'][1])} gradient leaves, worst relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {TRAIN_ROUTE_TOL})")
    return worst


def counted_cnn_run(tag, cli, argv, gm, pa, per_step, batch):
    """One counted run of a CNN training CLI: the launch counts set to 0
    just before ``cli.run`` and read just after. 8 epoch-bar steps (2, 3,
    6, 7 sparse) with finite losses, each gathered kernel launched
    ``per_step`` times a sparse step and no other kernel (``matmul``,
    ``paged_attention``). Prints the step times; returns the run's result,
    the launches and the dense and sparse step medians."""
    args = cli.build_parser().parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa_before = pa.launches
    for k in gm.launches:
        gm.launches[k] = 0
    t0 = time.perf_counter()
    out = cli.run(args)
    wall = time.perf_counter() - t0
    launches = dict(gm.launches)
    rec = out["modes"]["ssprop"]
    sparse = [i for i, r in enumerate(rec["rates"]) if r > 0]
    if sparse != [2, 3, 6, 7]:
        raise AssertionError(f"{tag} sparse steps {sparse}, expected [2, 3, 6, 7]")
    if not all(math.isfinite(v) for v in rec["losses"]):
        raise AssertionError(f"{tag} non-finite loss: {rec['losses']}")
    expect = {k: per_step.get(k, 0) * len(sparse) for k in gm.launches}  # matmul: none
    if launches != expect or out["launches"] != expect:
        raise AssertionError(f"{tag} kernel launches {launches} != route table x 4 {expect}")
    if pa.launches != pa_before:
        raise AssertionError(f"{tag} the training run launched paged_attention")
    ms = [t * 1e3 for t in rec["step_times"]]
    med = lambda v: (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2  # noqa: E731
    dense_ms = med(sorted(ms[i] for i in range(8) if i not in sparse))
    sparse_ms = med(sorted(ms[i] for i in sparse))
    print(f"{tag} 8 steps in {wall:.2f} s; losses {[round(v, 4) for v in rec['losses']]}")
    print(f"{tag} step ms {[round(v, 2) for v in ms]}; dense median {dense_ms:.2f} ms "
          f"({batch / dense_ms * 1e3:.0f} images/s), sparse median {sparse_ms:.2f} ms "
          f"({batch / sparse_ms * 1e3:.0f} images/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} = "
          f"{per_step} x 4")
    return out, launches, dict(dense_ms=dense_ms, sparse_ms=sparse_ms)


def training_phase(tc, gm, pa, resnet, policy_mod):
    """The port's training entry point, counted (:func:`counted_cnn_run`)."""
    argv = ["--model", RESNET, "--batch", str(TRAIN_BATCH), "--image-size", str(TRAIN_IMAGE[1]),
            "--classes", "10", "--steps", "8", "--steps-per-epoch", "2", "--drop-rate", "0.8",
            "--granularity", "block", "--block-size", "128", "--use-pallas", "--mode", "ssprop",
            "--device", "cuda"]
    per_step = resnet.kernel_launches_per_step(RESNET, TRAIN_BATCH, TRAIN_IMAGE,
                                               train_policy(policy_mod))
    out, launches, meds = counted_cnn_run(f"[train] {RESNET} B={TRAIN_BATCH} {TRAIN_IMAGE}:", tc,
                                          argv, gm, pa, per_step, TRAIN_BATCH)
    print(f"[train] eval acc {out['modes']['ssprop']['eval_acc']}")
    return launches, meds


def profile_step(tag, name, step, top=10):
    """Host wall of ``step`` (which waits for its work) over 3 runs after
    a warm-up, then one profiled run: device busy time, the number of
    kernels and the ``top`` device items. Returns (wall_ms, busy_ms, the
    profiler's device items)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag} {name} step: host wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms in "
          f"{sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return wall_ms, busy_ms, kernels


def train_profile(tc, resnet, policy_mod, pipeline, adam):
    """Where one dense and one sparse training step spend their time
    (:func:`profile_step`)."""
    x, y = training_batch(pipeline)
    ocfg = adam.AdamConfig()
    out = {}
    for name, pol in (("dense", policy_mod.SsPropPolicy(0.0)), ("sparse", train_policy(policy_mod))):
        params = resnet.init_params(RESNET, 0, 10, device="cuda")
        opt = adam.init(params)

        def step():
            _, _, loss = tc.train_step(RESNET, params, opt, x, y, pol, ocfg)
            return loss.item()  # waits for the step

        wall_ms, busy_ms, _ = profile_step("[train-profile]", name, step)
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    return out


# ----------------------------------------------------------------------
# ssProp generation: the DDPM UNet through the four gathered kernels
# ----------------------------------------------------------------------


def ddpm_policy(policy_mod):
    """The DDPM path's sparse policy: ``tpu_default(0.8)`` with
    ``use_pallas`` at 32-channel blocks (at 128 every UNet site is one
    block and a sparse step keeps everything)."""
    return dataclasses.replace(policy_mod.tpu_default(0.8), block_size=DDPM_BS,
                               use_pallas=True)


def ddpm_path_launches(ddpm, policy) -> dict:
    """:func:`launch_table` of one sparse DDPM step (every UNet conv has
    stride 1)."""
    convs = [(site, c_in, c_out, k, h, 1)
             for site, c_in, c_out, k, h, _ in ddpm.iter_conv_shapes(DDPM_IMAGE, DDPM_BASE)]
    return launch_table(ddpm.backward_routes(DDPM_BATCH, DDPM_IMAGE, policy, DDPM_BASE), convs,
                        policy, ddpm.kernel_launches_per_step(DDPM_BATCH, DDPM_IMAGE, policy,
                                                              DDPM_BASE))


def ddpm_gathered_phase(gm, ops, ddpm, policy_mod):
    """Every gathered kernel against its plain version at every shape a
    sparse DDPM step (B=128, 3x64x64, base 64, block 32) launches it with,
    fp32 and bf16, each repeated bit for bit; times and bounds at the fp32
    shapes; exact zeros after the scatter; the 3-channel head's phantom
    channels never read by ``conv_dx_fused``."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    launches = ddpm_path_launches(ddpm, ddpm_policy(policy_mod))
    rows, max_err, digests = kernel_rows(gm, ops, launches, gen, "[ddpm-gathered]", bs=DDPM_BS,
                                         batch=DDPM_BATCH)
    print(f"[ddpm-gathered] {len(launches)} DDPM shapes, fp32 and bf16: within {KERNEL_TOL} x "
          f"max(1, max|plain|); max abs err {max_err}; each repeats bit for bit")
    print("[ddpm-gathered] output digests (sha256, fp32 and bf16): " + json.dumps(digests))
    step_sums(rows, "[ddpm-gathered]")

    # the longest reduction (up1/conv1: 524288 rows) against float64: the
    # kernel's split-K chunks are capped so its error stays near the plain
    # version's (tools/dw_split_error.py sweeps the cap)
    x = torch.randn((DDPM_BATCH, 128, 64, 64), generator=gen, device="cuda")
    dy = torch.randn((DDPM_BATCH, 64, 64, 64), generator=gen, device="cuda")
    bidx = torch.tensor([1], dtype=torch.int32, device="cuda")
    ref = torch.nn.grad.conv2d_weight(x.double(), (64, 128, 3, 3), dy.double(), 1, 1)[32:]
    ref = ref.permute(1, 2, 3, 0).reshape(128 * 9, 32)
    kern = ops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1), padding=((1, 1),) * 2,
                                     dilation=(1, 1), groups=1, block_size=DDPM_BS)[:, 32:]
    plain = torch.nn.grad.conv2d_weight(x, (64, 128, 3, 3), dy, 1, 1)[32:]
    plain = plain.permute(1, 2, 3, 0).reshape(128 * 9, 32)
    errs = [(t.double() - ref).abs().max().item() for t in (kern, plain)]
    print(f"[ddpm-gathered] conv_dw_fused at up1/conv1 against float64: kernel err {errs[0]:.4g} "
          f"(plan {gm.conv_dw_plan(DDPM_BATCH * 64 * 64, 1152, 1, DDPM_BS, 64)}), cuDNN fp32 err "
          f"{errs[1]:.4g}, gate {KERNEL_TOL * ref.abs().max().item():.4g}")
    del x, dy, ref, kern, plain

    # exact zeros after the scatter: 1 of 4 blocks at 128 channels, the
    # 3-channel head (its one ragged block kept), 1 of 2 at the 1x1 up1/skip
    pads = ((1, 1), (1, 1))
    for c_in, c_out, h, blocks in ((128, 128, 16, [2]), (64, 3, 64, [0])):
        x = torch.randn((DDPM_BATCH, c_in, h, h), generator=gen, device="cuda")
        dy = torch.randn((DDPM_BATCH, c_out, h, h), generator=gen, device="cuda")
        bidx = torch.tensor(blocks, dtype=torch.int32, device="cuda")
        dw2 = ops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1), padding=pads,
                                        dilation=(1, 1), groups=1, block_size=DDPM_BS)
        kept = [c for b in blocks for c in range(b * DDPM_BS, min((b + 1) * DDPM_BS, c_out))]
        dropped = sorted(set(range(c_out)) - set(kept))
        torch.cuda.synchronize()
        if dw2.shape != (c_in * 9, c_out) or dw2[:, dropped].any() or not dw2[:, kept].all():
            raise AssertionError(f"conv_dw_fused_scatter at C_out={c_out}: dropped blocks not 0")
    x = torch.randn((DDPM_BATCH * 64 * 64, 128), generator=gen, device="cuda")
    dy = torch.randn((DDPM_BATCH * 64 * 64, 64), generator=gen, device="cuda")
    bidx = torch.tensor([1], dtype=torch.int32, device="cuda")
    dwg = ops.dw_gathered_scatter(x, dy, bidx, 64, block_size=DDPM_BS)
    torch.cuda.synchronize()
    if dwg[:, :DDPM_BS].any() or not dwg[:, DDPM_BS:].all():
        raise AssertionError("dw_gathered_scatter at up1/skip: dropped block not exactly 0")
    # the head: NaN in the phantom channels 3..31 of dY and the filters
    # leaves conv_dx_fused's output bit for bit as it is with zeros there
    dy2r = torch.zeros((DDPM_BATCH * 64, 64, DDPM_BS), device="cuda")
    dy2r[..., :3] = torch.randn((DDPM_BATCH * 64, 64, 3), generator=gen, device="cuda")
    w2k = torch.zeros((3, 3, 64, DDPM_BS), device="cuda")
    w2k[..., :3] = torch.randn((3, 3, 64, 3), generator=gen, device="cuda")
    bidx = torch.tensor([0], dtype=torch.int32, device="cuda")
    kw = dict(b=DDPM_BATCH, hw=(64, 64), padding=pads, groups=1, stride=(1, 1),
              dilation=(1, 1), block_size=DDPM_BS, c_out=3)
    clean = gm.conv_dx_fused(dy2r, w2k, bidx, **kw)
    dy2r[..., 3:], w2k[..., 3:] = float("nan"), float("nan")
    poisoned = gm.conv_dx_fused(dy2r, w2k, bidx, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(clean).all() and torch.equal(clean, poisoned)):
        raise AssertionError("conv_dx_fused read a phantom channel of the 3-channel head")
    print("[ddpm-gathered] dropped blocks exactly 0 after the scatter (conv_dw_fused 1 of 4 at "
          "128 ch. and the 3-channel head; dw_gathered 1 of 2 at up1/skip); conv_dx_fused's "
          "output unchanged bit for bit with NaN in the head's phantom channels 3..31")
    return rows, max_err


def _ddpm_sites(params, ddpm):
    """weight data_ptr -> DDPM conv site name."""
    out = {}
    for site in ddpm.site_names(DDPM_BASE)[0]:
        node = params
        for part in site.split("/"):
            node = node[part]
        out[node["w"].data_ptr()] = site
    return out


def _ddpm_batch(ddpm, pipeline, step=0, dev="cuda"):
    pipe = pipeline.ImagePipeline(
        pipeline.ImagePipelineConfig(DDPM_IMAGE, 10, DDPM_BATCH, seed=11), n_train=1024)
    x0 = torch.from_numpy(pipe.batch_at(step)["images"]).to(dev)
    t, noise = ddpm.draw_t_noise(torch.Generator(device=dev).manual_seed(1), x0, DDPM_T)
    return x0, t, noise


def ddpm_route_check(td, ddpm, backward, policy_mod, pipeline):
    """The loss and all parameter gradients, biases included, of one
    sparse step of the full-width DDPM UNet (base 64, t_dim 256, B=128,
    3x64x64) three ways: through the kernels, the gather route and the
    mask oracle, with the kept blocks of each site printed. fp32 with TF32
    off, so the routes differ in summation order only."""
    params = ddpm.init_params(0, channels=DDPM_IMAGE[0], base=DDPM_BASE, t_dim=DDPM_TDIM,
                              device="cuda")
    sched = ddpm.make_schedule(DDPM_T, device="cuda")
    x0, t, noise = _ddpm_batch(ddpm, pipeline)
    kern = ddpm_policy(policy_mod)
    routes = {"kernels": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = _ddpm_sites(params, ddpm)
    res = {}
    for name, pol in routes.items():
        with backward.record_selections() as log:
            loss, grads = td.value_and_grad(params, sched, x0, t, noise, pol)
        torch.cuda.synchronize()
        kept = {site_of[p]: s.block_idx.tolist() for p, s in log}
        res[name] = (loss.item(), _named_leaves(grads), kept)
        del grads
    sites = ddpm.site_names(DDPM_BASE)[0]
    nblocks = {s: -(-co // DDPM_BS) for s, _, co, *_ in ddpm.iter_conv_shapes(DDPM_IMAGE, DDPM_BASE)}
    for site in sites:
        k = res["kernels"][2][site]
        print(f"[ddpm-route] {site:12s} kept {len(k)}/{nblocks[site]} blocks: " + "  ".join(
            f"{name} {res[name][2][site]}" for name in routes))
    worst = {}
    for a, b in (("kernels", "gather"), ("kernels", "mask"), ("gather", "mask")):
        if res[a][0] != res[b][0]:
            raise AssertionError(f"DDPM loss {a} {res[a][0]} != {b} {res[b][0]}")
        if sorted(res[a][2]) != sorted(sites):
            raise AssertionError(f"route {a} did not select at every DDPM site")
        flips = [s for s in sites if res[a][2][s] != res[b][2][s]]
        bad, top, top_path = [], 0.0, ""
        for (path, ga), (_, gb) in zip(res[a][1], res[b][1], strict=True):
            n = gb.norm().item()
            rel = (ga - gb).norm().item() / n if n > 0 else ga.norm().item()
            if rel >= top:
                top, top_path = rel, path
            if rel > TRAIN_ROUTE_TOL:
                bad.append(f"{path} {rel:.3e}")
        worst[f"{a}_vs_{b}"] = (top, top_path)
        if flips or bad:
            raise AssertionError(f"DDPM {a} vs {b}: selection flipped at {flips}; leaves over "
                                 f"{TRAIN_ROUTE_TOL}: {bad}")
    print(f"[ddpm-route] full width (base {DDPM_BASE}, t_dim {DDPM_TDIM}), B={DDPM_BATCH} "
          f"{DDPM_IMAGE}, block {DDPM_BS}, one sparse step: the same kept blocks at all "
          f"{len(sites)} sites; loss {res['kernels'][0]:.6f} on every route; "
          f"{len(res['kernels'][1])} gradient leaves (biases included), worst relative L2 "
          + ", ".join(f"{k} {v[0]:.3e} ({v[1]})" for k, v in worst.items())
          + f" (limit {TRAIN_ROUTE_TOL})")
    del params
    return {k: v[0] for k, v in worst.items()}


def ddpm_training_phase(td, gm, pa, ddpm, policy_mod):
    """The port's generation entry point, counted (:func:`counted_cnn_run`):
    8 epoch-bar steps at the paper's CelebA task, then 4 samples over the
    whole schedule, which must be finite; and the backward-FLOPs ledger."""
    import numpy as np

    argv = ["--batch", str(DDPM_BATCH), "--size", str(DDPM_IMAGE[1]), "--channels",
            str(DDPM_IMAGE[0]), "--timesteps", str(DDPM_T), "--base", str(DDPM_BASE), "--t-dim",
            str(DDPM_TDIM), "--steps", "8", "--steps-per-epoch", "2", "--granularity", "block",
            "--block-size", str(DDPM_BS), "--use-pallas", "--mode", "ssprop", "--out", "",
            "--device", "cuda"]
    pol = ddpm_policy(policy_mod)
    if td.step_policy(td.build_parser().parse_args(argv), 0.8) != pol:
        raise AssertionError(f"the DDPM CLI's sparse policy is not {pol}")
    per_step = ddpm.kernel_launches_per_step(DDPM_BATCH, DDPM_IMAGE, pol, DDPM_BASE)
    out, launches, meds = counted_cnn_run(
        f"[ddpm-train] base {DDPM_BASE} B={DDPM_BATCH} {DDPM_IMAGE} T={DDPM_T}:", td, argv, gm,
        pa, per_step, DDPM_BATCH)
    s = out["samples"]
    if s.shape != (4, *DDPM_IMAGE) or not np.isfinite(s).all():
        raise AssertionError(f"DDPM samples {s.shape}, finite {np.isfinite(s).all()}")
    print(f"[ddpm-train] sampling {DDPM_T} steps of 4 images: {out['sample_s']:.2f} s, range "
          f"[{float(s.min()):.3f}, {float(s.max()):.3f}], all finite")
    led = out["flops"]
    at128 = ddpm.flops_per_iter(DDPM_BATCH, DDPM_IMAGE, DDPM_BASE,
                                policy=dataclasses.replace(pol, block_size=128))[1]
    save = lambda f: 100 * (1 - f / led["dense"])  # noqa: E731
    print(f"[ddpm-flops] backward FLOPs/iter (the paper's Eq. 6-9, ddpm.flops_per_iter): dense "
          f"{led['dense']}, nominal at the schedule-average rate {led['avg_rate']} "
          f"{led['nominal']} ({save(led['nominal']):.2f}% saved); a sparse step at block "
          f"{DDPM_BS} {led['policy']} ({save(led['policy']):.2f}% saved) beside block 128 "
          f"{at128} ({save(at128):.2f}% saved)")
    return launches, {**meds, "sample_s": out["sample_s"]}


def ddpm_profile(td, ddpm, policy_mod, pipeline, adam):
    """Where one dense and one sparse DDPM training step spend their time
    (:func:`profile_step`)."""
    sched = ddpm.make_schedule(DDPM_T, device="cuda")
    x0, t, noise = _ddpm_batch(ddpm, pipeline)
    ocfg = adam.adamw()
    out = {}
    for name, pol in (("dense", policy_mod.SsPropPolicy(0.0)), ("sparse", ddpm_policy(policy_mod))):
        params = ddpm.init_params(0, channels=DDPM_IMAGE[0], base=DDPM_BASE, t_dim=DDPM_TDIM,
                                  device="cuda")
        opt = adam.init(params)

        def step():
            _, _, loss = td.train_step(params, opt, sched, x0, t, noise, pol, ocfg)
            return loss.item()  # waits for the step

        wall_ms, busy_ms, _ = profile_step("[ddpm-profile]", name, step)
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
        del params, opt
    return out


# ----------------------------------------------------------------------
# ssProp LM training: matmul, importance and the qwen2.5-3b path
# ----------------------------------------------------------------------


def lm_policy(policy_mod):
    """The LM path's sparse policy: ``paper_default(0.8)`` (channel
    top-k) with ``use_pallas``."""
    return dataclasses.replace(policy_mod.paper_default(LM_RATE), use_pallas=True)


def lm_products(lm, cfg, policy, batch=LM_BATCH, seq=LM_SEQ):
    """``(name, A shape, B shape, A transposed, B transposed, launches a
    sparse step)`` of every ``matmul`` product of a sparse step of
    ``batch`` x ``seq`` tokens, as the backward hands them over: dX =
    dy_k @ w_k.T, dW = x2.T @ dy_k, one of each a site, sites of one
    shape together. A site's rows are the tokens its input holds: the
    encoder's sites and the cross-attention's K/V take ``enc_seq`` frames
    a sequence, a vlm's sites the patch prefix and the text."""
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dims = {"q": (d, h * hd), "k": (d, kv * hd), "v": (d, kv * hd), "o": (h * hd, d),
            "up": (d, cfg.d_ff), "gate": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
    groups: dict[tuple, list] = {}  # (rows, d_in, d_out) -> [site kinds, sites]
    for site in lm.site_names(cfg)[0]:
        parts = site.split("/")
        enc = parts[0] == "enc"
        kind = "/".join(parts[2:] if enc else parts[1:])
        proj = parts[-1]
        if enc or (parts[-2] == "cross" and proj in ("k", "v")):
            rows = batch * cfg.enc_seq
        else:
            rows = batch * (seq + (cfg.n_patches if cfg.family == "vlm" else 0))
        g = groups.setdefault((rows, *dims[proj]), [[], 0])
        kind = f"enc {kind}" if enc else kind
        if kind not in g[0]:
            g[0].append(kind)
        g[1] += 1
    out = []
    for (m, d_in, d_out), (kinds, n) in groups.items():
        k = policy.keep_count(d_out)
        name = ", ".join(kinds)
        out.append((f"dX {name}", (m, k), (k, d_in), False, True, n))
        out.append((f"dW {name}", (d_in, m), (m, k), True, False, n))
    return out


def _rotations(nbytes: int) -> int:
    """Argument sets to cycle through so that the 50 MB L2 cannot hold
    the next call's inputs."""
    return max(2, min(64, math.ceil(3 * L2_BYTES / max(nbytes, 1))))


def importance_library(dy):
    """One library call for ``importance``'s function: the column L1 norm
    accumulated in fp32, over the rows."""
    return torch.linalg.vector_norm(dy, 1, dim=0, dtype=torch.float32) / dy.shape[0]


def lm_kernel_phase(gm, lm, cfg, policy, batch=LM_BATCH, seq=LM_SEQ, tag="[lm-kernels]"):
    """``matmul`` against its plain version at every shape of a sparse
    training step of ``cfg`` (``batch`` x ``seq`` tokens), bf16 and fp32,
    and on the LM path ``importance`` too; times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, max_err = [], dict.fromkeys(LM_KERNELS, 0.0)
    products = lm_products(lm, cfg, policy, batch, seq)
    expect = lm.kernel_launches_per_step(cfg, policy)["matmul"]
    if sum(p[-1] for p in products) != expect:
        raise AssertionError(f"product table {products} != launch table {expect}")
    def stored(shape, dtype):
        """A row-major buffer as the backward makes it: x2 contiguous; dy_k
        and w_k gathered at a pitch of a multiple of 8 (``gather_columns``)."""
        r, c = shape
        return torch.randn((r, c + (-c) % 8), generator=gen, device="cuda").to(dtype)[:, :c]

    repacks = gm.repacks["matmul"]
    for name, a_shape, b_shape, a_t, b_t, per_step in products:
        for dtype in (torch.bfloat16, torch.float32):
            def operands(a_shape=a_shape, b_shape=b_shape, a_t=a_t, b_t=b_t, dtype=dtype):
                a = stored(a_shape[::-1] if a_t else a_shape, dtype)
                b = stored(b_shape[::-1] if b_t else b_shape, dtype)
                return (a.T if a_t else a, b.T if b_t else b)

            args = operands()
            out, ref = gm.matmul(*args), gm.matmul_ref(*args)
            err = _check_close("matmul", out, ref, f"{name} {a_shape}x{b_shape} {dtype}")
            max_err["matmul"] = max(max_err["matmul"], err)
            (m, k), n = a_shape, b_shape[1]
            it = args[0].element_size()
            nbytes = (m * k + k * n) * it + m * n * 4
            sets = [args] + [operands() for _ in range(_rotations(nbytes) - 1)]
            ms = gpu_time_ms(gm.matmul, sets, 20)
            plain_ms = gpu_time_ms(gm.matmul_ref, sets, 5)
            library_ms = gpu_time_ms(torch.matmul, sets, 20)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 2 * m * n * k / (BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            bf16 = dtype == torch.bfloat16
            variant = "wgmma+TMA 128x128, split-K" if bf16 else "simt fp32 FMA 64x64"
            row = dict(name="matmul", arch=cfg.name, product=name,
                       shape=f"A[{m},{k}]{'T' if a_t else ''} @ "
                       f"B[{k},{n}]{'T' if b_t else ''}", dtype=str(dtype).replace("torch.", ""),
                       variant=variant, splits=gm.matmul_plan(m, n, k)[0] if bf16 else 1,
                       launches_per_step=per_step, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       flops=2 * m * n * k, tflops=2 * m * n * k / ms / 1e9)
            rows.append(row)
            print(f"{tag} " + json.dumps(row))
            del sets, args, out, ref
    for n in (cfg.d_model, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff) if cfg.name == LM_ARCH else ():
        for dtype in (torch.bfloat16, torch.float32):
            m = LM_BATCH * LM_SEQ
            dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
            out = gm.importance(dy)
            err = _check_close("importance", out, gm.importance_ref(dy), f"[{m}, {n}] {dtype}")
            if not torch.equal(out, gm.importance(dy)):
                raise AssertionError("importance does not repeat exactly")
            max_err["importance"] = max(max_err["importance"], err)
            nbytes = m * n * dy.element_size() + n * 4
            sets = [(dy,)] + [(torch.randn((m, n), generator=gen, device="cuda").to(dtype),)
                              for _ in range(_rotations(nbytes) - 1)]
            ms = gpu_time_ms(gm.importance, sets, 50)
            plain_ms = gpu_time_ms(gm.importance_ref, sets, 20)
            library_ms = gpu_time_ms(importance_library, sets, 50)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n / FP32_FLOPS
            row = dict(name="importance", shape=f"dY[{m},{n}]", dtype=str(dtype).replace(
                "torch.", ""), launches_per_step=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations", flops=2 * m * n)
            rows.append(row)
            print("[lm-kernels] " + json.dumps(row))
            del sets, dy
    if gm.repacks["matmul"] != repacks:
        raise AssertionError(f"matmul repacked {gm.repacks['matmul'] - repacks} operands laid "
                             "out as the backward lays them out")
    print(f"{tag} {cfg.name} B={batch} S={seq}: matmul at {len(products)} products"
          f"{' and importance at 3 shapes' if cfg.name == LM_ARCH else ''}, bf16 and fp32: "
          f"within {KERNEL_TOL} x max(1, max|plain|); max abs err {max_err}; no operand repacked")
    return rows, max_err


def _lm_batch(pipeline, cfg, step=0, dev="cuda"):
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(cfg.vocab, LM_SEQ, LM_BATCH, 0))
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}


def lm_route_check(lm, steps, backward, policy_mod, pipeline, cfg):
    """The loss and all parameter gradients of one sparse step of
    qwen2.5-3b at full width and depth ``LM_ROUTE_DEPTH`` three ways:
    through ``matmul``, the gather route and the mask oracle. fp32 with
    TF32 off, so the routes differ in summation order only."""
    cfg = dataclasses.replace(cfg, n_layers=LM_ROUTE_DEPTH, dtype="float32")
    params = lm.init_params(cfg, 0, device="cuda")
    batch = _lm_batch(pipeline, cfg)
    kern = lm_policy(policy_mod)
    routes = {"matmul": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = {layer[r][p]["w"].data_ptr(): f"layer_{li}/{r}/{p}"
               for li, layer in enumerate(params["stack"]["layers"])
               for r, projs in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))) for p in projs}
    res = {}
    for name, pol in routes.items():
        with backward.record_selections() as log:
            (loss, _), grads = steps.value_and_grad(
                lambda p, pol=pol: lm.loss_fn(cfg, p, batch, pol), params)
        torch.cuda.synchronize()
        kept = {site_of[p]: s.idx for p, s in log}
        res[name] = (loss.item(), _named_leaves(grads), kept)
        del grads
    sites = lm.site_names(cfg)[0]
    if any(sorted(r[2]) != sorted(sites) for r in res.values()):
        raise AssertionError("a route did not select at every site")
    worst = {}
    for a, b in (("matmul", "gather"), ("matmul", "mask"), ("gather", "mask")):
        if res[a][0] != res[b][0]:
            raise AssertionError(f"loss {a} {res[a][0]} != {b} {res[b][0]}")
        flips = [s for s in sites if not torch.equal(res[a][2][s], res[b][2][s])]
        bad, top = [], 0.0
        for (path, ga), (_, gb) in zip(res[a][1], res[b][1], strict=True):
            n = gb.float().norm().item()
            rel = (ga.float() - gb.float()).norm().item() / n if n > 0 else ga.norm().item()
            top = max(top, rel)
            if rel > TRAIN_ROUTE_TOL:
                bad.append(f"{path} {rel:.3e}")
        worst[f"{a}_vs_{b}"] = top
        if flips or bad:
            raise AssertionError(f"{a} vs {b}: selection differs at {flips}; leaves over "
                                 f"{TRAIN_ROUTE_TOL}: {bad}")
    kept = {s: res["matmul"][2][s].numel() for s in sites[:7]}
    print(f"[lm-route] {LM_ARCH} full width, depth {LM_ROUTE_DEPTH}, B={LM_BATCH} S={LM_SEQ}, "
          f"fp32, one sparse step: the same kept channels at all {len(sites)} sites (kept a "
          f"layer: {kept}); loss {res['matmul'][0]:.6f} on every route; "
          f"{len(res['matmul'][1])} gradient leaves, worst relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {TRAIN_ROUTE_TOL})")
    return worst


def lm_training_phase(train, lm, gm, pa, policy_mod, cfg):
    """The port's LM entry point, counted: 8 epoch-bar steps at full
    width and depth."""
    argv = ["--arch", LM_ARCH, "--steps", "8", "--steps-per-epoch", "2", "--global-batch",
            str(LM_BATCH), "--seq-len", str(LM_SEQ), "--drop-rate", str(LM_RATE),
            "--granularity", "channel", "--use-pallas", "--log-every", "1", "--device", "cuda"]
    args = train.build_parser().parse_args(argv)
    per_step = lm.kernel_launches_per_step(cfg, lm_policy(policy_mod))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa_before = pa.launches
    for k in gm.launches:
        gm.launches[k] = 0
    gm.repacks["matmul"] = 0
    t0 = time.perf_counter()
    out = train.run(args)
    wall = time.perf_counter() - t0
    launches = dict(gm.launches)
    if gm.repacks["matmul"] != 0:
        raise AssertionError(f"the LM path repacked {gm.repacks['matmul']} matmul operands")
    sparse = [i for i, r in enumerate(out["rates"]) if r > 0]
    if sparse != [2, 3, 6, 7]:
        raise AssertionError(f"sparse steps {sparse}, expected [2, 3, 6, 7]")
    if not all(math.isfinite(v) for v in out["history"]):
        raise AssertionError(f"non-finite loss: {out['history']}")
    expect = dict.fromkeys(gm.launches, 0)
    expect["matmul"] = per_step["matmul"] * len(sparse)
    if launches != expect or out["launches"] != expect or per_step["matmul"] != 504:
        raise AssertionError(f"kernel launches {launches} != launch table x 4 {expect}")
    if pa.launches != pa_before:
        raise AssertionError("the LM training phase launched paged_attention")
    ms = [t * 1e3 for t in out["step_times"]]
    dense_ms = sorted(ms[i] for i in range(8) if i not in sparse)
    sparse_ms = sorted(ms[i] for i in sparse)
    med = lambda v: (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2  # noqa: E731
    tokens = LM_BATCH * LM_SEQ
    print(f"[lm-train] {LM_ARCH} full width and depth, bf16, B={LM_BATCH} S={LM_SEQ}: 8 steps "
          f"in {wall:.2f} s; losses {[round(v, 4) for v in out['history']]}")
    print(f"[lm-train] step ms {[round(v, 2) for v in ms]}; dense median {med(dense_ms):.2f} ms "
          f"({tokens / med(dense_ms) * 1e3:.0f} tokens/s), sparse median {med(sparse_ms):.2f} ms "
          f"({tokens / med(sparse_ms) * 1e3:.0f} tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; matmul launches "
          f"{launches['matmul']} = {per_step['matmul']} x {len(sparse)}, 0 operands repacked")
    return launches, dict(dense_ms=med(dense_ms), sparse_ms=med(sparse_ms))


def lm_profile(lm, steps, adam, policy_mod, pipeline, cfg):
    """Where one dense and one sparse LM training step spend their time
    (:func:`profile_step`), and which ``matmul`` variant ran."""
    batch = _lm_batch(pipeline, cfg)
    params = lm.init_params(cfg, 0, device="cuda")
    opt = adam.init(params)
    ocfg = adam.AdamConfig(lr=2e-4, clip_norm=1.0)
    out = {}
    for name, pol in (("dense", policy_mod.DENSE), ("sparse", lm_policy(policy_mod))):
        fn = steps.make_train_step(cfg, pol, ocfg)

        def step():
            _, _, m = fn(params, opt, batch)  # in place
            return m["loss"].item()  # waits for the step

        wall_ms, busy_ms, kernels = profile_step("[lm-profile]", name, step)
        variants = {v: [e for e in kernels if f"matmul_{v}_kernel" in e.key]
                    for v in ("wgmma", "simt")}
        count = {v: sum(e.count for e in es) for v, es in variants.items()}
        ms = {v: sum(e.self_device_time_total for e in es) / 1e3 for v, es in variants.items()}
        want = {"wgmma": 504 if name == "sparse" else 0, "simt": 0}
        if count != want:
            raise AssertionError(f"{name} step: matmul launches by variant {count} != {want}")
        print(f"[lm-profile]   matmul by variant: wgmma {count['wgmma']} launches "
              f"{ms['wgmma']:.3f} ms, simt {count['simt']} launches")
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms, matmul_ms=ms["wgmma"])
    del params, opt
    return out


# ----------------------------------------------------------------------
# the decoder-only families: mamba2 training and serving, kimi-k2
# serving, the reduced configs of the seven new archs
# ----------------------------------------------------------------------

SSM_ARCH, SSM_BATCH, SSM_SEQ = "mamba2-1.3b", 4, 512  # two 256-token SSD chunks
MOE_ARCH, MOE_DEPTH = "kimi-k2-1t-a32b", 1  # full width; 61 layers cut to 1
NEW_ARCHS = ("nemotron-4-15b", "deepseek-67b", "mistral-large-123b",
             "llama4-maverick-400b-a17b", "kimi-k2-1t-a32b", "mamba2-1.3b",
             "jamba-1.5-large-398b")
EXPERT_SITES = ("moe/gate", "moe/up", "moe/down")


def _median(v):
    v = sorted(v)
    return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2


def _site_of(params, cfg):
    """Weight pointer -> (site, expert or None) of every sparse site (the
    encoder's ``enc/layer_{i}/...`` and the cross-decoder's too)."""
    out = {}
    stacks = ([("", params["stack"]["layers"])] if "stack" in params else
              [("enc/", params["encoder"]["layers"]), ("", params["decoder"]["layers"])])
    for prefix, li, layer in [(x, i, t) for x, ts in stacks for i, t in enumerate(ts)]:
        for role in ("attn", "mlp", "ssm", "moe", "self", "cross"):
            for name, p in layer.get(role, {}).items():
                site = f"{prefix}layer_{li}/{role}/{name}"
                if role == "moe" and name in ("gate", "up", "down"):
                    for e in range(cfg.n_experts):
                        out[p[e].data_ptr()] = (site, e)
                elif role == "moe" and name == "shared":
                    for proj, w in p.items():
                        out[w["w"].data_ptr()] = (f"{site}/{proj}", None)
                elif isinstance(p, dict) and "w" in p:
                    out[p["w"].data_ptr()] = (site, None)
    return out


def _stub_inputs(cfg, batch, seed=0):
    """The stubbed frontends' inputs of a training batch, standard normal
    from ``seed`` (numpy): an encdec model's ``frames [B, enc_seq, d]``,
    a vlm's ``patches [B, n_patches, d]``; nothing for the others."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        shape, key = (batch, cfg.enc_seq, cfg.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (batch, cfg.n_patches, cfg.d_model), "patches"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda")}


def family_route_check(lm, steps, backward, policy_mod, pipeline, gm, cfg, batch, seq, tag):
    """The loss and every gradient leaf of one sparse step (0.8, channel
    top-k) three ways: through ``matmul``, the gather route and the mask
    oracle, fp32 with TF32 off. The same kept channels at every site (a
    routed expert's own), the same loss, every leaf within
    TRAIN_ROUTE_TOL of the others, and the kernel route's ``matmul``
    launches equal to the launch table's. An encdec or vlm batch carries
    its frames or patches (:func:`_stub_inputs`)."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device="cuda")
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(cfg.vocab, seq, batch, 0))
    b = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
    b.update(_stub_inputs(cfg, batch))
    kern = lm_policy(policy_mod)
    routes = {"matmul": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = _site_of(params, cfg)
    res, launches = {}, 0
    for name, pol in routes.items():
        before = gm.launches["matmul"]
        with backward.record_selections() as log:
            (loss, metrics), grads = steps.value_and_grad(
                lambda p, pol=pol: lm.loss_fn(cfg, p, b, pol), params)
        torch.cuda.synchronize()
        if name == "matmul":
            launches = gm.launches["matmul"] - before
        res[name] = (loss.item(), _named_leaves(grads), {site_of[p]: s.idx for p, s in log},
                     float(metrics["aux"]))
        del grads
    expect = lm.kernel_launches_per_step(cfg, kern)["matmul"]
    if launches != expect:
        raise AssertionError(f"{tag}: matmul launches {launches} != launch table {expect}")
    n_sel = sum(cfg.n_experts if s.split("/", 1)[1] in EXPERT_SITES else 1
                for s in lm.site_names(cfg)[0])
    worst, worst_leaf = {}, {}
    for a, c in (("matmul", "gather"), ("matmul", "mask"), ("gather", "mask")):
        if sorted(res[a][2], key=str) != sorted(res[c][2], key=str) or len(res[a][2]) != n_sel:
            raise AssertionError(f"{tag} {a} vs {c}: selected at {len(res[a][2])} / "
                                 f"{len(res[c][2])} sites, expected {n_sel}")
        if abs(res[a][0] - res[c][0]) > TRAIN_ROUTE_TOL * abs(res[c][0]):
            raise AssertionError(f"{tag} loss {a} {res[a][0]} != {c} {res[c][0]}")
        flips = [k for k in res[a][2] if not torch.equal(res[a][2][k], res[c][2][k])]
        bad, top, top_path = [], 0.0, ""
        for (path, ga), (_, gb) in zip(res[a][1], res[c][1], strict=True):
            n = gb.float().norm().item()
            rel = (ga.float() - gb.float()).norm().item() / n if n > 0 else ga.norm().item()
            if rel > top:
                top, top_path = rel, path
            if rel > TRAIN_ROUTE_TOL:
                bad.append(f"{path} {rel:.3e}")
        worst[f"{a}_vs_{c}"] = top
        worst_leaf[f"{a}_vs_{c}"] = top_path
        if flips or bad:
            raise AssertionError(f"{tag} {a} vs {c}: selection differs at {flips[:5]}; leaves "
                                 f"over {TRAIN_ROUTE_TOL}: {bad[:5]}")
    print(f"{tag} {cfg.name} d={cfg.d_model} depth {cfg.n_layers}, B={batch} S={seq}, fp32, one "
          f"sparse step: the same kept channels at all {n_sel} selections; loss "
          f"{res['matmul'][0]:.6f}, aux {res['matmul'][3]:.6f}; {len(res['matmul'][1])} leaves, "
          "worst relative L2 " + ", ".join(f"{k} {v:.3e} ({worst_leaf[k]})"
                                           for k, v in worst.items())
          + f" (limit {TRAIN_ROUTE_TOL}); matmul launches {launches} = the table's; "
          f"{time.perf_counter() - t0:.1f} s")
    del params
    return worst, launches


def ssm_profile(lm, steps, adam, policy_mod, pipeline, cfg):
    """Where one dense and one sparse mamba2-1.3b training step (full
    width and depth, bf16, B=4, S=512) spend their time
    (:func:`profile_step`)."""
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(cfg.vocab, SSM_SEQ, SSM_BATCH, 0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
    params = lm.init_params(cfg, 0, device="cuda")
    opt = adam.init(params)
    ocfg = adam.AdamConfig(lr=2e-4, clip_norm=1.0)
    out = {}
    for name, pol in (("dense", policy_mod.DENSE), ("sparse", lm_policy(policy_mod))):
        fn = steps.make_train_step(cfg, pol, ocfg)

        def step():
            _, _, m = fn(params, opt, batch)  # in place
            return m["loss"].item()  # waits for the step

        wall_ms, busy_ms, _ = profile_step("[ssm-profile]", name, step)
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    del params, opt
    return out


def ssm_training_phase(train, lm, steps, backward, gm, pa, policy_mod, pipeline, get_config):
    """mamba2-1.3b at full width and depth (48 layers, d 2048, d_inner
    4096, state 128, 64 SSM heads): first a route check at depth 4 in
    fp32, then the port's LM entry point for 8 epoch-bar steps (2, 3, 6,
    7 sparse) on bf16 params, B=4, S=512 (two 256-token SSD chunks, so
    the cross-chunk recurrence runs), ``paper_default(0.8)`` with
    ``--use-pallas``. Every loss finite, ``matmul`` launched the launch
    table's count x 4, ``paged_attention`` not at all."""
    cfg = get_config(SSM_ARCH)
    rcfg = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    worst, _ = family_route_check(lm, steps, backward, policy_mod, pipeline, gm, rcfg, 2,
                                  SSM_SEQ, "[ssm-route]")
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", SSM_ARCH, "--steps", "8", "--steps-per-epoch", "2", "--global-batch",
            str(SSM_BATCH), "--seq-len", str(SSM_SEQ), "--drop-rate", str(LM_RATE),
            "--granularity", "channel", "--use-pallas", "--log-every", "1", "--device", "cuda"]
    per_step = lm.kernel_launches_per_step(cfg, lm_policy(policy_mod))
    torch.cuda.reset_peak_memory_stats()
    pa_before, mm_before = pa.launches, gm.launches["matmul"]
    t0 = time.perf_counter()
    out = train.run(train.build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    launches = gm.launches["matmul"] - mm_before
    sparse = [i for i, r in enumerate(out["rates"]) if r > 0]
    if sparse != [2, 3, 6, 7]:
        raise AssertionError(f"sparse steps {sparse}, expected [2, 3, 6, 7]")
    if not all(math.isfinite(v) for v in out["history"]):
        raise AssertionError(f"non-finite loss: {out['history']}")
    if launches != per_step["matmul"] * 4 or per_step["matmul"] != 2 * 2 * cfg.n_layers:
        raise AssertionError(f"matmul launches {launches} != {per_step['matmul']} x 4")
    if pa.launches != pa_before:
        raise AssertionError("the SSM training phase launched paged_attention")
    ms = [t * 1e3 for t in out["step_times"]]
    dense_ms = _median([ms[i] for i in range(8) if i not in sparse])
    sparse_ms = _median([ms[i] for i in sparse])
    tokens = SSM_BATCH * SSM_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[ssm-train] {SSM_ARCH} full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, state {cfg.ssm_state}, {cfg.n_ssm_heads} "
          f"heads), bf16, B={SSM_BATCH} S={SSM_SEQ}: 8 steps in {wall:.2f} s; losses "
          f"{[round(v, 4) for v in out['history']]}")
    print(f"[ssm-train] step ms {[round(v, 2) for v in ms]}; dense median {dense_ms:.2f} ms "
          f"({tokens / dense_ms * 1e3:.0f} tokens/s), sparse median {sparse_ms:.2f} ms "
          f"({tokens / sparse_ms * 1e3:.0f} tokens/s); peak memory {peak:.2f} GiB; matmul "
          f"launches {launches} = {per_step['matmul']} x 4")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.optim import adam

    prof = ssm_profile(lm, steps, adam, policy_mod, pipeline, cfg)
    return launches, dict(dense_ms=dense_ms, sparse_ms=sparse_ms, peak_gib=peak,
                          route_worst=worst, profile=prof)


def _family_runs(S, cfg, params, tag, runs, reqs_kw, pa, lock_seq):
    """Each named run of ``runs`` (ServeConfig fields, drafter) through a
    fresh engine, then, given ``lock_seq``, the lock-step baseline (in
    waves when the prompts are one length, else request by request);
    returns (rid -> tokens per run, summaries, paged_attention launches of
    the paged runs)."""
    def wl():
        return S.poisson_workload(cfg, **reqs_kw)

    outs, summary, launches = {}, {}, 0
    for name, (skw, draft) in runs.items():
        pa.launches = 0
        t0 = time.perf_counter()
        eng, outs[name] = _engine_run(S, cfg, params, wl(), draft=draft, **skw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        step_ms = [t * 1e3 for t in eng.step_times]
        n = pa.launches
        summary[name] = dict(
            steps=st["compute_steps"], launches=n, swaps=st["swap_preemptions"],
            swapped_bytes=st["swapped_bytes"], spec_proposed=st["spec_proposed"],
            spec_accepted=st["spec_accepted"], tokens_per_s=st["tokens_per_s"],
            p50_ms=float(np.percentile(step_ms, 50)), p99_ms=float(np.percentile(step_ms, 99)),
            wall_s=wall,
        )
        if eng.encode_times:  # encdec: the encoder's seconds a call, at admission
            summary[name]["encoder_ms"] = [t * 1e3 for t in eng.encode_times]
        if eng.serve_cfg.paged:
            _pages_back_and_zero(eng, f"{tag} {name}")
            n_attn = sum(1 for layer in eng.slots.cache if "k" in layer)
            want = n_attn * st["compute_steps"] if eng.serve_cfg.attn_kernel else 0
            if n != want:
                raise AssertionError(f"{tag} {name}: paged_attention launches {n} != {want}")
            launches += n
        if "swap" in name and not (st["swap_preemptions"] and st["swapped_bytes"]):
            raise AssertionError(f"{tag} {name}: no swap preemption {st}")
        if skw.get("spec_k") and not st["spec_proposed"]:
            raise AssertionError(f"{tag} {name}: nothing proposed")
        del eng
        torch.cuda.empty_cache()
        print(f"{tag} {name}: " + json.dumps(summary[name]))
    if lock_seq:
        t0 = time.perf_counter()
        lock, reqs = {}, wl()
        encdec = cfg.family == "encdec"
        if len({r.prompt_len for r in reqs}) == 1:
            for wave in S.lockstep_waves(reqs, runs[next(iter(runs))][0]["max_slots"]):
                out = S.generate_lockstep(
                    cfg, params, np.stack([r.prompt for r in wave]),
                    [r.max_new_tokens for r in wave], max_seq=lock_seq,
                    frames=np.stack([r.frames for r in wave]) if encdec else None,
                    sampling=[r.sampling for r in wave])
                lock.update({r.rid: t for r, t in zip(wave, out["tokens"], strict=True)})
        else:
            lock = {r.rid: S.generate_reference(cfg, params, r.prompt, r.max_new_tokens,
                                                max_seq=lock_seq, frames=r.frames,
                                                sampling=r.sampling)
                    for r in reqs}
        outs["lockstep"] = lock
        print(f"{tag} lockstep: wall {time.perf_counter() - t0:.2f} s")
    return outs, summary, launches


def _shares(outs, ref_name):
    ref = outs[ref_name]
    gen = np.stack([ref[r] for r in sorted(ref)])
    return {name: float((np.stack([o[r] for r in sorted(ref)]) == gen).mean())
            for name, o in outs.items() if name != ref_name}


def ssm_serve_phase(lm, pa, S, get_config):
    """mamba2-1.3b serves at full width and depth: 8 sampled Poisson
    requests (prompt 128, gen 32) through 4 slots of the paged engine,
    the paged engine with a pool small enough to swap, speculating 4
    tokens self-drafted, the contiguous engine and the lock-step
    baseline, with bf16 params and an fp32 copy. The arch has no
    attention layer, so no kernel runs: the phase holds the engine's SSM
    state (reset, swap, the speculative commit) at full size. The fp32
    shares of tokens equal to the paged run's must reach SHARE_MIN."""
    cfg = get_config(SSM_ARCH)
    params = lm.init_params(cfg, 0, "cuda")
    reqs_kw = dict(n_requests=8, arrival_rate=0.5, prompt_len=128, gen_len=32, seed=0,
                   uniform_prompts=True, **SAMPLED)
    base = dict(max_slots=4, max_seq=160, prefill_chunk=32)
    paged = dict(base, block_size=16)
    runs = {
        "paged": (dict(paged), None),
        "swap": (dict(paged, n_blocks=24, preempt="swap"), None),
        "spec self": (dict(paged, spec_k=SPEC_K, decode_widths=(1, 4, SPEC_K + 1)), None),
        "contiguous": (dict(base), None),
    }
    shares, summaries = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for tag in ("bfloat16", "float32"):
        p = params if tag == "bfloat16" else _cast(params, torch.float32)
        outs, summaries[tag], n = _family_runs(S, cfg, p, f"[ssm-serve] {tag}", runs, reqs_kw,
                                               pa, base["max_seq"])
        if n:
            raise AssertionError(f"[ssm-serve] an attention-free arch launched paged_attention {n}x")
        shares[tag] = _shares(outs, "paged")
        del p
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[ssm-serve] {SSM_ARCH} (depth {cfg.n_layers}) has no attention layer: no kernel "
          "runs on this path "
          f"(paged_attention launched 0 times); tokens equal to the paged run's: "
          f"{json.dumps(shares)} (float32 limit {SHARE_MIN}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    low = {k: v for k, v in shares["float32"].items() if v < SHARE_MIN}
    if low:
        raise AssertionError(f"[ssm-serve] fp32 runs part from the paged one: {low}")
    del params
    return summaries, shares


def moe_serve_phase(lm, pa, S, get_config):
    """kimi-k2-1t-a32b at full width (384 experts, top-8, a shared expert,
    d 7168, 64/8 heads of 112, vocab 163840), depth cut from 61 to 1, bf16
    weights (the experts drawn directly in bf16): 8 requests (prompt 128,
    gen 32) through 4 slots of the paged engine on the kernel route (the
    kernel at head_dim 112) and on the gather route; MoE decode at full
    capacity. The share of tokens equal between the routes must reach
    SHARE_MIN; tokens/s, p50 and p99 step and peak memory printed."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_DEPTH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    print(f"[moe-serve] {MOE_ARCH} depth {MOE_DEPTH}: {n_params / 1e9:.2f} B params "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB bf16) built in "
          f"{time.perf_counter() - t0:.1f} s")
    reqs_kw = dict(n_requests=8, arrival_rate=0.5, prompt_len=128, gen_len=32, seed=0,
                   uniform_prompts=True)
    paged = dict(max_slots=4, max_seq=160, prefill_chunk=32, block_size=16)
    runs = {"kernel": (dict(paged), None), "gather": (dict(paged, attn_kernel=False), None)}
    outs, summary, launches = _family_runs(S, cfg, params, "[moe-serve]", runs, reqs_kw, pa, 0)
    share = _shares(outs, "kernel")["gather"]
    gen = np.stack([outs["kernel"][r] for r in sorted(outs["kernel"])])
    if gen.shape != (8, 32) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"[moe-serve] tokens {gen.shape} in {gen.min()}..{gen.max()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[moe-serve] kernel route: {summary['kernel']['tokens_per_s']:.1f} tokens/s, step "
          f"p50 {summary['kernel']['p50_ms']:.2f} ms p99 {summary['kernel']['p99_ms']:.2f} ms; "
          f"tokens equal between the kernel and gather routes {share:.4f} (limit {SHARE_MIN}); "
          f"peak memory {peak:.2f} GiB; paged_attention launches {launches} at head_dim "
          f"{cfg.head_dim}")
    if share < SHARE_MIN:
        raise AssertionError(f"[moe-serve] the routes part: share {share} < {SHARE_MIN}")
    prof = step_profile(cfg, lm, params, tag="[moe-profile]")  # as the serve phase's steps
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(summary["kernel"], share=share, peak_gib=peak,
                          gather=summary["gather"], profile=prof)


def families_reduced_phase(lm, steps, backward, policy_mod, pipeline, gm, pa, S, get_config):
    """The reduced fp32 config of each of the seven new archs on the card:
    (i) the training route check (``family_route_check``, B=2 S=24), and
    (ii) 6 requests, greedy and then sampled, through the paged engine on
    the kernel and the gather route, under swap preemption, speculating 4
    tokens with a one-period drafter (one layer; two for llama4's and
    jamba's periods), through the contiguous engine and the lock-step
    oracle: every stream identical."""
    out = {}
    for arch in NEW_ARCHS + (ENCDEC_ARCH, VLM_ARCH):
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        worst, _ = family_route_check(lm, steps, backward, policy_mod, pipeline, gm, cfg, 2, 24,
                                      "[family-route]")
        dcfg = cfg.reduced(n_layers=len(lm.transformer.period_pattern(cfg)))
        params, dparams = lm.init_params(cfg, 0, "cuda"), lm.init_params(dcfg, 1, "cuda")
        base = dict(max_slots=3, max_seq=24, prefill_chunk=8, decode_widths=(1, SPEC_K + 1))
        paged = dict(base, block_size=4)
        runs = {
            "paged kernel": (dict(paged), None),
            "paged gather": (dict(paged, attn_kernel=False), None),
            "swap": (dict(paged, n_blocks=9, preempt="swap"), None),
            "spec": (dict(paged, n_blocks=12, spec_k=SPEC_K), (dcfg, dparams)),
            "contiguous": (dict(base), None),
        }
        first = {}
        for kind, controls in (("greedy", {}), ("sampled", SAMPLED)):
            reqs_kw = dict(n_requests=6, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(8, 12),
                           seed=5, **controls)
            outs, _, _ = _family_runs(S, cfg, params, f"[family-serve] {arch} {kind}", runs,
                                      reqs_kw, pa, base["max_seq"])
            ref = outs["paged kernel"]
            for name, o in outs.items():
                for rid in ref:
                    if not (o[rid].shape == ref[rid].shape and (o[rid] == ref[rid]).all()):
                        raise AssertionError(f"[family-serve] {arch} {kind} {name} rid {rid} "
                                             f"{o[rid].tolist()} != paged kernel "
                                             f"{ref[rid].tolist()}")
            first[kind] = ref[0].tolist()
        print(f"[family-serve] {arch} reduced: {len(outs)} runs identical, greedy and sampled "
              f"(paged kernel/gather, swap, spec_k={SPEC_K} with a {dcfg.n_layers}-layer "
              f"drafter, contiguous, lock-step) in {time.perf_counter() - t0:.1f} s; first "
              f"streams {first}")
        out[arch] = worst
        del params, dparams
        gc.collect()
        torch.cuda.empty_cache()
    return out

# ----------------------------------------------------------------------
# the encoder-decoder (whisper-large-v3) and VLM (paligemma-3b) families
# ----------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "paligemma-3b"
# training batches: B, S decoder tokens (+ frames [B, 1500, 1280] / patches [B, 256, 2048])
XFAMILY_TRAIN = {ENCDEC_ARCH: (2, 128), VLM_ARCH: (8, 128)}
XFAMILY_ROUTE = (2, 32)  # B, S of the route check (full width, depth 2, fp32)
XFAMILY_STEPS = 3  # timed dense and sparse steps each, after a warm-up of each


def xfamily_serve_phase(arch, tag, lm, pa, S, get_config):
    """An encdec or vlm arch serves at full width and depth: 8 sampled
    Poisson requests (whisper: prompt 16, gen 64, each with its
    ``[1500, 1280]`` frames from the workload; paligemma: prompt 128,
    gen 32; 4 slots, 16-token pages, ``max_seq`` with room for the
    patches as the CLI's) through the paged engine on the kernel and the
    gather route, a pool small enough to swap, speculating 4 tokens
    self-drafted, the contiguous engine and the lock-step baseline, with
    bf16 params and an fp32 copy. ``paged_attention`` launched once a
    layer a target step of each kernel-route run (at the arch's head
    dim); every page back and zero; the fp32 shares of tokens equal to
    the paged kernel run's at least SHARE_MIN (bf16 printed). Whisper's
    encoder runs once an admission (twice when self-drafting): its time
    a call, as the engines record it, is printed. Returns (launches,
    summary)."""
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    print(f"{tag} {arch}: {n_params / 1e9:.3f} B params built in {time.perf_counter() - t0:.1f} s "
          f"(depth {cfg.n_layers}{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''},"
          f" d {cfg.d_model}, H={cfg.n_heads} KV={cfg.n_kv_heads} D={cfg.head_dim})")
    prompt, gen, pool = (16, 64, 12) if cfg.family == "encdec" else (128, 32, 24)
    reqs_kw = dict(n_requests=8, arrival_rate=0.5, prompt_len=prompt, gen_len=gen, seed=0,
                   uniform_prompts=True, **SAMPLED)
    base = dict(max_slots=4, max_seq=prompt + gen + cfg.n_patches, prefill_chunk=16 if
                cfg.family == "encdec" else 32)
    paged = dict(base, block_size=16)
    runs = {
        "paged kernel": (dict(paged), None),
        "paged gather": (dict(paged, attn_kernel=False), None),
        "swap": (dict(paged, n_blocks=pool, preempt="swap"), None),
        "spec self": (dict(paged, spec_k=SPEC_K, decode_widths=(1, 4, SPEC_K + 1)), None),
        "contiguous": (dict(base), None),
    }
    summaries, shares, enc, launches = {}, {}, {}, 0
    for prec in ("bfloat16", "float32"):
        p = params if prec == "bfloat16" else _cast(params, torch.float32)
        outs, summaries[prec], n = _family_runs(S, cfg, p, f"{tag} {prec}", runs, reqs_kw,
                                                pa, base["max_seq"])
        for name in ("paged kernel", "swap", "spec self"):
            if not summaries[prec][name]["launches"]:
                raise AssertionError(f"{tag} {prec} {name}: paged_attention never launched")
        launches += n
        ref = outs["paged kernel"]
        gen_tok = np.stack([ref[r] for r in sorted(ref)])
        if gen_tok.shape != (8, gen) or gen_tok.min() < 0 or gen_tok.max() >= cfg.vocab:
            raise AssertionError(f"{tag} {prec}: tokens {gen_tok.shape} in "
                                 f"{gen_tok.min()}..{gen_tok.max()}")
        shares[prec] = _shares(outs, "paged kernel")
        if cfg.family == "encdec":
            enc_ms = [t for run in summaries[prec].values() for t in run["encoder_ms"]]
            enc[prec] = dict(calls=len(enc_ms), median_ms=_median(enc_ms), max_ms=max(enc_ms))
        del p, outs
        gc.collect()
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    k = summaries["bfloat16"]["paged kernel"]
    print(f"{tag} {arch} bf16 paged kernel route: {k['tokens_per_s']:.1f} tokens/s, step p50 "
          f"{k['p50_ms']:.2f} ms p99 {k['p99_ms']:.2f} ms; paged_attention launches {launches} at "
          f"head_dim {cfg.head_dim} (H={cfg.n_heads}, KV={cfg.n_kv_heads}); peak memory "
          f"{peak:.2f} GiB" + (f"; encoder a call (1500 frames, 32 layers): {json.dumps(enc)}"
                               if enc else ""))
    print(f"{tag} tokens equal to the paged kernel run's: {json.dumps(shares)} (float32 limit "
          f"{SHARE_MIN})")
    low = {name: v for name, v in shares["float32"].items() if v < SHARE_MIN}
    if low:
        raise AssertionError(f"{tag} fp32 runs part from the paged kernel one: {low}")
    prof = step_profile(cfg, lm, params, tag=f"{tag.rstrip(']')}-profile]",
                        enc_out=_enc_rows(cfg, lm, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(k, shares=shares, encoder=enc, peak_gib=peak, profile=prof,
                          fp32=summaries["float32"]["paged kernel"])


def _enc_rows(cfg, lm, params, b=4):
    """Encoder outputs for ``b`` slots (encdec; ``None`` otherwise), from
    seeded frames, for a profiled decode step."""
    if cfg.family != "encdec":
        return None
    frames = np.random.default_rng(3).standard_normal((b, cfg.enc_seq, cfg.d_model))
    return lm.encode_frames(cfg, params, frames, "cuda")


def xfamily_training_phase(arch, tag, lm, steps, adam, backward, gm, pa, policy_mod, pipeline,
                           get_config):
    """An encdec or vlm arch trains at full width and depth through
    ``make_train_step`` (bf16 params, Adam 2e-4 with the LM CLI's clip,
    ``paper_default(0.8)`` with ``use_pallas`` at channel granularity):
    whisper B=2 S=128 with frames ``[2, 1500, 1280]``, paligemma B=8
    S=128 with patches ``[8, 256, 2048]``, both from the seed with numpy
    (the training CLI's token pipeline gives neither). A warm-up dense
    and sparse step, then XFAMILY_STEPS of each timed: every loss finite,
    ``matmul`` launched ``kernel_launches_per_step`` times a sparse step
    and never in a dense one, ``paged_attention`` not at all. First the
    route check at depth 2 in fp32 (:func:`family_route_check`)."""
    cfg = get_config(arch)
    rcfg = dataclasses.replace(cfg, n_layers=2, n_enc_layers=min(cfg.n_enc_layers, 2),
                               dtype="float32")
    worst, _ = family_route_check(lm, steps, backward, policy_mod, pipeline, gm, rcfg,
                                  *XFAMILY_ROUTE, tag.replace("-train]", "-route]"))
    gc.collect()
    torch.cuda.empty_cache()
    b, seq = XFAMILY_TRAIN[arch]
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(cfg.vocab, seq, b, 0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
    batch.update(_stub_inputs(cfg, b))
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0, device="cuda")
    opt = adam.init(params)
    ocfg = adam.AdamConfig(lr=2e-4, clip_norm=1.0)
    sparse_pol = lm_policy(policy_mod)
    per_step = lm.kernel_launches_per_step(cfg, sparse_pol)["matmul"]
    pa_before = pa.launches
    ms, losses, launches = {}, [], 0
    for name, pol in (("dense", policy_mod.DENSE), ("sparse", sparse_pol)):
        fn = steps.make_train_step(cfg, pol, ocfg)
        ms[name] = []
        for i in range(1 + XFAMILY_STEPS):
            before = gm.launches["matmul"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = fn(params, opt, batch)  # in place
            losses.append(m["loss"].item())  # waits for the step
            dt = (time.perf_counter() - t0) * 1e3
            n = gm.launches["matmul"] - before
            if n != (per_step if name == "sparse" else 0):
                raise AssertionError(f"{tag} {name} step: matmul launches {n} != "
                                     f"{per_step if name == 'sparse' else 0}")
            launches += n
            if i:
                ms[name].append(dt)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag} non-finite loss: {losses}")
    if pa.launches != pa_before:
        raise AssertionError(f"{tag} launched paged_attention")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = b * seq
    med = {k: _median(v) for k, v in ms.items()}
    stub = {ENCDEC_ARCH: f"frames [{b}, {cfg.enc_seq}, {cfg.d_model}]",
            VLM_ARCH: f"patches [{b}, {cfg.n_patches}, {cfg.d_model}]"}[arch]
    print(f"{tag} {arch} full width and depth, bf16, B={b} S={seq} + {stub}: losses "
          f"{[round(v, 4) for v in losses]}; step ms dense {[round(v, 2) for v in ms['dense']]}, "
          f"sparse {[round(v, 2) for v in ms['sparse']]}")
    print(f"{tag} dense median {med['dense']:.2f} ms ({tokens / med['dense'] * 1e3:.0f} "
          f"tokens/s), sparse median {med['sparse']:.2f} ms ({tokens / med['sparse'] * 1e3:.0f} "
          f"tokens/s); peak memory {peak:.2f} GiB; matmul launches {launches} = {per_step} "
          f"(kernel_launches_per_step) x {1 + XFAMILY_STEPS} sparse steps")
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(dense_ms=med["dense"], sparse_ms=med["sparse"], peak_gib=peak,
                          per_step=per_step, route_worst=worst)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.core import backward
    from repro_torch.core import policy as policy_mod
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch import serve as serve_pkg
    from repro_torch.launch import serve
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train
    from repro_torch.launch import train_classifier as tc
    from repro_torch.launch import train_ddpm as td
    from repro_torch.models import ddpm
    from repro_torch.models import model as lm
    from repro_torch.models import resnet
    from repro_torch.optim import adam

    t_start = time.perf_counter()

    def lap(name):  # where the script's time goes, phase by phase
        print(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s", flush=True)

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

    lap("build")
    # 3. kernel phase
    rows, v_rows, k_rows, new_dims, max_err, paged_digest = kernel_phase(pa, F)

    lap("kernel")
    # 4. gathered-kernel phase
    g_rows, g_err = gathered_phase(gm, ops, resnet, policy_mod, paged_digest)

    lap("gathered")
    # 5. route check at full width
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[route] init_params full width in {time.perf_counter() - t0:.1f} s")
    route_rel = route_check(cfg, lm, params)
    step_profile(cfg, lm, params)
    torch.cuda.empty_cache()
    reduced_streams_agree(serve)
    reduced_features_agree(lm, serve_pkg, get_config)

    lap("route")
    # 6. serve phase: the port's entry point, counted
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
    del out
    torch.cuda.empty_cache()

    lap("serve")
    # 6b. the rest of serving at full width: sampling, swap, speculation,
    # the contiguous cache and the lock-step baseline, counted
    feat_launches, feat_summary, verify_plan = serve_features_phase(
        cfg, lm, pa, ops, serve_pkg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    lap("serve-features")
    # 7. training-route check at full width
    train_rel = training_route_check(tc, resnet, backward, policy_mod, pipeline)
    torch.cuda.empty_cache()

    # 8. training phase: the port's entry point, counted; then a profile
    train_launches, train_ms = training_phase(tc, gm, pa, resnet, policy_mod)
    train_profile(tc, resnet, policy_mod, pipeline, adam)

    lap("train")
    # 9-12. ssProp generation: the DDPM UNet's kernels, routes, the entry
    # point, a profile
    gc.collect()
    torch.cuda.empty_cache()
    d_rows, d_err = ddpm_gathered_phase(gm, ops, ddpm, policy_mod)
    gc.collect()
    torch.cuda.empty_cache()
    ddpm_rel = ddpm_route_check(td, ddpm, backward, policy_mod, pipeline)
    gc.collect()
    torch.cuda.empty_cache()
    ddpm_launches, ddpm_ms = ddpm_training_phase(td, gm, pa, ddpm, policy_mod)
    ddpm_profile(td, ddpm, policy_mod, pipeline, adam)

    lap("ddpm")
    # 13-15. ssProp LM training: kernels, routes, the entry point, a profile
    gc.collect()
    torch.cuda.empty_cache()
    lm_rows, lm_err = lm_kernel_phase(gm, lm, cfg, lm_policy(policy_mod))
    lm_rel = lm_route_check(lm, lm_steps, backward, policy_mod, pipeline, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches, lm_ms = lm_training_phase(train, lm, gm, pa, policy_mod, cfg)
    lm_profile(lm, lm_steps, adam, policy_mod, pipeline, cfg)

    lap("lm-train")
    # 17-20. the decoder-only families: mamba2 trains and serves at full
    # width, kimi-k2 serves at full width (depth 1), the seven reduced
    # configs' routes and streams
    gc.collect()
    torch.cuda.empty_cache()
    ssm_launches, ssm_ms = ssm_training_phase(train, lm, lm_steps, backward, gm, pa, policy_mod,
                                              pipeline, get_config)
    gc.collect()
    torch.cuda.empty_cache()
    _, ssm_shares = ssm_serve_phase(lm, pa, serve_pkg, get_config)
    moe_launches, moe_summary = moe_serve_phase(lm, pa, serve_pkg, get_config)
    fam_rel = families_reduced_phase(lm, lm_steps, backward, policy_mod, pipeline, gm, pa,
                                     serve_pkg, get_config)

    lap("families")
    # 20-22. the encoder-decoder and VLM families at full width and depth:
    # serving (paged_attention at head dims 64 and 256), then training
    enc_launches, enc_summary = xfamily_serve_phase(ENCDEC_ARCH, "[encdec-serve]", lm, pa,
                                                    serve_pkg, get_config)
    vlm_launches, vlm_summary = xfamily_serve_phase(VLM_ARCH, "[vlm-serve]", lm, pa, serve_pkg,
                                                    get_config)
    # matmul against its plain version at every product of both archs'
    # sparse training steps (the encoder's 1500-frame rows, the cross K/V,
    # the patch prefix), bf16 and fp32
    x_rows = {arch: lm_kernel_phase(gm, lm, get_config(arch), lm_policy(policy_mod),
                                    *XFAMILY_TRAIN[arch], tag=tag)
              for arch, tag in ((ENCDEC_ARCH, "[encdec-kernels]"), (VLM_ARCH, "[vlm-kernels]"))}
    gc.collect()
    torch.cuda.empty_cache()
    xtrain = {arch: xfamily_training_phase(arch, tag, lm, lm_steps, adam, backward, gm, pa,
                                           policy_mod, pipeline, get_config)
              for arch, tag in ((ENCDEC_ARCH, "[encdec-train]"), (VLM_ARCH, "[vlm-train]"))}

    lap("encdec-vlm")
    # 23. result lines
    # the main path's decode shape: 4 slots of 160 tokens (10 pages), one
    # query row each, bf16 queries over the engine's fp32 pools
    head = next(r for r in rows if "NB=10 " in r["shape"] and "S=1 " in r["shape"]
                and r["q"] == "bfloat16" and r["pools"] == "float32")
    vrow = v_rows[0]  # a k=4 verify chunk of the main path's slots, the 16-row tile
    k_head = k_rows[0]  # kimi-k2's decode step: D=112, bf16 queries over fp32 pools
    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:94",
        launches=launches + feat_launches + moe_launches + enc_launches + vlm_launches,
        launches_by_path={"serve": launches, "serve_features": feat_launches,
                          "moe_serve": moe_launches, "encdec_serve": enc_launches,
                          "vlm_serve": vlm_launches},
        max_abs_err=max_err,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        shape=head["shape"] + " q=bfloat16 pools=float32",
        step_ms=cfg.n_layers * head["ms"],  # one engine step: a launch a layer
        route_rel_l2_fp32=route_rel["fp32"],
        verify={k: vrow[k] for k in ("shape", "variant", "splits", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        | {"plan": verify_plan.variant},
        d112={k: k_head[k] for k in ("shape", "variant", "splits", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by", "max_abs_err")},
        # whisper's and paligemma's decode (NB=10, bf16 q over fp32 pools)
        **{f"d{d}": {k: new_dims[d][0][k] for k in (
            "shape", "variant", "splits", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")} for d in (64, 256)},
    )]
    for name, replaces in GATHERED.items():
        mine = [r for r in g_rows if r["name"] == name]
        top = max(mine, key=lambda r: r["flops"])  # the ResNet path's largest shape
        d_mine = [r for r in d_rows if r["name"] == name]
        d_top = max(d_mine, key=lambda r: r["flops"])  # the DDPM path's largest shape
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, launches=train_launches[name] + ddpm_launches[name],
            launches_by_path={RESNET: train_launches[name], "ddpm": ddpm_launches[name]},
            max_abs_err=max(g_err[name], d_err[name]),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"], shape=top["shape"],
            # one sparse step's launches of this kernel, at their shapes
            step_ms=sum(r["ms"] * r["launches_per_step"] for r in mine),
            variant=top["variant"], tflops=top["tflops"],
            ddpm={k: d_top[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "tflops")}
            | {"step_ms": sum(r["ms"] * r["launches_per_step"] for r in d_mine)},
        ))
    for name, replaces in LM_KERNELS.items():
        mine = [r for r in lm_rows if r["name"] == name and r["dtype"] == "bfloat16"]
        top = max(mine, key=lambda r: (r["flops"], r["ms"]))  # the main path's largest shape
        path_launches, err, by_arch = {LM_ARCH: lm_launches[name]}, lm_err[name], {}
        if name == "matmul":
            path_launches[SSM_ARCH] = ssm_launches
            path_launches.update({arch: xtrain[arch][0] for arch in xtrain})
            err = max([err] + [e[name] for _, e in x_rows.values()])
            # whisper's and paligemma's sparse steps: the worst error, and
            # one step's launches at their shapes (bf16)
            by_arch = {arch: dict(max_abs_err=e[name], step_ms=sum(
                r["ms"] * r["launches_per_step"] for r in xr if r["dtype"] == "bfloat16"))
                for arch, (xr, e) in x_rows.items()}
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, launches=sum(path_launches.values()),
            launches_by_path=path_launches, max_abs_err=err,
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape=" ".join(filter(None, (top.get("product"), top["shape"], "bfloat16"))),
            # one sparse step's launches of this kernel (bf16, as the main path), at their shapes
            step_ms=sum(r["ms"] * r["launches_per_step"] for r in mine),
            **{k: top[k] for k in ("variant", "tflops") if k in top},
            **({"by_arch": by_arch} if by_arch else {}),
        ))
    print(f"[train] training-route rel L2 {train_rel}; step medians {train_ms}")
    print(f"[ddpm-train] route rel L2 {ddpm_rel}; step medians {ddpm_ms}")
    print(f"[lm-train] route rel L2 {lm_rel}; step medians {lm_ms}")
    print(f"[ssm-train] {json.dumps(ssm_ms)}")
    print(f"[ssm-serve] shares {json.dumps(ssm_shares)}")
    print(f"[moe-serve] {json.dumps(moe_summary)}")
    print(f"[family-route] worst relative L2 {json.dumps(fam_rel)}")
    print(f"[serve-features] {json.dumps(feat_summary)}")
    print(f"[encdec-serve] {json.dumps(enc_summary)}")
    print(f"[vlm-serve] {json.dumps(vlm_summary)}")
    print(f"[xfamily-train] {json.dumps({a: v[1] for a, v in xtrain.items()})}")
    print(f"[device] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
